"""Multi-host smoke: the ``--multihost`` CLI path executes for real.

Spawns TWO OS processes that each call ``jax.distributed.initialize`` on a
localhost coordinator (CPU backend, 2 local devices each), build one global
4-device ``dp`` mesh and drive a full production generation - sharded
continuous selfplay, psum'd data-parallel SGD, sharded gating duel -
through the exact ``alphatpu.cli`` code path a multi-host cluster would
use (one process per host, ``--devices 0``).

This is the mechanism-level evidence for the multi-host axis (SURVEY.md
section 5 "distributed comm backend"): process bring-up, cross-process
device visibility, Gloo collective wiring and the global-mesh sharded
executors all compose.  Throughput scaling needs real hardware and is out
of scope here.
"""
import os
import subprocess
import sys

import pytest

WRAPPER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
from alphatpu.cli import main
sys.exit(main([
    "--game", "tictactoe", "--samples", "8", "--rollout", "8",
    "--generation", "1", "--batchsize", "8", "--duel-games", "8",
    "--duel-rollouts", "4", "--width", "32", "--depth", "2",
    "--continuous", "--rounds", "8", "--devices", "0", "--multihost",
    "--coordinator", "localhost:%d", "--num-processes", "2",
    "--process-id", sys.argv[1], "--no-checkpoint",
]))
"""


def test_two_process_multihost_generation(tmp_path):
    port = 17000 + os.getpid() % 2000
    script = tmp_path / "mh_cli.py"
    script.write_text(WRAPPER % port)
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for i in range(2)
    ]
    try:
        outs = [p.communicate(timeout=480)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost processes did not finish in 480s")
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
    # both controllers saw the global 4-device mesh and completed the
    # generation protocol
    for out in outs:
        assert "(dp mesh over 4)" in out
        assert "done: 1 generations" in out
    assert "PROMOTED" in outs[0] or "kept" in outs[0]
