"""chip_smoke.py's contract off the card (its device gate and its result
line) and the compile-cache rule shared by the entry points."""
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from alphatpu import runtime  # noqa: E402


def test_device_gate_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.device_gate(jax.devices())
    assert "needs a GPU" in str(exc.value.code)
    with pytest.raises(SystemExit):
        chip_smoke.device_gate([])


def test_result_line_format():
    card = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    chip_smoke.device_gate([card])  # a GPU passes
    line = chip_smoke.result_line([card])
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert json.loads(chip_smoke.result_line([card] * 4))["device"][
        "count"] == 4


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_checkout", "script_alone"])
def test_script_fails_without_gpu(tmp_path, alone):
    """Run as a program on the CPU - in the checkout, or copied into an
    otherwise empty directory - it exits non-zero with no result line."""
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_rule(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    checkout's own .jax_cache/ (listed in .gitignore)."""
    before = jax.config.jax_compilation_cache_dir
    if env_dir:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    try:
        assert runtime.setup_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
