"""Smoke run of the self-play engine on NVIDIA GPUs, in one process.

    python chip_smoke.py              # one card: phases a-e below
    python chip_smoke.py --devices 4  # the four-card mesh path only

Phases on one card:
  a. device: JAX must find a GPU; prints its kind, count, the card's name
     and power limit, and the compile-cache directory.
  b. walk kernel: on trees grown by a real search at connect4 g8192 and
     hex13 g2048 (V = 64), the GPU walk kernel against ``descend`` on the
     same tree and uniforms, then one ``run_mcts`` move with each (ms).
  c. net precision: connect4 4x512 inference at batch 8192 under the
     default matmul precision against ``"highest"``.
  d. main path: ``alphatpu.cli.main`` for two generations of connect4 4x512
     at 8192 lanes x 64 rollouts, batch 8192 and a 1024-game duel, then a
     ``--resume`` for a third; then the ``gpu``-marked tests.
  e. the last line: {"ok": true, "device": {...}}.

With ``--devices 4``: one sharded ``pipeline.run_generation`` at 8192 lanes
per card, and the sharded SGD step against its single-card emulation.

Exits non-zero, and prints no result line, when JAX finds no GPU or any
phase fails.  Outputs (checkpoints, stats) go under chiprun_out/chip_smoke/.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import sys
import time

OUT_DIR = os.path.join("chiprun_out", "chip_smoke")


def device_gate(devices):
    """Exit non-zero unless JAX's devices are GPUs."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found platform {platform!r}")


def result_line(devices) -> str:
    """The script's last line of output."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def _ms(fn, *args):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) * 1e3


def phase_walk(cases=(("connect4", 8192), ("hex13", 2048)), nodes=64,
               reps=4, width=512, depth=None):
    """Phase b: kernel vs ``descend`` parity and ``run_mcts`` move time.
    Returns one result dict per case."""
    import jax
    import numpy as np

    from alphatpu.games import make_game
    from alphatpu.mcts.search import descend, run_mcts
    from alphatpu.mcts.tree import init_tree
    from alphatpu.mcts.walk_kernel import Walk, compare_walks, walk
    from alphatpu.nets import apply_inference, config_for_game, init_params
    from alphatpu.selfplay import broadcast_initial

    cpuct = 1.5
    results = []
    for name, G in cases:
        game = make_game(name)
        params = init_params(jax.random.key(0),
                             config_for_game(game, width, depth))
        tree0 = init_tree(game, broadcast_initial(game, G), nodes)

        def move_fn(reference):
            return jax.jit(lambda p, t, k: run_mcts(
                game, apply_inference, p, t, k, rollouts=nodes, cpuct=cpuct,
                training=True, reference_walk=reference))

        kernel_move, ref_move = move_fn(False), move_fn(True)
        key = jax.random.key(1)
        t0 = time.perf_counter()
        tree, _ = jax.block_until_ready(kernel_move(params, tree0, key))
        jax.block_until_ready(ref_move(params, tree0, key))
        compile_s = time.perf_counter() - t0

        # parity on the grown tree, fresh uniforms
        D = min(game.max_game_length, nodes)
        probs = jax.random.uniform(jax.random.key(2), (D, G))
        path, node, la, na, rpi = jax.jit(
            lambda t, p: descend(game, t, p, cpuct))(tree, probs)
        ref = Walk(path.nodes, path.actions, node, la, na, rpi)
        got = walk(tree.prior, tree.wsum, tree.visits, tree.parent,
                   tree.action_from, tree.expanded, probs, cpuct)
        parity = compare_walks(tree, probs, cpuct, ref, got)
        depth_max = int((np.asarray(path.nodes) >= 0).sum(0).max())

        # move time, in turns: kernel, descend, descend, kernel, ...
        times = {"kernel": [], "descend": []}
        for r in range(reps):
            order = ("kernel", "descend") if r % 2 == 0 else (
                "descend", "kernel")
            for which in order:
                fn = kernel_move if which == "kernel" else ref_move
                times[which].append(_ms(fn, params, tree0, key))
        res = {
            "game": name, "lanes": G, "nodes": nodes,
            "net": f"{config_for_game(game, width, depth).depth}x{width}",
            **parity, "walk_depth_max": depth_max,
            "kernel_ms_per_move": float(np.median(times["kernel"])),
            "descend_ms_per_move": float(np.median(times["descend"])),
            "kernel_ms_all": times["kernel"],
            "descend_ms_all": times["descend"],
            "compile_s": compile_s,
        }
        print("walk:", json.dumps(res), flush=True)
        assert parity["unexplained"] == 0, parity
        results.append(res)
    return results


def phase_precision(batch=8192, width=512, tol=1e-2):
    """Phase c: the in-search forward under the default matmul precision
    against ``"highest"``.  A float32 product may run as TF32 on the card
    (10 mantissa bits), so the default differs from the f32 reference at
    about 1e-3; ``tol`` bounds it."""
    import jax
    import jax.numpy as jnp

    from alphatpu.games import make_game
    from alphatpu.nets import apply_inference, config_for_game, init_params

    game = make_game("connect4")
    cfg = config_for_game(game, width)
    params = init_params(jax.random.key(0), cfg)
    x = jax.random.bernoulli(jax.random.key(3), 0.3,
                             (batch, cfg.in_dim)).astype(jnp.float32)

    def probs(p, x):
        logits, v = apply_inference(p, x)
        return jax.nn.softmax(logits, axis=-1), v

    pol, val = jax.jit(probs)(params, x)
    with jax.default_matmul_precision("highest"):
        pol_h, val_h = jax.jit(probs)(params, x)
    res = {
        "policy_maxdiff": float(jnp.max(jnp.abs(pol - pol_h))),
        "value_maxdiff": float(jnp.max(jnp.abs(val - val_h))),
        "batch": batch, "net": f"{cfg.depth}x{width}",
    }
    print("precision:", json.dumps(res), flush=True)
    assert bool(jnp.all(jnp.isfinite(pol)) & jnp.all(jnp.isfinite(val)))
    assert res["policy_maxdiff"] <= tol and res["value_maxdiff"] <= tol, res
    return res


class _Tee(io.StringIO):
    def __init__(self, stream):
        super().__init__()
        self.stream = stream

    def write(self, s):
        self.stream.write(s)
        return super().write(s)


def phase_main(out_dir=OUT_DIR, samples=8192, rollouts=64, rounds=84,
               batch=8192, duel_games=1024, duel_rollouts=32, extra=()):
    """Phase d: two generations and a resume through ``alphatpu.cli.main``.
    Returns the per-generation stats rows."""
    import jax

    from alphatpu import cli

    ckpt = os.path.join(out_dir, "ckpt")
    stats_file = os.path.join(out_dir, "stats.jsonl")
    shutil.rmtree(ckpt, ignore_errors=True)
    if os.path.exists(stats_file):
        os.remove(stats_file)
    argv = ["--game", "connect4", "--continuous",
            "--samples", str(samples), "--rollout", str(rollouts),
            "--rounds", str(rounds), "--batchsize", str(batch),
            "--duel-games", str(duel_games),
            "--duel-rollouts", str(duel_rollouts),
            "--ckpt-dir", ckpt, "--stats-file", stats_file, *extra]
    assert cli.main(argv + ["--generation", "2"]) == 0
    log = _Tee(sys.stdout)
    with contextlib.redirect_stdout(log):
        assert cli.main(argv + ["--resume", "--generation", "3"]) == 0
    assert "resumed at generation 2" in log.getvalue()
    for f in ("latest.json", "net1.npz", "net2.npz", "net3.npz"):
        assert os.path.exists(os.path.join(ckpt, f)), f

    with open(stats_file) as f:
        rows = [json.loads(line) for line in f]
    assert [r["generation"] for r in rows] == [1, 2, 3], rows
    for r in rows:
        w, d, l = r["duel"]
        assert r["illegal_moves"] == 0, r
        assert r["samples_written"] > 0, r
        assert math.isfinite(r["loss"]), r
        assert w + d + l + r["duel_unfinished"] == duel_games, r
        print("generation:", json.dumps({k: r[k] for k in (
            "generation", "selfplay_s", "train_s", "duel_s", "loss",
            "samples_written", "games_finished", "illegal_moves", "duel",
            "duel_unfinished")}), flush=True)
    gen_s = [r["selfplay_s"] + r["train_s"] + r["duel_s"] for r in rows]
    mem = jax.devices()[0].memory_stats() or {}
    summary = {"compile_s": gen_s[0] - gen_s[1],
               "generation_s": gen_s,
               "peak_bytes_in_use": mem.get("peak_bytes_in_use")}
    print("main:", json.dumps(summary), flush=True)
    return rows


class _Outcomes:
    """pytest plugin: counts test outcomes."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1
        elif report.when == "call":
            self.passed += 1


def phase_gpu_tests():
    """The ``gpu``-marked tests, in this process (none may skip)."""
    import pytest

    counts = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "tests"], plugins=[counts])
    print("gpu tests:", json.dumps(vars(counts)), flush=True)
    assert rc == 0 and counts.passed > 0, (rc, vars(counts))
    assert counts.failed == 0 and counts.skipped == 0, vars(counts)


def phase_mesh(num_devices=4, lanes=8192, rollouts=64, rounds=84,
               batch=8192, duel_games=1024, duel_rollouts=32, width=512,
               train_rows=8192):
    """``--devices 4``: one sharded generation of the production pipeline,
    then the sharded SGD step against its single-card emulation under
    ``"highest"`` precision."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from alphatpu.buffer import create_buffer
    from alphatpu.duel import DuelConfig
    from alphatpu.games import make_game
    from alphatpu.nets import config_for_game, init_params
    from alphatpu.parallel import (emulated_train_epoch, make_mesh,
                                   sharded_train_fn)
    from alphatpu.pipeline import PipelineConfig, init_pipeline, run_generation
    from alphatpu.selfplay import SelfplayConfig
    from alphatpu.train import TrainConfig, make_optimizer

    game = make_game("connect4")
    D = num_devices
    cfg = PipelineConfig(
        selfplay=SelfplayConfig(num_games=lanes * D, rollouts=rollouts,
                                continuous=True, rounds=rounds),
        train=TrainConfig(batch_size=batch),
        duel=DuelConfig(num_games=duel_games, rollouts=duel_rollouts),
        buffer_capacity=2_000_000 // D * D,
        generations=1, width=width, devices=D,
    )
    state = init_pipeline(game, cfg)
    t0 = time.perf_counter()
    state, stats = run_generation(game, state, cfg)
    w, d, l = stats["duel"]
    res = {k: stats[k] for k in ("selfplay_s", "train_s", "duel_s", "loss",
                                 "samples_written", "illegal_moves")}
    res.update(games=lanes * D, devices=D, wall_s=time.perf_counter() - t0)
    print("mesh generation:", json.dumps(res), flush=True)
    assert stats["illegal_moves"] == 0 and stats["samples_written"] > 0
    assert math.isfinite(stats["loss"])
    assert w + d + l + stats["duel_unfinished"] == duel_games

    # sharded SGD vs its single-card emulation, on random buffer rows
    mesh = make_mesh(D)
    tcfg = TrainConfig(batch_size=batch)
    optimizer = make_optimizer(tcfg)
    params = init_params(jax.random.key(0), config_for_game(game, width))
    opt_state = optimizer.init(params)
    n = train_rows * D
    rng = np.random.default_rng(0)
    pol = rng.random((n, game.max_actions), dtype=np.float32)
    buf = create_buffer(game, n, shards=D)._replace(
        state=jnp.asarray(rng.integers(0, 2, (n, 2 * game.vectorized_state)),
                          jnp.int8),
        policy=jnp.asarray(pol / pol.sum(-1, keepdims=True)),
        player=jnp.ones((n,), jnp.int8),
        value=jnp.asarray(rng.random(n, dtype=np.float32)),
        fstate=jnp.asarray(rng.integers(-1, 2, (n, game.feature_size)),
                           jnp.int8),
        total=jnp.full((D,), train_rows, jnp.int32),
    )
    key = jax.random.key(7)
    with jax.default_matmul_precision("highest"):
        sh_params, _, sh_loss = sharded_train_fn(
            game, tcfg, optimizer, mesh)(params, opt_state, buf, key)
        em_params, _, em_loss = emulated_train_epoch(
            params, opt_state, jax.device_put(buf, jax.devices()[0]), key,
            tcfg, optimizer, D)
    # Both sides draw the same local batches under "highest" precision, but
    # the gradient mean is summed in another order (an all-reduce across
    # cards against one card's sum) and XLA may choose other matmul
    # algorithms for the two programs, so gradients differ in their last
    # bits.  Adam's step lr * m / (sqrt(v) + eps) ignores that where
    # |grad| >> eps, but where a gradient nearly cancels to ~eps its step
    # moves by a share of lr: bound each parameter by 5% of lr per update.
    n_updates = max(train_rows * D // batch - 1, 1)
    tol = 0.05 * tcfg.lr * n_updates
    diff = {k: np.abs(np.asarray(sh_params[k]) - np.asarray(em_params[k]))
            for k in params}
    print("mesh sgd:", json.dumps({
        "param_maxdiff": {k: float(d.max()) for k, d in diff.items()},
        "params_over_1e-6": int(sum((d > 1e-6).sum() for d in diff.values())),
        "params": int(sum(d.size for d in diff.values())),
        "bound": tol, "loss": [float(sh_loss), float(em_loss)]}), flush=True)
    np.testing.assert_allclose(float(sh_loss), float(em_loss), rtol=1e-6)
    for k, d in diff.items():
        assert d.max() <= tol, (k, float(d.max()), tol)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card mesh path")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    device_gate(devices)
    from alphatpu.runtime import card_info, setup_compile_cache

    cards = card_info()
    print(f"device: {devices[0].device_kind} x{len(devices)}; "
          f"compile cache: {setup_compile_cache()}", flush=True)
    print(f"cards: {cards}", flush=True)
    if len(devices) < args.devices:
        sys.exit(f"chip_smoke: --devices {args.devices} but JAX sees "
                 f"{len(devices)}")
    used = devices[:args.devices]
    os.makedirs(OUT_DIR, exist_ok=True)

    if args.devices == 4:
        phase_mesh(num_devices=4)
    else:
        phase_walk()
        phase_precision()
        phase_main()
        phase_gpu_tests()
    print(cards)
    print(result_line(used))
    return 0


if __name__ == "__main__":
    sys.exit(main())
