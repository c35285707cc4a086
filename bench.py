"""Benchmark: selfplay throughput on the reference's headline workload shape.

Runs one continuous-selfplay generation - 64 MCTS rollouts per move, the
per-game reference net - and reports env-steps/s (game moves decided per
second, each backed by a full 64-rollout search).  Prints ONE JSON line.

The reference publishes no absolute throughput (BASELINE.md) and no H100
anchor exists yet, so ``vs_baseline`` is null.  benchmarks/matrix.py runs
this measurement over the BASELINE.json config matrix.

Env knobs: BENCH_GAME, BENCH_GAMES, BENCH_ROLLOUTS, BENCH_BF16,
BENCH_ROUNDS, BENCH_CHUNK (move rounds per jit call), BENCH_SUPERBLOCK.
"""
import json
import os
import sys
import time

os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.92")

ANCHOR = "none: no H100 anchor yet (the reference publishes no throughput)"


def measure(game_name="connect4", games=8192, rollouts=64, bf16=False,
            rounds=0, seed=0, chunk=0, superblock=0):
    """One timed continuous-selfplay generation; returns a result dict.

    Continuous mode decouples lane count from samples per generation - the
    reference's 32,768 games/generation shape is lanes x rounds here
    (benchmarks/lane_sweep.py measures the equivalence).

    ``chunk`` (BENCH_CHUNK) runs the generation as ceil(rounds / chunk)
    jit calls of ``chunk`` move rounds each, chained through the
    EpisodeCarry (bit-identical to one long call, tests/test_selfplay.py
    chained-equivalence); the calls dispatch asynchronously and run
    back-to-back on the device.

    ``superblock`` (BENCH_SUPERBLOCK, default: all lanes in one batch)
    schedules a generation as games/superblock device-sequential groups of
    ``superblock`` lanes each - same generation's work, same samples
    (each group keeps its own EpisodeCarry; the result is the sum).
    Reported in ``extra`` so the number cannot be misread as a single
    lockstep batch.
    """
    from functools import partial

    import jax
    import jax.numpy as jnp

    from alphatpu.buffer import create_buffer
    from alphatpu.games import make_game
    from alphatpu.nets import apply_inference, config_for_game, init_params
    from alphatpu.selfplay import (
        SelfplayConfig, make_carry, selfplay_continuous,
    )

    game = make_game(game_name)
    # enough rounds that every lane plays >= 2 full games at worst case
    rounds = rounds or max(168, 2 * game.max_game_length)
    chunk = chunk or rounds
    n_chunks = -(-rounds // chunk)
    sb = (superblock if superblock > 0 and games % superblock == 0
          else games)
    n_sb = games // sb
    net_apply = (
        partial(apply_inference, compute_dtype=jnp.bfloat16)
        if bf16 else apply_inference
    )

    net_cfg = config_for_game(game)
    params = init_params(jax.random.key(seed), net_cfg)
    n_params = sum(x.size for x in jax.tree.leaves(params))
    cfg = SelfplayConfig(
        num_games=sb, rollouts=rollouts, cpuct=1.5,
        continuous=True, rounds=chunk,
    )
    buf = create_buffer(game, capacity=2_000_000)

    run = jax.jit(selfplay_continuous, static_argnums=(0, 1, 5))

    def generation(key):
        """n_sb device-sequential superblocks x n_chunks chained calls =
        one rounds-long generation over all ``games`` lanes."""
        import jax.random as jrandom

        b, totals, carried = buf, None, 0
        for s in range(n_sb):
            carry = make_carry(game, sb, jrandom.fold_in(key, s))
            for _ in range(n_chunks):
                b, stats, carry = run(game, net_apply, params, b, carry.rng,
                                      cfg, carry)
                # recover the additive length sum before cross-chunk summing
                stats["length_sum"] = stats["mean_length"] * stats[
                    "games_finished"]
                sb_carried = stats.pop("carried")  # snapshot, not additive
                totals = stats if totals is None else jax.tree.map(
                    jax.numpy.add, totals, stats)
            carried = carried + sb_carried
        totals["carried"] = carried
        return totals

    # compile + warm run (excluded from timing); device_get waits for the
    # device and brings the stats to the host inside the timed region
    jax.device_get(generation(jax.random.key(seed + 1))["wins"])

    # median of 3 timed runs
    times = []
    for _rep in range(3):  # same key => identical work every rep
        t0 = time.time()
        stats = jax.device_get(generation(jax.random.key(seed + 2)))
        times.append(time.time() - t0)
    dt = sorted(times)[1]
    stats["mean_length"] = stats["length_sum"] / max(
        float(stats["games_finished"]), 1.0)

    # env-steps: every (game, move) with the game still alive got a full
    # ``rollouts``-deep decision and produced a training row.  Rows of
    # episodes still in flight at the bound ("carried") are written when
    # their episode completes next generation (selfplay.EpisodeCarry -
    # nothing is ever dropped), so the exact count of search decisions is
    # written + carried.  At the default rounds >= 2x max game length the
    # carried share is < 2%.
    env_steps = float(stats["samples_written"]) + float(stats["carried"])
    steps_per_s = env_steps / dt
    rollouts_per_s = steps_per_s * rollouts

    return {
        "metric": f"selfplay_env_steps_per_s_{game_name}_g{games}_r{rollouts}"
                  + ("_bf16" if bf16 else ""),
        "value": round(steps_per_s, 1),
        "unit": "env-steps/s",
        "vs_baseline": None,
        "anchor": ANCHOR,
        "extra": {
            "env_steps": int(env_steps),
            "samples_written": int(stats["samples_written"]),
            "carried": int(stats["carried"]),
            "wall_s": round(dt, 2),
            "rollouts_per_s": round(rollouts_per_s, 1),
            "games": games,
            "rollouts": rollouts,
            "net": f"{net_cfg.depth}x{net_cfg.width}",
            "params": n_params,
            "mean_game_length": round(float(stats["mean_length"]), 2),
            "bf16_inference": bf16,
            "rounds": rounds,
            "chunk_rounds": chunk,
            "superblock_lanes": sb,
            "superblocks": n_sb,
        },
    }


def main():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {devices[0].platform!r}")
    from alphatpu.runtime import card_info, setup_compile_cache

    setup_compile_cache()
    games = int(os.environ.get("BENCH_GAMES", 8192))
    rollouts = int(os.environ.get("BENCH_ROLLOUTS", 64))
    game_name = os.environ.get("BENCH_GAME", "connect4")
    bf16 = os.environ.get("BENCH_BF16", "") not in ("", "0")
    rounds = int(os.environ.get("BENCH_ROUNDS", 0))
    chunk = int(os.environ.get("BENCH_CHUNK", 0))
    superblock = int(os.environ.get("BENCH_SUPERBLOCK", 0))

    result = measure(game_name, games, rollouts, bf16, rounds, chunk=chunk,
                     superblock=superblock)
    result["extra"]["device"] = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "cards": card_info(),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
