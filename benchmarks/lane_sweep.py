"""Lane-count scaling sweep for continuous selfplay (connect4, reference
net): the same number of search decisions at 1/2x, 1x, 2x and 4x the base
lane count, to find the lanes per card where env-steps/s peaks.
Continuous mode makes the lane count independent of samples/generation.

Usage: python benchmarks/lane_sweep.py [--lanes 8192] [--rollouts 64]
Prints the device first; only a GPU run is a device measurement.
"""
import argparse
import time

import jax

from alphatpu.buffer import create_buffer
from alphatpu.games import make_game
from alphatpu.nets import apply_inference, config_for_game, init_params
from alphatpu.selfplay import SelfplayConfig, selfplay_continuous


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=8192)
    ap.add_argument("--rollouts", type=int, default=64)
    args = ap.parse_args()
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}")

    game = make_game("connect4")
    params = init_params(jax.random.key(0), config_for_game(game))
    run = jax.jit(selfplay_continuous, static_argnums=(0, 1, 5))
    base = args.lanes
    for G in (base // 2, base, 2 * base, 4 * base):
        rounds = (base * 168) // G  # constant total decisions per point
        buf = create_buffer(game, capacity=2_000_000)
        cfg = SelfplayConfig(num_games=G, rollouts=args.rollouts,
                             continuous=True, rounds=rounds)
        b2, stats, _ = run(game, apply_inference, params, buf,
                           jax.random.key(1), cfg)
        _ = jax.device_get(stats["wins"])
        t0 = time.time()
        b2, stats, _ = run(game, apply_inference, params, buf,
                           jax.random.key(2), cfg)
        s = jax.device_get(stats)
        dt = time.time() - t0
        sps = int(s["samples_written"]) / dt
        print(f"G={G:6d} rounds={rounds:4d}: {dt:6.2f}s  "
              f"samples={int(s['samples_written'])}  env-steps/s={sps:,.0f}")


if __name__ == "__main__":
    main()
