"""Config-matrix benchmark: bench.measure over the BASELINE.json configs.

One entry per headline workload config (BASELINE.json `configs`), each with
its per-game reference net, in f32 and bf16-inference variants, plus a
4x-lane Connect-4 entry that measures the lanes x rounds equivalence of the
reference's 32,768-games/generation shape.  Every row names the device it
ran on; only rows from a GPU run are device measurements.

Usage: python benchmarks/matrix.py [out.json]   (default matrix_results.json)
Env: MATRIX_GAMES (lane count, default 8192; the other lane counts scale
with it), MATRIX_ROLLOUTS (64).
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import measure  # noqa: E402

LANES = int(os.environ.get("MATRIX_GAMES", 8192))
ROLLOUTS = int(os.environ.get("MATRIX_ROLLOUTS", 64))

# (game, lanes, bf16, rounds): rounds=0 uses bench's default (>= 2 full
# games per lane); the 13x13 boards run 352 rounds (>= 2x their maximum
# game length of 169), so termination and back-fill are exercised.
CONFIGS = [
    ("tictactoe", LANES // 8, False, 0),
    ("connect4", LANES, False, 0),
    ("connect4", LANES, True, 0),
    # the reference's literal 32,768-game shape at the default LANES
    ("connect4", 4 * LANES, False, 0),
    ("hex7", LANES, False, 0),
    ("hex7", LANES, True, 0),
    ("gobang9", LANES, False, 0),
    ("gobang9", LANES, True, 0),
    ("reversi6x6", LANES, False, 0),
    ("reversi8x8", LANES, False, 0),
    ("reversi8x8", LANES, True, 0),
    ("hex13", LANES // 4, False, 352),
    ("gobang13", LANES // 4, False, 352),
]


def main():
    import jax

    out_path = sys.argv[1] if len(sys.argv) > 1 else "matrix_results.json"
    d = jax.devices()[0]
    device = {"platform": d.platform, "kind": d.device_kind,
              "count": len(jax.devices())}
    results = []
    for game, lanes, bf16, rounds in CONFIGS:
        try:
            r = measure(game, games=lanes, rollouts=ROLLOUTS, bf16=bf16,
                        rounds=rounds)
        except Exception as e:  # record the failure instead of dying
            r = {"metric": f"{game}_g{lanes}" + ("_bf16" if bf16 else ""),
                 "error": f"{type(e).__name__}: {e}"}
        r["device"] = device
        print(json.dumps(r), flush=True)
        results.append(r)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    print(f"wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
