"""bench.measure smoke: the benchmark path must produce a well-formed
result dict at tiny shapes on any backend; bench.main refuses to report a
number without a GPU."""
import sys
import os

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from bench import measure  # noqa: E402


def test_measure_smoke():
    r = measure("tictactoe", games=128, rollouts=8, rounds=12)
    assert r["unit"] == "env-steps/s"
    assert r["value"] > 0
    assert r["vs_baseline"] is None and "no H100 anchor" in r["anchor"]
    ex = r["extra"]
    assert abs(ex["rollouts_per_s"] - r["value"] * 8) < 8  # rounded fields
    assert ex["params"] > 0 and ex["net"] == "6x128"
    assert 0 < ex["mean_game_length"] <= 9


def test_measure_chunked_same_counts():
    """Chunked execution (bounded single-execution length) plays the same
    games: sample counts and mean length match the single-call run exactly
    (the carry-chained equivalence, tests/test_selfplay.py, as seen through
    the bench path)."""
    single = measure("tictactoe", games=128, rollouts=8, rounds=12)
    chunked = measure("tictactoe", games=128, rollouts=8, rounds=12, chunk=4)
    assert chunked["extra"]["chunk_rounds"] == 4
    assert (chunked["extra"]["mean_game_length"]
            == single["extra"]["mean_game_length"])
    # identical seeds + chained carry => identical env-step totals
    assert chunked["extra"]["env_steps"] == single["extra"]["env_steps"]


def test_main_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert "needs a GPU" in str(exc.value.code)
