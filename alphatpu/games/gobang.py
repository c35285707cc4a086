"""Gobang / N-in-a-row on an NxN board (TicTacToe is n=3, nvict=3).

The batched equivalent of reference Gobang.jl (94 LoC, Julia):
* action a = cell index (0-based, column-major: cell (r, c) -> r + n*c),
* legal iff the cell is empty (Gobang.jl:25-27),
* win test: nvict-1 iterated shift-ANDs of the just-moved player's stones in
  4 directions (Gobang.jl:36-70),
* draw when the board is full.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .. import bitboard as bb
from .base import Game


class GobangState(NamedTuple):
    bplayer: jnp.ndarray  # uint32[nwords] - side to move
    bopponent: jnp.ndarray  # uint32[nwords]
    player: jnp.ndarray  # int8 scalar, +1 first mover
    round: jnp.ndarray  # int32 scalar


class Gobang(Game):
    def __init__(self, n: int = 3, nvict: int | None = None):
        assert n <= 13, "reference supports N<=13 (192-bit boards)"
        self.n = n
        self.nvict = nvict if nvict is not None else n
        self.spec = bb.BoardSpec(rows=n, cols=n)
        nn = n * n
        self.name = f"gobang{n}" if self.nvict != 3 or n != 3 else "tictactoe"
        self.max_actions = nn  # Gobang.jl:10
        self.vectorized_state = nn  # Gobang.jl:8
        self.feature_size = nn  # Gobang.jl:9
        self.max_game_length = nn  # Gobang.jl:11
        # First mover needs nvict stones to win -> 2*nvict - 1 plies minimum.
        self.min_game_length = 2 * self.nvict - 1

    def initial(self) -> GobangState:
        return GobangState(
            bplayer=bb.empty(self.spec),
            bopponent=bb.empty(self.spec),
            player=jnp.int8(1),
            round=jnp.int32(0),
        )

    def legal_mask(self, pos: GobangState) -> jnp.ndarray:
        occupied = pos.bplayer | pos.bopponent
        return bb.to_planes(self.spec, occupied, dtype=jnp.int32) == 0

    def play(self, pos: GobangState, action) -> GobangState:
        bplayer = bb.set_bit(self.spec, pos.bplayer, action)
        # Swap sides: the mover's stones become the new opponent board
        # (Gobang.jl:30-33).
        return GobangState(
            bplayer=pos.bopponent,
            bopponent=bplayer,
            player=(-pos.player).astype(jnp.int8),
            round=pos.round + 1,
        )

    def is_over(self, pos: GobangState):
        spec = self.spec
        board = pos.bopponent  # stones of the player who just moved
        win = jnp.zeros((), bool)
        for step in (
            lambda x: bb.right(spec, x),
            lambda x: bb.down(spec, x),
            lambda x: bb.down(spec, bb.right(spec, x)),
            lambda x: bb.left(spec, bb.down(spec, x)),
        ):
            b = board
            for _ in range(self.nvict - 1):
                b = b & step(b)
            win = win | (bb.popcount(spec, b) != 0)
        full = (
            bb.popcount(spec, pos.bplayer) + bb.popcount(spec, pos.bopponent)
            == self.n * self.n
        )
        done = win | full
        # Winner is the previous mover = -pos.player (Gobang.jl:41-43).
        result = jnp.where(win, (-pos.player).astype(jnp.int8), jnp.int8(0))
        return done, result

    def encode(self, pos: GobangState) -> jnp.ndarray:
        return jnp.concatenate(
            [
                bb.to_planes(self.spec, pos.bplayer),
                bb.to_planes(self.spec, pos.bopponent),
            ]
        )

    def final_feature(self, pos: GobangState) -> jnp.ndarray:
        p = bb.to_planes(self.spec, pos.bplayer, dtype=jnp.int8)
        player = pos.player.astype(jnp.int8)
        # +player where the side to move has a stone, -player elsewhere
        # (mcts_gpu.jl:464-474).
        return jnp.where(p != 0, player, -player)

    def render(self, pos) -> str:
        import numpy as np

        bp = np.asarray(bb.to_planes(self.spec, pos.bplayer, dtype=jnp.int32))
        bo = np.asarray(bb.to_planes(self.spec, pos.bopponent, dtype=jnp.int32))
        player = int(pos.player)
        sp, so = ("X", "O") if player == 1 else ("O", "X")
        rows = []
        for r in range(self.n):
            cells = []
            for c in range(self.n):
                i = r + self.n * c
                cells.append(sp if bp[i] else so if bo[i] else ".")
            rows.append(" ".join(cells))
        return "\n".join(rows)


def tictactoe() -> Gobang:
    return Gobang(3, 3)
