"""Hex on an NxN board, embedded in an (N+1)x(N+1) bitboard with pre-filled
border stones.

The batched equivalent of reference Hex.jl (111 LoC, Julia):
* the first mover's border pre-fills column 0 rows 2..N; the second mover's
  border pre-fills row 0 cols 2..N (Hex.jl:22-33),
* action a (0-based) with x = a // n, y = a % n lands on embedded cell
  (row y+1, col x+1)  [Hex.jl:37-51's index remap, 0-based],
* ``is_over`` is the reference's bit-parallel connectivity flood: 2N-2
  iterations of ``a = down((a & (b|c)) | (b & c))`` with ``b = up(a)``,
  ``c = right(up(a))``, re-seeding part of the border each step when the
  side that just moved is the row-0 player; win iff the bottom-right corner
  bit is reached (Hex.jl:54-67).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .. import bitboard as bb
from .base import Game


class HexState(NamedTuple):
    bplayer: jnp.ndarray
    bopponent: jnp.ndarray
    player: jnp.ndarray  # int8
    lp: jnp.ndarray  # int32 - cells left counter (reference `lp`, Hex.jl:20)


class Hex(Game):
    def __init__(self, n: int = 7):
        self.n = n
        m = n + 1
        assert m * m <= 224, "board must fit the packed words"
        self.spec = bb.BoardSpec(rows=m, cols=m)
        nn = n * n
        self.name = f"hex{n}"
        self.max_actions = nn  # Hex.jl:10
        self.vectorized_state = m * m  # Hex.jl:8 - planes include the border
        self.feature_size = m * m  # Hex.jl:9
        self.max_game_length = nn  # Hex.jl:11
        # A winning chain needs n stones -> 2n - 1 plies minimum.
        self.min_game_length = 2 * n - 1

        # Border stones (Hex.jl:23-33): startx fills (rows 2..n, col 0),
        # starto fills (row 0, cols 2..n)  [0-based].
        self._startx = bb.from_coords(self.spec, [(r, 0) for r in range(2, m)])
        self._starto = bb.from_coords(self.spec, [(0, c) for c in range(2, m)])

        # Embedded cell index for each action: (row y+1, col x+1).
        acts = np.arange(nn)
        x, y = acts // n, acts % n
        self._action_cells = ((y + 1) + m * (x + 1)).astype(np.int32)

        # Flood border re-seed masks per iteration j (1-based j as in
        # Hex.jl:60-64): cells (row 0, col k) for k in 2+j .. n  [0-based].
        seeds = []
        for j in range(1, 2 * n - 1):
            seeds.append(
                bb.from_coords(self.spec, [(0, c) for c in range(2 + j, m)])
            )
        self._seeds = seeds

        self._corner_cell = m * m - 1  # (row n, col n)

    def initial(self) -> HexState:
        return HexState(
            bplayer=jnp.asarray(self._startx),
            bopponent=jnp.asarray(self._starto),
            player=jnp.int8(1),
            lp=jnp.int32(self.n * self.n),
        )

    def _action_cell(self, action):
        return jnp.take(jnp.asarray(self._action_cells), action)

    def legal_mask(self, pos: HexState) -> jnp.ndarray:
        occupied = pos.bplayer | pos.bopponent
        planes = bb.to_planes(self.spec, occupied, dtype=jnp.int32)
        return planes[jnp.asarray(self._action_cells)] == 0

    def play(self, pos: HexState, action) -> HexState:
        cell = self._action_cell(action)
        bplayer = bb.set_bit(self.spec, pos.bplayer, cell)
        return HexState(
            bplayer=pos.bopponent,
            bopponent=bplayer,
            player=(-pos.player).astype(jnp.int8),
            lp=pos.lp - 1,
        )

    def is_over(self, pos: HexState):
        spec = self.spec
        a = pos.bopponent  # stones (incl. border) of the player who just moved
        reseed = pos.player == 1  # just-moved side owns the row-0 border
        for j in range(1, 2 * self.n - 1):
            b = bb.up(spec, a)
            c = bb.right(spec, b)
            a = bb.down(spec, (a & (b | c)) | (b & c))
            seed = jnp.asarray(self._seeds[j - 1])
            a = jnp.where(reseed, a | seed, a)
        win = bb.get_bit(spec, a, self._corner_cell)
        # A hex game only ends by connection; result = previous mover
        # (Hex.jl:66 returns (corner_bit, -player)).
        return win, jnp.where(win, (-pos.player).astype(jnp.int8), jnp.int8(0))

    def encode(self, pos: HexState) -> jnp.ndarray:
        return jnp.concatenate(
            [
                bb.to_planes(self.spec, pos.bplayer),
                bb.to_planes(self.spec, pos.bopponent),
            ]
        )

    def final_feature(self, pos: HexState) -> jnp.ndarray:
        p = bb.to_planes(self.spec, pos.bplayer, dtype=jnp.int8)
        player = pos.player.astype(jnp.int8)
        return jnp.where(p != 0, player, -player)

    def render(self, pos) -> str:
        import numpy as np

        m = self.n + 1
        bp = np.asarray(bb.to_planes(self.spec, pos.bplayer, dtype=jnp.int32))
        bo = np.asarray(bb.to_planes(self.spec, pos.bopponent, dtype=jnp.int32))
        sp, so = ("X", "O") if int(pos.player) == 1 else ("O", "X")
        lines = []
        for r in range(m):
            cells = []
            for c in range(m):
                i = r + m * c
                cells.append(sp if bp[i] else so if bo[i] else ".")
            lines.append(" " * r + " ".join(cells))
        return "\n".join(lines)
