"""Connect-4 (6x7, gravity drop, 4-in-a-row).

The batched equivalent of reference 4IARow.jl (105 LoC, Julia):
* 6 rows x 7 columns, column-major bits; stones stack from row 5 (bottom)
  toward row 0 - the reference's free-row scan (4IARow.jl:30-44) finds the
  largest prefix of empty rows, so the first stone in a column lands at the
  highest row index.  Here the landing row is computed branch-free as
  ``rows - 1 - count(stones in column)``.
* legal iff row 0 of the column is free (4IARow.jl:25-27),
* win/draw test identical to Gobang with nvict=4 (4IARow.jl:47-81).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .. import bitboard as bb
from .base import Game

HEIGHT = 6
WIDTH = 7
NVICT = 4


class Connect4State(NamedTuple):
    bplayer: jnp.ndarray
    bopponent: jnp.ndarray
    player: jnp.ndarray  # int8
    round: jnp.ndarray  # int32


class Connect4(Game):
    def __init__(self):
        self.spec = bb.BoardSpec(rows=HEIGHT, cols=WIDTH)
        self.name = "connect4"
        self.max_actions = WIDTH  # 4IARow.jl:10
        self.vectorized_state = HEIGHT * WIDTH  # 4IARow.jl:8
        self.feature_size = HEIGHT * WIDTH  # 4IARow.jl:9
        self.max_game_length = HEIGHT * WIDTH  # 4IARow.jl:11
        # Four first-mover discs + three replies -> 7 plies minimum.
        self.min_game_length = 7
        # Per-column word masks for the branch-free drop computation.
        col_masks = []
        for c in range(WIDTH):
            m = np.zeros(self.spec.nwords, dtype=np.uint64)
            for r in range(HEIGHT):
                i = r + HEIGHT * c
                m[i // 32] |= np.uint64(1) << np.uint64(i % 32)
            col_masks.append(m.astype(np.uint32))
        self._col_masks = np.stack(col_masks)  # [WIDTH, nwords]

    def initial(self) -> Connect4State:
        return Connect4State(
            bplayer=bb.empty(self.spec),
            bopponent=bb.empty(self.spec),
            player=jnp.int8(1),
            round=jnp.int32(1),  # 4IARow.jl:23 starts round at 1
        )

    def legal_mask(self, pos: Connect4State) -> jnp.ndarray:
        occupied = pos.bplayer | pos.bopponent
        planes = bb.to_planes(self.spec, occupied, dtype=jnp.int32)
        # Column c playable iff its top-fill cell, row 0, is empty
        # (4IARow.jl:25-27 checks (1, col)).
        top_cells = jnp.asarray(np.arange(WIDTH) * HEIGHT)
        return planes[top_cells] == 0

    def play(self, pos: Connect4State, action) -> Connect4State:
        occupied = pos.bplayer | pos.bopponent
        col_mask = jnp.take(jnp.asarray(self._col_masks), action, axis=0)
        count = bb.popcount(self.spec, occupied & col_mask)
        # Stones are contiguous from row HEIGHT-1 downward-filled, so the
        # landing cell is row HEIGHT-1-count (equivalent to the scan at
        # 4IARow.jl:33-41).
        cell = action * HEIGHT + (HEIGHT - 1 - count)
        bplayer = bb.set_bit(self.spec, pos.bplayer, cell)
        return Connect4State(
            bplayer=pos.bopponent,
            bopponent=bplayer,
            player=(-pos.player).astype(jnp.int8),
            round=pos.round + 1,
        )

    def is_over(self, pos: Connect4State):
        spec = self.spec
        board = pos.bopponent
        win = jnp.zeros((), bool)
        for step in (
            lambda x: bb.right(spec, x),
            lambda x: bb.down(spec, x),
            lambda x: bb.down(spec, bb.right(spec, x)),
            lambda x: bb.left(spec, bb.down(spec, x)),
        ):
            b = board
            for _ in range(NVICT - 1):
                b = b & step(b)
            win = win | (bb.popcount(spec, b) != 0)
        full = (
            bb.popcount(spec, pos.bplayer) + bb.popcount(spec, pos.bopponent)
            == HEIGHT * WIDTH
        )
        done = win | full
        result = jnp.where(win, (-pos.player).astype(jnp.int8), jnp.int8(0))
        return done, result

    def encode(self, pos: Connect4State) -> jnp.ndarray:
        return jnp.concatenate(
            [
                bb.to_planes(self.spec, pos.bplayer),
                bb.to_planes(self.spec, pos.bopponent),
            ]
        )

    def final_feature(self, pos: Connect4State) -> jnp.ndarray:
        p = bb.to_planes(self.spec, pos.bplayer, dtype=jnp.int8)
        player = pos.player.astype(jnp.int8)
        return jnp.where(p != 0, player, -player)

    def render(self, pos) -> str:
        import numpy as np

        bp = np.asarray(bb.to_planes(self.spec, pos.bplayer, dtype=jnp.int32))
        bo = np.asarray(bb.to_planes(self.spec, pos.bopponent, dtype=jnp.int32))
        sp, so = ("X", "O") if int(pos.player) == 1 else ("O", "X")
        rows = []
        for r in range(HEIGHT):
            cells = []
            for c in range(WIDTH):
                i = r + HEIGHT * c
                cells.append(sp if bp[i] else so if bo[i] else ".")
            rows.append(" ".join(cells))
        return "\n".join(rows)
