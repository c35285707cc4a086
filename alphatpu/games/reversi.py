"""Reversi / Othello on 6x6 or 8x8 boards, with an explicit pass action.

The batched equivalent of reference Reversi6x6.jl / Reversi8x8.jl (~195 LoC
each, Julia):
* bit-parallel legal-move generation by 8-direction candidate propagation
  (Reversi6x6.jl:26-40) - the reference's data-dependent `while` loops become
  static loops of size-2 iterations (the longest possible flip line), which
  is identical once the candidate set empties,
* flip computation per direction with end-cap validation
  (Reversi6x6.jl:44-70),
* the position caches its legal-move bitboard (Reversi6x6.jl:73-78),
* pass action at index size*size (0-based; reference 1-based 37/65), legal
  iff no placing move exists (Reversi6x6.jl:84-90),
* terminal when neither side can move; winner by disc count from the
  side-to-move's perspective (Reversi6x6.jl:109-130, Reversi8x8.jl:109-131).

Initial position (0-based (row, col), reference Reversi6x6.jl:10-14 /
Reversi8x8.jl:10-14): for size s with h = s//2: bplayer starts with
{(h, h-1), (h-1, h)}, bopponent with {(h-1, h-1), (h, h)}.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .. import bitboard as bb
from .base import Game


class ReversiState(NamedTuple):
    bplayer: jnp.ndarray
    bopponent: jnp.ndarray
    legal: jnp.ndarray  # cached legal-move bitboard for the side to move
    player: jnp.ndarray  # int8


class Reversi(Game):
    def __init__(self, size: int = 8):
        assert size in (6, 8)
        self.size = size
        self.spec = bb.BoardSpec(rows=size, cols=size)
        cells = size * size
        self.name = f"reversi{size}x{size}"
        self.max_actions = cells + 1  # pass action last (Reversi6x6.jl:8)
        self.vectorized_state = cells
        self.feature_size = cells
        # Reference: 50 for 6x6 (Reversi6x6.jl:9), 70 for 8x8 (Reversi8x8.jl:8)
        self.max_game_length = 50 if size == 6 else 70
        # Conservative floor (shortest known 8x8 wipe-out is 9 plies).
        self.min_game_length = 5

        h = size // 2
        self._start_mover = bb.from_coords(self.spec, [(h, h - 1), (h - 1, h)])
        self._start_other = bb.from_coords(self.spec, [(h - 1, h - 1), (h, h)])

    # ---- directions (Reversi6x6.jl:17-23) ----
    def _dirs(self):
        spec = self.spec
        return (
            lambda x: bb.up(spec, x),
            lambda x: bb.down(spec, x),
            lambda x: bb.left(spec, x),
            lambda x: bb.right(spec, x),
            lambda x: bb.up(spec, bb.left(spec, x)),  # diaghg
            lambda x: bb.down(spec, bb.left(spec, x)),  # diagbg
            lambda x: bb.up(spec, bb.right(spec, x)),  # diaghd
            lambda x: bb.down(spec, bb.right(spec, x)),  # diagbd
        )

    def _legal_play_dir(self, me, adv, d):
        """Reference `legal_play` (Reversi6x6.jl:26-35) with a static loop."""
        spec = self.spec
        emptyc = bb.invert(spec, me) & bb.invert(spec, adv)
        moves = bb.empty(spec)
        cand = d(me) & adv
        for _ in range(self.size - 2):
            moves = moves | (emptyc & d(cand))
            cand = adv & d(cand)
        moves = moves | (emptyc & d(cand))
        return moves

    def legal_board(self, me, adv) -> jnp.ndarray:
        """Bitboard of placing moves for `me` (Reversi6x6.jl:37-40)."""
        out = bb.empty(self.spec)
        for d in self._dirs():
            out = out | self._legal_play_dir(me, adv, d)
        return out

    def _flip_dir(self, me, adv, played, d):
        """Reference `flippar` (Reversi6x6.jl:44-56) with a static loop."""
        spec = self.spec
        cand = d(played) & adv
        toflip = cand
        for _ in range(self.size - 2):
            cand = adv & d(cand)
            toflip = toflip | cand
        capped = bb.popcount(spec, d(toflip) & me) != 0
        return jnp.where(capped, toflip, bb.empty(spec))

    def flip_board(self, me, adv, action) -> jnp.ndarray:
        played = bb.cell_onehot(self.spec, action)
        out = bb.empty(self.spec)
        for d in self._dirs():
            out = out | self._flip_dir(me, adv, played, d)
        return out

    # ---- game contract ----
    def initial(self) -> ReversiState:
        mover = jnp.asarray(self._start_mover)
        other = jnp.asarray(self._start_other)
        return ReversiState(
            bplayer=mover,
            bopponent=other,
            legal=self.legal_board(mover, other),
            player=jnp.int8(1),
        )

    def legal_mask(self, pos: ReversiState) -> jnp.ndarray:
        planes = bb.to_planes(self.spec, pos.legal, dtype=jnp.int32) != 0
        can_pass = bb.popcount(self.spec, pos.legal) == 0
        return jnp.concatenate([planes, can_pass[None]])

    def play(self, pos: ReversiState, action) -> ReversiState:
        spec = self.spec
        cells = self.size * self.size
        is_pass = action >= cells
        safe_action = jnp.where(is_pass, 0, action)
        h = self.flip_board(pos.bplayer, pos.bopponent, safe_action)
        h = jnp.where(is_pass, bb.empty(spec), h)
        placed = jnp.where(
            is_pass, bb.empty(spec), bb.cell_onehot(spec, safe_action)
        )
        me = (pos.bplayer ^ h) | placed
        adv = pos.bopponent ^ h
        moves = self.legal_board(adv, me)
        return ReversiState(
            bplayer=adv,
            bopponent=me,
            legal=moves,
            player=(-pos.player).astype(jnp.int8),
        )

    def is_over(self, pos: ReversiState):
        spec = self.spec
        opp_moves = self.legal_board(pos.bopponent, pos.bplayer)
        done = (bb.popcount(spec, pos.legal) == 0) & (
            bb.popcount(spec, opp_moves) == 0
        )
        diff = bb.popcount(spec, pos.bplayer) - bb.popcount(spec, pos.bopponent)
        result = (jnp.sign(diff).astype(jnp.int8) * pos.player).astype(jnp.int8)
        return done, jnp.where(done, result, jnp.int8(0))

    def encode(self, pos: ReversiState) -> jnp.ndarray:
        return jnp.concatenate(
            [
                bb.to_planes(self.spec, pos.bplayer),
                bb.to_planes(self.spec, pos.bopponent),
            ]
        )

    def final_feature(self, pos: ReversiState) -> jnp.ndarray:
        p = bb.to_planes(self.spec, pos.bplayer, dtype=jnp.int8)
        player = pos.player.astype(jnp.int8)
        return jnp.where(p != 0, player, -player)

    def render(self, pos) -> str:
        import numpy as np

        s = self.size
        bp = np.asarray(bb.to_planes(self.spec, pos.bplayer, dtype=jnp.int32))
        bo = np.asarray(bb.to_planes(self.spec, pos.bopponent, dtype=jnp.int32))
        sp, so = ("X", "O") if int(pos.player) == 1 else ("O", "X")
        rows = []
        for r in range(s):
            cells = []
            for c in range(s):
                i = r + s * c
                cells.append(sp if bp[i] else so if bo[i] else ".")
            rows.append(" ".join(cells))
        return "\n".join(rows)
