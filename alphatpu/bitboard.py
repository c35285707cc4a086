"""Packed-word bitboards as pure JAX functions.

A re-design of the reference's 192-bit `bitboard{N}` type
(reference: Bitboard.jl:5-216).  Instead of a fixed 3xUInt64 tuple walked by
scalar loops, a board here is a little-endian vector of uint32 words with a
static :class:`BoardSpec` describing its geometry; every operation is a pure
``jnp`` function over the trailing word axis, so boards broadcast/vmap over
arbitrary leading batch axes (games, tree nodes, ...) and compile to plain
int32 vector code.

Bit layout matches the reference exactly: the board has ``rows x cols`` cells
stored column-major, cell ``(r, c)`` (0-based) lives at bit ``r + rows * c``
(reference: Bitboard.jl:45-57).  Directional shifts replicate the reference's
edge-masking semantics:

* ``right``/``left`` shift by a whole column (Bitboard.jl:135-144),
* ``down``/``up`` shift by one bit and clear the wrapped row
  (Bitboard.jl:146-176).

uint32 words (not uint64) because JAX disables x64 by default.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

WORD_BITS = 32
_U32 = jnp.uint32


@dataclasses.dataclass(frozen=True)
class BoardSpec:
    """Static geometry of a packed bitboard (rows x cols, column-major)."""

    rows: int
    cols: int

    @property
    def nbits(self) -> int:
        return self.rows * self.cols

    @property
    def nwords(self) -> int:
        return -(-self.nbits // WORD_BITS)

    # ---- precomputed numpy masks (static constants baked into the jaxpr) ----

    def _mask_from_bits(self, bit_predicate) -> np.ndarray:
        m = np.zeros(self.nwords, dtype=np.uint64)
        for i in range(self.nbits):
            if bit_predicate(i):
                m[i // WORD_BITS] |= np.uint64(1) << np.uint64(i % WORD_BITS)
        return m.astype(np.uint32)

    @property
    def valid_mask(self) -> np.ndarray:
        """Words with every in-range cell bit set (Bitboard.jl:33-41 `_msk`)."""
        return self._mask_from_bits(lambda i: True)

    @property
    def not_first_row_mask(self) -> np.ndarray:
        """Clears row 0 of every column - used by `down` (Bitboard.jl:146-160)."""
        return self._mask_from_bits(lambda i: i % self.rows != 0)

    @property
    def not_last_row_mask(self) -> np.ndarray:
        """Clears row rows-1 of every column - used by `up` (Bitboard.jl:162-176)."""
        return self._mask_from_bits(lambda i: i % self.rows != self.rows - 1)

    @property
    def word_index(self) -> np.ndarray:
        return np.arange(self.nbits) // WORD_BITS

    @property
    def bit_index(self) -> np.ndarray:
        return (np.arange(self.nbits) % WORD_BITS).astype(np.uint32)


def empty(spec: BoardSpec) -> jnp.ndarray:
    return jnp.zeros((spec.nwords,), dtype=_U32)


def _word(b: jnp.ndarray, w: int) -> jnp.ndarray:
    return b[..., w]


def shift_up_bits(spec: BoardSpec, b: jnp.ndarray, n: int) -> jnp.ndarray:
    """Shift every bit index up by static ``n`` (reference `<<`, Bitboard.jl:85-107)."""
    ws, bs = divmod(n, WORD_BITS)
    words = []
    for w in range(spec.nwords):
        lo = _word(b, w - ws) << bs if 0 <= w - ws < spec.nwords else None
        hi = (
            _word(b, w - ws - 1) >> (WORD_BITS - bs)
            if bs > 0 and 0 <= w - ws - 1 < spec.nwords
            else None
        )
        parts = [p for p in (lo, hi) if p is not None]
        if not parts:
            words.append(jnp.zeros_like(_word(b, 0)))
        else:
            acc = parts[0]
            for p in parts[1:]:
                acc = acc | p
            words.append(acc)
    out = jnp.stack(words, axis=-1)
    return out & jnp.asarray(spec.valid_mask)


def shift_down_bits(spec: BoardSpec, b: jnp.ndarray, n: int) -> jnp.ndarray:
    """Shift every bit index down by static ``n`` (reference `>>>`, Bitboard.jl:110-133)."""
    ws, bs = divmod(n, WORD_BITS)
    words = []
    for w in range(spec.nwords):
        lo = _word(b, w + ws) >> bs if 0 <= w + ws < spec.nwords else None
        hi = (
            _word(b, w + ws + 1) << (WORD_BITS - bs)
            if bs > 0 and 0 <= w + ws + 1 < spec.nwords
            else None
        )
        parts = [p for p in (lo, hi) if p is not None]
        if not parts:
            words.append(jnp.zeros_like(_word(b, 0)))
        else:
            acc = parts[0]
            for p in parts[1:]:
                acc = acc | p
            words.append(acc)
    out = jnp.stack(words, axis=-1)
    return out & jnp.asarray(spec.valid_mask)


def right(spec: BoardSpec, b: jnp.ndarray) -> jnp.ndarray:
    """Move every stone one column right (reference Bitboard.jl:135-138)."""
    return shift_up_bits(spec, b, spec.rows)


def left(spec: BoardSpec, b: jnp.ndarray) -> jnp.ndarray:
    """Move every stone one column left (reference Bitboard.jl:141-144)."""
    return shift_down_bits(spec, b, spec.rows)


def down(spec: BoardSpec, b: jnp.ndarray) -> jnp.ndarray:
    """Move one row down (toward higher row index), clearing wrapped row 0
    (reference Bitboard.jl:146-160)."""
    return shift_up_bits(spec, b, 1) & jnp.asarray(spec.not_first_row_mask)


def up(spec: BoardSpec, b: jnp.ndarray) -> jnp.ndarray:
    """Move one row up, clearing the wrapped last row (reference Bitboard.jl:162-176)."""
    return shift_down_bits(spec, b, 1) & jnp.asarray(spec.not_last_row_mask)


def popcount(spec: BoardSpec, b: jnp.ndarray) -> jnp.ndarray:
    """Number of set cells (reference `num_bit`, Bitboard.jl:177-180)."""
    return jax.lax.population_count(b).astype(jnp.int32).sum(axis=-1)


def invert(spec: BoardSpec, b: jnp.ndarray) -> jnp.ndarray:
    """Complement within the valid cell region (reference `~`, Bitboard.jl:182-187)."""
    return (~b) & jnp.asarray(spec.valid_mask)


def get_bit(spec: BoardSpec, b: jnp.ndarray, i: jnp.ndarray) -> jnp.ndarray:
    """Read cell ``i`` (traced scalar index ok). Returns bool."""
    i = jnp.asarray(i, jnp.int32)
    w = i // WORD_BITS
    bit = (i % WORD_BITS).astype(_U32)
    word = jnp.take(b, w, axis=-1)
    return ((word >> bit) & _U32(1)) != 0


def set_bit(spec: BoardSpec, b: jnp.ndarray, i: jnp.ndarray) -> jnp.ndarray:
    """Return a copy of ``b`` with cell ``i`` set (non-mutating, like
    reference `setindex`, Bitboard.jl:60-74)."""
    i = jnp.asarray(i, jnp.int32)
    w = i // WORD_BITS
    bit = (i % WORD_BITS).astype(_U32)
    onehot = jnp.where(
        jnp.arange(spec.nwords) == w, _U32(1) << bit, _U32(0)
    )
    return b | onehot


def cell_onehot(spec: BoardSpec, i: jnp.ndarray) -> jnp.ndarray:
    """A board with only cell ``i`` set."""
    return set_bit(spec, empty(spec), i)


def to_planes(spec: BoardSpec, b: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """Unpack to a dense 0/1 vector over cells - the one-hot NN encoding used
    by the reference `decoder` kernel (mcts_gpu.jl:202-246)."""
    widx = jnp.asarray(spec.word_index)
    bidx = jnp.asarray(spec.bit_index)
    gathered = jnp.take(b, widx, axis=-1)
    return ((gathered >> bidx) & _U32(1)).astype(dtype)


def from_planes(spec: BoardSpec, planes) -> jnp.ndarray:
    """Inverse of :func:`to_planes` (test/debug helper)."""
    planes = jnp.asarray(planes)
    bits = (planes != 0).astype(_U32) << jnp.asarray(spec.bit_index)
    out = []
    widx = spec.word_index
    for w in range(spec.nwords):
        sel = jnp.asarray(widx == w)
        out.append(jnp.where(sel, bits, _U32(0)).sum(axis=-1, dtype=_U32))
    return jnp.stack(out, axis=-1)


def from_coords(spec: BoardSpec, coords) -> np.ndarray:
    """Host-side helper: build a board word vector from (row, col) 0-based pairs."""
    m = np.zeros(spec.nwords, dtype=np.uint64)
    for r, c in coords:
        i = r + spec.rows * c
        m[i // WORD_BITS] |= np.uint64(1) << np.uint64(i % WORD_BITS)
    return m.astype(np.uint32)
