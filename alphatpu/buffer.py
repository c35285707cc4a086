"""Device-resident replay ring buffer.

A device-resident re-design of the reference's CPU ring of Sample structs
(main4IARow.jl:29-78): one dense array per field, written by masked scatters
entirely in-graph - no host round-trips during selfplay.  Slot assignment
preserves the reference's ordering (round-major, then game index) and the
back-fill protocol: `value = (1 + result * player) / 2` and
`fstate = final_state * player` are computed for every recorded move of a
finished game (main4IARow.jl:65-75).

Encoded states and final-state features are 0/1 and {-1, +1} so they are
stored as int8 (4-8x less HBM than the reference's Float32 staging).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class ReplayBuffer(NamedTuple):
    state: jnp.ndarray  # i8[cap, 2*VS]
    policy: jnp.ndarray  # f32[cap, A]
    player: jnp.ndarray  # i8[cap]
    value: jnp.ndarray  # f32[cap]
    fstate: jnp.ndarray  # i8[cap, fsize]
    cursor: jnp.ndarray  # i32[shards] - next write slot per shard
    total: jnp.ndarray  # i32[shards] - total ever written per shard

    @property
    def capacity(self) -> int:
        return self.state.shape[0]


def create_buffer(game, capacity: int, shards: int = 1) -> ReplayBuffer:
    """``shards > 1`` builds a buffer whose rows (and per-shard cursors)
    shard over a device mesh axis: every leaf has a leading axis divisible
    by ``shards``, so a plain ``P('dp')`` sharding spec applies to the whole
    pytree and each device owns an independent local ring."""
    assert capacity % shards == 0
    return ReplayBuffer(
        state=jnp.zeros((capacity, 2 * game.vectorized_state), jnp.int8),
        policy=jnp.zeros((capacity, game.max_actions), jnp.float32),
        player=jnp.zeros((capacity,), jnp.int8),
        value=jnp.zeros((capacity,), jnp.float32),
        fstate=jnp.zeros((capacity, game.feature_size), jnp.int8),
        cursor=jnp.zeros((shards,), jnp.int32),
        total=jnp.zeros((shards,), jnp.int32),
    )


def buffer_size(buffer: ReplayBuffer) -> jnp.ndarray:
    """Valid sample count in this (local) shard (reference `length_buffer`,
    main4IARow.jl:77). Inside shard_map this sees the local ring."""
    return jnp.minimum(buffer.total[0], buffer.capacity)


def global_buffer_size(buffer: ReplayBuffer) -> jnp.ndarray:
    """Host-side: valid samples across all shards."""
    shards = buffer.total.shape[0]
    per_shard_cap = buffer.capacity // shards
    return jnp.minimum(buffer.total, per_shard_cap).sum()


def write_samples(
    buffer: ReplayBuffer, state, policy, player, value, fstate, mask
) -> ReplayBuffer:
    """Append ``mask``-selected rows (flat leading axis N) to the ring in
    order.  Masked-out rows are dropped via out-of-bounds scatter."""
    cap = buffer.capacity
    cursor = buffer.cursor[0]
    offs = jnp.cumsum(mask.astype(jnp.int32)) - 1
    slot = (cursor + offs) % cap
    slot = jnp.where(mask, slot, cap)  # OOB -> dropped
    n = mask.sum().astype(jnp.int32)
    return ReplayBuffer(
        state=buffer.state.at[slot].set(state.astype(jnp.int8), mode="drop"),
        policy=buffer.policy.at[slot].set(policy, mode="drop"),
        player=buffer.player.at[slot].set(player.astype(jnp.int8), mode="drop"),
        value=buffer.value.at[slot].set(value, mode="drop"),
        fstate=buffer.fstate.at[slot].set(fstate.astype(jnp.int8), mode="drop"),
        cursor=buffer.cursor.at[0].set((cursor + n) % cap),
        total=buffer.total.at[0].add(n),
    )


def sample_batch(buffer: ReplayBuffer, key, batch_size: int):
    """Uniform-with-replacement batch over the valid region (reference
    samples `min(2e6, L)` uniformly per epoch, train.jl:58)."""
    import jax

    size = jnp.maximum(buffer_size(buffer), 1)
    idx = jax.random.randint(key, (batch_size,), 0, size)
    return (
        buffer.state[idx].astype(jnp.float32),
        buffer.policy[idx],
        buffer.value[idx],
        buffer.fstate[idx].astype(jnp.float32),
    )
