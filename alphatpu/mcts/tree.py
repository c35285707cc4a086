"""Array-resident MCTS tree storage (struct-of-arrays, games-minor layout).

A re-design of the reference's per-batch node pools (mcts_gpu.jl:35-51):
every field is a dense device array with the *games axis minor*, so every
per-node select/update is a fused masked vector op over all games and
neighbouring games sit next to each other in memory.  Per-node scalars are
``[V, G]`` (V = node capacity = rollouts per move); per-edge stats are
``[A, V, G]`` (A = actions) - action-major so that the regularized-policy
solve reduces over the *leading* axis with no transposes.  The NN boundary
stays batch-major ``[G, features]``.

Per-node game states are stored "transposed": a state leaf of single-game
shape S lives as ``[V] + S + [G]``, games minor like the stats.
:func:`gather_states` / state scatters move the G axis back to the front
for the vmapped game functions.

Differences from the reference layout, by design:
* ``childID [V, V, G]`` + ``Achild`` + ``childnbr`` (the O(V^2) indirection,
  mcts_gpu.jl:38) are not stored AT ALL: every edge is allocated at most
  once, so the child under (node, action) is derivable from the per-node
  ``parent`` + ``action_from`` scalars the tree already keeps -
  :func:`child_lookup` is a [V, G] match-and-reduce.  Dropping the
  explicit child table removes an entire [A, V, G] array from memory,
  from select's per-rollout read and from expand's per-rollout
  full-array rewrite (0 = no child; the root is node 0, never a child),
* node ids are 0-based; a null parent is -1,
* all selects/updates are one-hot masked ops, never serialized scatters.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp


class Tree(NamedTuple):
    parent: jnp.ndarray  # i32[V, G], -1 = none
    action_from: jnp.ndarray  # i32[V, G]
    expanded: jnp.ndarray  # bool[V, G]
    states: Any  # game-state pytree, leaves [V, *S, G]
    prior: jnp.ndarray  # f32[A, V, G]
    wsum: jnp.ndarray  # f32[A, V, G] - per-edge backed-up value sum
    visits: jnp.ndarray  # f32[A, V, G]
    next_idx: jnp.ndarray  # i32[G] - next free node slot

    @property
    def num_games(self) -> int:
        return self.parent.shape[-1]

    @property
    def num_nodes(self) -> int:
        return self.parent.shape[0]

    @property
    def num_actions(self) -> int:
        return self.prior.shape[0]

    @property
    def q(self) -> jnp.ndarray:
        """Per-edge mean value (the reference stores this incrementally,
        mcts_gpu.jl:319; storing the sum makes backup divide-free)."""
        v = self.visits
        return jnp.where(v > 0, self.wsum / jnp.maximum(v, 1.0), 0.0)


def _to_tree_layout(batched_leaf):
    """[G, *S] -> [*S, G]."""
    return jnp.moveaxis(batched_leaf, 0, -1)


def _to_batch_layout(tree_leaf):
    """[*S, G] -> [G, *S]."""
    return jnp.moveaxis(tree_leaf, -1, 0)


def node_onehot(num_nodes: int, node: jnp.ndarray) -> jnp.ndarray:
    """bool[V, G] selecting each game's node."""
    return jnp.arange(num_nodes)[:, None] == node[None, :]


def init_tree(game, positions, num_nodes: int) -> Tree:
    """Allocate a tree pool with ``positions`` (a batched state pytree with
    leading axis [G]) installed as the roots (reference `init`/`create_roots`,
    mcts_gpu.jl:42-53, 342-357)."""
    G = positions.player.shape[0]
    V = num_nodes
    A = game.max_actions

    def alloc_state(leaf):
        t = _to_tree_layout(leaf)  # [*S, G]
        out = jnp.zeros((V,) + t.shape, t.dtype)
        return out.at[0].set(t)

    return Tree(
        parent=jnp.full((V, G), -1, jnp.int32),
        action_from=jnp.zeros((V, G), jnp.int32),
        expanded=jnp.zeros((V, G), bool),
        states=jax.tree.map(alloc_state, positions),
        prior=jnp.zeros((A, V, G), jnp.float32),
        wsum=jnp.zeros((A, V, G), jnp.float32),
        visits=jnp.zeros((A, V, G), jnp.float32),
        next_idx=jnp.ones((G,), jnp.int32),
    )


def reset_tree(tree: Tree, positions) -> Tree:
    """Recycle the pool for the next move: zero all stats, install the new
    roots, mark everything unexpanded/up-to-date (reference `re_init` +
    the stat zeroing at the top of `mcts_single`, mcts_gpu.jl:368-373,
    380-387)."""

    def reset_state(leaf, pos_leaf):
        return jnp.zeros_like(leaf).at[0].set(_to_tree_layout(pos_leaf))

    return Tree(
        parent=jnp.full_like(tree.parent, -1),
        action_from=jnp.zeros_like(tree.action_from),
        expanded=jnp.zeros_like(tree.expanded),
        states=jax.tree.map(reset_state, tree.states, positions),
        prior=jnp.zeros_like(tree.prior),
        wsum=jnp.zeros_like(tree.wsum),
        visits=jnp.zeros_like(tree.visits),
        next_idx=jnp.ones_like(tree.next_idx),
    )


def child_lookup(parent, action_from, node, action):
    """i32[G] id of each game's child under (node, action), 0 = none.

    Every edge is allocated at most once (select only flags ``needs_alloc``
    when no child exists, expand allocates exactly that edge), so at most
    one node v satisfies ``parent[v] == node and action_from[v] == action``
    per game; unallocated slots hold parent -1 and never match.  This
    replaces the reference's stored childID indirection (mcts_gpu.jl:38)
    with a [V, G] match - no [A, V, G] child table exists at all."""
    V = parent.shape[0]
    match = (parent == node[None, :]) & (action_from == action[None, :])
    return jnp.sum(
        jnp.where(match, jnp.arange(V, dtype=jnp.int32)[:, None], 0), axis=0
    )


# ---- one-hot gather/select over the node axis (games stay in lanes) ----


def _expand_mask(onehot: jnp.ndarray, leaf_ndim: int) -> jnp.ndarray:
    """[V, G] -> [V, 1...1, G] broadcastable against a [V, *S, G] leaf."""
    V, G = onehot.shape
    return onehot.reshape((V,) + (1,) * (leaf_ndim - 2) + (G,))


def gather_node(arr: jnp.ndarray, onehot: jnp.ndarray) -> jnp.ndarray:
    """arr [V, *S, G] (node axis leading) selected per game by onehot
    [V, G] -> [*S, G]."""
    mask = _expand_mask(onehot, arr.ndim)
    if arr.dtype == jnp.bool_:
        return (arr & mask).any(axis=0)
    return jnp.where(mask, arr, 0).sum(axis=0, dtype=arr.dtype)


def gather_stat(arr: jnp.ndarray, onehot: jnp.ndarray) -> jnp.ndarray:
    """arr [A, V, G] (node axis second) selected per game -> [A, G]."""
    if arr.dtype == jnp.bool_:
        return (arr & onehot[None]).any(axis=1)
    return jnp.where(onehot[None], arr, 0).sum(axis=1, dtype=arr.dtype)


def gather_states(states, onehot: jnp.ndarray):
    """Tree states at each game's selected node, in batch layout [G, *S]."""
    return jax.tree.map(
        lambda leaf: _to_batch_layout(gather_node(leaf, onehot)), states
    )


def scatter_node(arr, onehot, val, mask=None):
    """arr [V, *S, G] <- val [*S, G] at each game's one-hot node; ``mask``
    [G] optionally gates which games write."""
    sel = _expand_mask(onehot, arr.ndim)
    if mask is not None:
        sel = sel & mask[None]
    return jnp.where(sel, val[None], arr)


def scatter_stat(arr, onehot, val):
    """arr [A, V, G] <- val [A, G] at each game's one-hot node."""
    return jnp.where(onehot[None], val[:, None, :], arr)


def scatter_states(states, onehot, new_states, mask=None):
    """Write batch-layout states [G, *S] into the tree at one-hot slots."""
    return jax.tree.map(
        lambda leaf, new: scatter_node(
            leaf, onehot, _to_tree_layout(new), mask
        ),
        states,
        new_states,
    )
