"""Batched MCTS phases: select (regularized policy + descend) / expand / backup.

A batched re-design of the reference's GPU kernels.  The reference runs
one CUDA thread per game (mcts_gpu.jl:100-199); here each phase is a
*lockstep* array program over all games with active-lane masking, in the
games-minor layout of :mod:`alphatpu.mcts.tree`.

Phase structure per rollout (a restructuring of the reference's
descend/expand/backup for array programs - identical semantics):

* **select**: a READ-ONLY walk from root to leaf.  At each depth the
  regularized policy of the current node - the Newton solve that is the
  reference's stated bottleneck (README.md:81) - is computed *on the fly*
  from the gathered (prior, value-sum, visits) rows.  The reference instead
  caches a policy array per node and lazily refreshes it when a backup
  staled the node (kdescendTree!, mcts_gpu.jl:114-169).  The two are
  EXACTLY equivalent: the policy is a pure function of (prior, q, visits),
  stats only change via backup, and a fresh node (no visits) uses its raw
  prior in both schemes - so the cache never holds anything the recompute
  would not produce.  Dropping the cache removes two [A, V, G] arrays
  (policy, uptodate) from memory and from every walk.  The traversed path
  is recorded as ``[D, G]`` edge lists; the root's policy falls out of the
  depth-0 step (the reference's `copy_pol`, mcts_gpu.jl:330-339).  On a GPU
  the walk runs as one kernel (:mod:`alphatpu.mcts.walk_kernel`); the jnp
  :func:`descend` is its reference and the CPU path.
* **expand**: allocates at most one node per game (the reference allocates
  inside the walk, mcts_gpu.jl:183-191 - same ids, same order), then one
  batched legal-mask + prior write (mcts_gpu.jl:250-302).
* **backup**: walks the RECORDED path (not parent pointers) updating each
  edge's (value-sum, visits) with the parity-flipped leaf value - pure
  multiply-add masked updates, no gathers, no divisions (backUp,
  mcts_gpu.jl:306-328 stores the incremental mean; storing the sum is
  algebraically identical at ~1 ulp and divide-free).
* the rollout loop is a ``lax.scan``; the NN evaluates all G leaves in one
  in-graph batch-major forward per rollout (mcts_gpu.jl:396-439) - no host
  syncs anywhere.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .newton import cdf_sample, node_policy
from .tree import (
    Tree,
    child_lookup,
    gather_node,
    gather_stat,
    gather_states,
    node_onehot,
    scatter_node,
    scatter_stat,
    scatter_states,
)


class Path(NamedTuple):
    """Edges traversed this rollout: entry d is the edge taken at depth d
    (-1 node id = lane recorded nothing at that depth)."""

    nodes: jnp.ndarray  # i32[D, G]
    actions: jnp.ndarray  # i32[D, G]
    length: jnp.ndarray  # i32[G] - number of recorded edges


def descend(game, tree: Tree, probs, cpuct):
    """Walk every game from its root to a leaf, computing each node's
    regularized policy on the fly.  Read-only over the tree.

    ``probs``: f32[D, G] pre-drawn uniforms, indexed by depth - mirroring the
    reference's per-rollout ``CUDA.rand(maxLengthGame, L)`` draw
    (mcts_gpu.jl:397) and enabling exact-stream injection in tests.

    Returns ``(path, leaf_node, leaf_action, needs_alloc, root_pi)``:
    * ``needs_alloc`` lanes sampled an edge with no child yet - the leaf is
      the to-be-allocated node under (leaf_parent, leaf_action),
    * other lanes stopped at the existing unexpanded node ``leaf_node``,
    * ``root_pi`` [A, G] is the depth-0 policy (the root's current policy).
    """
    V = tree.num_nodes
    A = tree.num_actions
    G = tree.num_games
    max_depth = probs.shape[0]

    def cond(st):
        _, found, depth, *_ = st
        return jnp.any(~found) & (depth < max_depth)

    def body(st):
        (node, found, depth, leaf_action, needs_alloc, pnodes, pactions,
         root_pi) = st
        oh = node_onehot(V, node)  # [V, G]
        exp = gather_node(tree.expanded, oh)  # [G]
        live = ~found & exp  # lanes stepping one edge now
        pi = node_policy(
            gather_stat(tree.prior, oh),
            gather_stat(tree.wsum, oh),
            gather_stat(tree.visits, oh),
            cpuct,
        )  # [A, G]
        root_pi = jnp.where(depth == 0, pi, root_pi)
        action = cdf_sample(pi, probs[depth])  # [G]
        pnodes = pnodes.at[depth].set(jnp.where(live, node, -1))
        pactions = pactions.at[depth].set(jnp.where(live, action, 0))
        cid = child_lookup(tree.parent, tree.action_from, node, action)
        hit_missing = live & (cid == 0)
        leaf_action = jnp.where(hit_missing, action, leaf_action)
        needs_alloc = needs_alloc | hit_missing
        found = found | ~exp | hit_missing
        node = jnp.where(live & (cid > 0), cid, node)
        return (node, found, depth + 1, leaf_action, needs_alloc, pnodes,
                pactions, root_pi)

    node0 = jnp.zeros((G,), jnp.int32)
    init = (
        node0,
        jnp.zeros((G,), bool),
        jnp.int32(0),
        jnp.zeros((G,), jnp.int32),
        jnp.zeros((G,), bool),
        jnp.full((max_depth, G), -1, jnp.int32),
        jnp.zeros((max_depth, G), jnp.int32),
        jnp.zeros((A, G), jnp.float32),
    )
    (node, _, _, leaf_action, needs_alloc, pnodes, pactions, root_pi) = (
        jax.lax.while_loop(cond, body, init)
    )
    path = Path(pnodes, pactions, (pnodes >= 0).sum(0).astype(jnp.int32))
    # node is the final position: the unexpanded leaf itself, or the parent
    # of the to-be-allocated child.
    return path, node, leaf_action, needs_alloc, root_pi


def select(game, tree: Tree, probs, cpuct, reference_walk: bool = False):
    """One rollout's selection walk: returns
    ``(path, node, leaf_action, needs_alloc, root_pi)``.

    On a GPU backend the walk runs as one kernel
    (:func:`alphatpu.mcts.walk_kernel.walk`), which raises for a tree shape
    it cannot take; elsewhere, or when the caller asks for the
    ``reference_walk``, the jnp :func:`descend` runs."""
    if reference_walk or jax.default_backend() != "gpu":
        return descend(game, tree, probs, cpuct)
    from .walk_kernel import walk

    w = walk(tree.prior, tree.wsum, tree.visits, tree.parent,
             tree.action_from, tree.expanded, probs, float(cpuct))
    path = Path(w.nodes, w.actions, (w.nodes >= 0).sum(0).astype(jnp.int32))
    return path, w.node, w.leaf_action, w.needs_alloc, w.root_pi


def leaf_positions(game, tree: Tree, node, leaf_action, needs_alloc):
    """Batch-layout states the NN will evaluate: the stored state at the
    existing leaf, or play(parent_state, action) for lanes allocating a new
    child (the reference plays on-device at allocation, mcts_gpu.jl:186)."""
    oh = node_onehot(tree.num_nodes, node)
    state = gather_states(tree.states, oh)  # [G, *S]
    played = jax.vmap(game.play)(state, leaf_action)
    return jax.tree.map(
        lambda ex, pl: jnp.where(
            needs_alloc.reshape((-1,) + (1,) * (pl.ndim - 1)), pl, ex
        ),
        state,
        played,
    )


def expand(game, tree: Tree, node, leaf_action, needs_alloc, leaf_states,
           prior_nn, training: bool):
    """Allocate the new children (same ids and order as the reference's
    in-walk `newindex` counter, mcts_gpu.jl:184), then write masked,
    normalized priors at each game's leaf; at the root during training mix
    0.75 * p + 0.25 * uniform(1/A) over legal moves - the hard-coded
    exploration mix of the reference (mcts_gpu.jl:270-280; NB the CLI
    ``--noise`` flag is dead there, the 25% mix is baked in).  Terminal
    leaves keep zero priors and get expanded = False (mcts_gpu.jl:255-257).

    ``prior_nn``: [A, G].  Returns (tree, leaf, done, result, newp) where
    ``newp`` [A, G] is the prior row written at each game's leaf.
    """
    V = tree.num_nodes

    new = tree.next_idx
    slot_oh = node_onehot(V, new) & needs_alloc[None, :]
    tree = tree._replace(
        parent=scatter_node(tree.parent, slot_oh, node),
        action_from=scatter_node(tree.action_from, slot_oh, leaf_action),
        states=scatter_states(tree.states, slot_oh, leaf_states),
        next_idx=tree.next_idx + needs_alloc.astype(jnp.int32),
    )
    leaf = jnp.where(needs_alloc, new, node)

    oh = node_onehot(V, leaf)
    done, result = jax.vmap(game.is_over)(leaf_states)
    legal = jax.vmap(game.legal_mask)(leaf_states).T  # [A, G]

    p = jnp.where(legal, prior_nn, 0.0)
    norm = jnp.maximum(p.sum(0, keepdims=True), 1e-30)
    p_norm = p / norm
    if training:
        a_cnt = jnp.maximum(legal.sum(0, keepdims=True).astype(jnp.float32), 1.0)
        mixed = 0.75 * p_norm + 0.25 / a_cnt * legal
        is_root = (leaf == 0)[None, :]
        newp = jnp.where(is_root, mixed, p_norm)
    else:
        newp = p_norm
    # Terminal leaves keep their stored prior (mcts_gpu.jl:255-257) - which
    # is provably all-zero: a leaf is either freshly allocated (row zeroed
    # at reset) or a revisited terminal node whose row was never written,
    # so "keep old" needs no gather at all.
    newp = jnp.where(done[None, :], 0.0, newp)

    tree = tree._replace(
        expanded=scatter_node(tree.expanded, oh, ~done),
        prior=scatter_stat(tree.prior, oh, newp),
    )
    return tree, leaf, done, result, newp


def leaf_value_of(leaf_player, value_nn, done, result):
    """The value backed up from each leaf: the terminal result
    ``(1 + player * r) / 2`` when the game is over there, else the NN value
    (mcts_gpu.jl:312-317)."""
    return jnp.where(
        done,
        (1.0 + leaf_player.astype(jnp.float32) * result.astype(jnp.float32))
        / 2.0,
        value_nn,
    )


def backup(tree: Tree, path: Path, leaf_player, value_nn, done, result):
    """Update every edge on the recorded path: per edge value-sum +=
    parity-flipped leaf value, visits += 1 (backUp, mcts_gpu.jl:306-328).
    The edge at depth d (leaf edge = depth len-1) receives
    ``1 - flip^(len-1-d)(leaf_value)``; since all path edges are distinct
    tree edges, every update is an independent masked multiply-add."""
    V = tree.num_nodes
    A = tree.num_actions
    act_ids = jnp.arange(A)[:, None]
    leaf_value = leaf_value_of(leaf_player, value_nn, done, result)
    max_len = jnp.max(path.length)

    def cond(st):
        _, d = st
        return d < max_len

    def body(st):
        tree, d = st
        nodes = path.nodes[d]
        actions = path.actions[d]
        valid = nodes >= 0
        k = path.length - 1 - d  # flips between this edge and the leaf
        contrib = jnp.where(k % 2 == 0, 1.0 - leaf_value, leaf_value)
        oh = node_onehot(V, nodes) & valid[None, :]
        edge = (act_ids == actions[None, :])[:, None, :] & oh[None]
        hit = edge.astype(jnp.float32)
        tree = tree._replace(
            wsum=tree.wsum + hit * contrib[None, None, :],
            visits=tree.visits + hit,
        )
        return tree, d + 1

    tree, _ = jax.lax.while_loop(cond, body, (tree, jnp.int32(0)))
    return tree


def run_mcts(
    game,
    net_apply: Callable,
    params,
    tree: Tree,
    rng,
    *,
    rollouts: int,
    cpuct: float,
    training: bool,
    probs=None,
    final_root_policy: bool = False,
    reference_walk: bool = False,
):
    """One full search over all games for the current move: ``rollouts`` x
    (select -> batched NN forward -> expand -> backup) as a lax.scan (the
    reference's host rollout loop, mcts_gpu.jl:376-462, minus its five
    per-stage device syncs).

    ``probs``: optional f32[rollouts, D, G] uniform injection for tests.
    Returns (tree, root_policy [A, G]).  By default the root policy is the
    one the final rollout's selection used - computed from the stats after
    rollouts-1 backups, exactly like the reference's stored-policy extract
    (`copy_pol`, mcts_gpu.jl:330-339, 443).  NB that convention discards the
    information of the final backup; ``final_root_policy=True`` instead
    recomputes the root's regularized policy from the post-search stats (a
    free strength knob the reference's stored-policy protocol could not
    afford - the root row is node 0, a static slice).

    ``reference_walk=True`` runs the jnp :func:`descend` walk on every
    backend (the GPU walk kernel's reference; see :func:`select`).
    """
    G = tree.num_games
    depth_cap = min(game.max_game_length, tree.num_nodes)
    if probs is None:
        xs = jax.random.split(rng, rollouts)
        get_probs = lambda k: jax.random.uniform(k, (depth_cap, G))
    else:
        xs = probs
        get_probs = lambda p: p

    def body(carry, x):
        tree, _ = carry
        root_was_expanded = tree.expanded[0]  # [G]
        path, node, leaf_action, needs_alloc, root_pi = select(
            game, tree, get_probs(x), cpuct, reference_walk=reference_walk
        )
        leaf_states = leaf_positions(game, tree, node, leaf_action,
                                     needs_alloc)
        enc = jax.vmap(game.encode)(leaf_states)  # [G, in] - batch-major
        logits, v = net_apply(params, enc)
        prior = jax.nn.softmax(logits, axis=-1).T  # [A, G]
        tree, leaf, done, result, newp = expand(
            game, tree, node, leaf_action, needs_alloc, leaf_states, prior,
            training,
        )
        # When this rollout expanded the root itself (only possible on the
        # first rollout), the selection saw no policy; the stored-policy
        # reference would report the freshly written (noise-mixed) root
        # prior (mcts_gpu.jl:297-299) - matters only for rollouts == 1.
        # Lanes with an unexpanded root have leaf == root, so newp IS that
        # freshly written root row.
        root_pi = jnp.where(root_was_expanded[None, :], root_pi, newp)
        tree = backup(tree, path, leaf_states.player, v, done, result)
        return (tree, root_pi), None

    (tree, root_pi), _ = jax.lax.scan(
        body, (tree, jnp.zeros((tree.num_actions, G), jnp.float32)), xs)
    if final_root_policy:
        root_pi = node_policy(
            tree.prior[:, 0, :], tree.wsum[:, 0, :], tree.visits[:, 0, :],
            cpuct,
        )
    return tree, root_pi
