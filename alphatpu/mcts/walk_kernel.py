"""The MCTS selection walk as one GPU kernel (Pallas, Triton route).

Same contract as :func:`alphatpu.mcts.search.descend`, which stays the
plain reference and the CPU path.  ``descend`` is a ``while_loop`` over
depth whose every step reads all V rows of the three ``[A, V, G]`` stat
planes through one-hot reduces (3*A*V*G values per step).  Here one
program owns a power-of-two block of lanes (games) and loops over depth
on the device with a per-lane done mask; per depth step each lane gathers
only its current node's A-row of prior / value-sum / visits (3*A values),
runs the Newton solve and the CDF walk on that row, and finds the child by
matching its ``[V]`` parent / action_from column.  This is the shape of
the reference's one-thread-per-game ``kdescendTree!`` (mcts_gpu.jl:100-199),
which fuses the same walk and Newton solve into one CUDA kernel.

The policy math is not re-implemented: the kernel calls
:func:`~alphatpu.mcts.newton.node_policy` and
:func:`~alphatpu.mcts.newton.cdf_sample` on ``[Ap, Gb]`` tiles (A padded to
a power of two with zero rows, which change no result).  Sums are taken
in another order than XLA's, so the kernel and ``descend`` agree to float
rounding: root policies within 1e-5, and identical paths except where a
drawn uniform lies on a prefix-sum boundary (:func:`compare_walks` counts
those ties).

Nothing carries between programs; lanes past G (the last block's padding)
are masked out of every load and store, so no input is padded or copied.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .newton import (ALPHA_FLOOR, NEWTON_CHUNK, NEWTON_MAX_CHUNKS, NEWTON_TOL,
                     cdf_sample, node_policy)

# Largest [rows, lanes] tile one program holds: rows is A or V padded to a
# power of two.  1024 f32 values over 2 warps keep each tile at 16
# registers per thread.  Chosen on an H100 (400 W limit) from a sweep of
# 1-8 warps and 4-128 lanes: the walk alone took 0.26 ms at connect4
# g8192 (16 lanes) and 1.2 ms at hex13 g2048 (4 lanes), within noise of
# the best point of each; tiles of 8192+ values took minutes to compile
# and ran up to 50x slower.
TILE = 1024
NUM_WARPS = 2


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def block_lanes(num_actions: int, num_nodes: int) -> int:
    """Lanes per program: the widest power of two whose ``[A, lanes]``
    and ``[V, lanes]`` tiles (A and V padded to powers of two) fit TILE,
    capped at 32 so that a few thousand lanes still make hundreds of
    programs for the card's 132 SMs."""
    rows = max(_pow2(num_actions), _pow2(num_nodes))
    return max(1, min(32, TILE // rows))


def check_supported(num_actions: int, num_nodes: int, num_games: int):
    """Raise ValueError for a tree shape the kernel cannot take."""
    rows = max(_pow2(num_actions), _pow2(num_nodes))
    if rows > TILE:
        raise ValueError(
            f"walk kernel: A={num_actions}, V={num_nodes} pad to {rows} rows,"
            f" more than one program's tile of {TILE}")
    if num_actions * num_nodes * num_games >= 2**31:
        raise ValueError(
            f"walk kernel: A*V*G = {num_actions * num_nodes * num_games} "
            "overflows its int32 offsets")


class Walk(NamedTuple):
    """A selection walk's result, as ``descend`` returns it (path split
    into its node and action rows)."""

    nodes: jnp.ndarray  # i32[D, G], -1 = nothing recorded at that depth
    actions: jnp.ndarray  # i32[D, G]
    node: jnp.ndarray  # i32[G]
    leaf_action: jnp.ndarray  # i32[G]
    needs_alloc: jnp.ndarray  # bool[G]
    root_pi: jnp.ndarray  # f32[A, G]


def _walk_kernel(prior_ref, wsum_ref, visits_ref, parent_ref, af_ref,
                 exp_ref, probs_ref,
                 nodes_ref, actions_ref, leaf_ref, laction_ref, alloc_ref,
                 rootpi_ref, *, cpuct, A, V, G, D, Gb):
    """One program: the walk of lanes [pid*Gb, pid*Gb + Gb).  Every ref is
    a flat view of its [rows, G] (or [A, V, G]) array."""
    Ap, Vp = _pow2(A), _pow2(V)
    lane = pl.program_id(0) * Gb + jnp.arange(Gb, dtype=jnp.int32)
    lane_ok = lane < G
    aio = jnp.arange(Ap, dtype=jnp.int32)[:, None]
    a_ok = (aio < A) & lane_ok[None, :]
    vio = jnp.arange(Vp, dtype=jnp.int32)[:, None]
    v_ok = (vio < V) & lane_ok[None, :]
    col = vio * G + lane[None, :]  # [Vp, Gb] offsets of the lanes' columns

    def row(ref, d):
        return ref.at[d * G + lane]

    def init_rows(d, c):
        plgpu.store(row(nodes_ref, d), jnp.full((Gb,), -1, jnp.int32),
                    mask=lane_ok)
        plgpu.store(row(actions_ref, d), jnp.zeros((Gb,), jnp.int32),
                    mask=lane_ok)
        return c

    jax.lax.fori_loop(0, D, init_rows, 0)

    def cond(st):
        d, _, found, _, _ = st
        return (d < D) & (jnp.min(found) == 0)

    def body(st):
        d, node, found, leaf_action, needs_alloc = st
        off = (aio * V + node[None, :]) * G + lane[None, :]  # [Ap, Gb]
        P = plgpu.load(prior_ref.at[off], mask=a_ok, other=0.0)
        W = plgpu.load(wsum_ref.at[off], mask=a_ok, other=0.0)
        N = plgpu.load(visits_ref.at[off], mask=a_ok, other=0.0)
        exp = plgpu.load(exp_ref.at[node * G + lane], mask=lane_ok,
                         other=0).astype(jnp.int32)
        live = (1 - found) * exp  # lanes stepping one edge now

        pi = node_policy(P, W, N, cpuct)  # [Ap, Gb]

        @pl.when(d == 0)
        def _():
            plgpu.store(rootpi_ref.at[aio * G + lane[None, :]], pi, mask=a_ok)

        prob = plgpu.load(row(probs_ref, d), mask=lane_ok, other=0.0)
        action = cdf_sample(pi, prob)  # [Gb]
        plgpu.store(row(nodes_ref, d), jnp.where(live > 0, node, -1),
                    mask=lane_ok)
        plgpu.store(row(actions_ref, d), jnp.where(live > 0, action, 0),
                    mask=lane_ok)

        # the child under (node, action): tree.child_lookup on this
        # block's [V] columns
        parent = plgpu.load(parent_ref.at[col], mask=v_ok, other=-1)
        action_from = plgpu.load(af_ref.at[col], mask=v_ok, other=-1)
        match = (parent == node[None, :]) & (action_from == action[None, :])
        cid = jnp.sum(jnp.where(match, vio, 0), axis=0)
        hit_missing = live * (cid == 0).astype(jnp.int32)
        leaf_action = jnp.where(hit_missing > 0, action, leaf_action)
        needs_alloc = jnp.maximum(needs_alloc, hit_missing)
        found = jnp.maximum(found, jnp.maximum(1 - exp, hit_missing))
        node = jnp.where((live > 0) & (cid > 0), cid, node)
        return d + 1, node, found, leaf_action, needs_alloc

    zeros = jnp.zeros((Gb,), jnp.int32)
    _, node, _, leaf_action, needs_alloc = jax.lax.while_loop(
        cond, body, (jnp.int32(0), zeros, zeros, zeros, zeros))
    plgpu.store(leaf_ref.at[lane], node, mask=lane_ok)
    plgpu.store(laction_ref.at[lane], leaf_action, mask=lane_ok)
    plgpu.store(alloc_ref.at[lane], needs_alloc, mask=lane_ok)


@functools.partial(jax.jit, static_argnames=("cpuct", "interpret"))
def walk(prior, wsum, visits, parent, action_from, expanded, probs,
         cpuct: float, interpret: bool = False) -> Walk:
    """The selection walk of every game over the tree's stat planes
    (``[A, V, G]``), parent / action_from / expanded (``[V, G]``) and the
    pre-drawn uniforms ``probs`` (f32[D, G]).

    ``interpret=True`` runs the kernel in the Pallas interpreter on any
    backend (the CPU tests)."""
    A, V, G = prior.shape
    D = probs.shape[0]
    check_supported(A, V, G)
    Gb = block_lanes(A, V)
    kernel = functools.partial(_walk_kernel, cpuct=cpuct, A=A, V=V, G=G,
                               D=D, Gb=Gb)
    i32 = jnp.int32
    out = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((D * G,), i32),
            jax.ShapeDtypeStruct((D * G,), i32),
            jax.ShapeDtypeStruct((G,), i32),
            jax.ShapeDtypeStruct((G,), i32),
            jax.ShapeDtypeStruct((G,), i32),
            jax.ShapeDtypeStruct((A * G,), jnp.float32),
        ),
        grid=(pl.cdiv(G, Gb),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="mcts_walk",
    )(prior.reshape(-1), wsum.reshape(-1), visits.reshape(-1),
      parent.reshape(-1), action_from.reshape(-1),
      expanded.astype(jnp.int8).reshape(-1), probs.reshape(-1))
    nodes, actions, node, leaf_action, alloc, root_pi = out
    return Walk(nodes.reshape(D, G), actions.reshape(D, G), node,
                leaf_action, alloc != 0, root_pi.reshape(A, G))


def _policy64(prior, wsum, visits, cpuct):
    """``newton.node_policy`` in float64 on the host, for rows [A, L];
    also returns each lane's Newton error before every step ([steps, L],
    nan once the lane has stopped)."""
    visits = visits.astype(np.float64)
    prior = prior.astype(np.float64)
    q = np.where(visits > 0, wsum / np.maximum(visits, 1.0), 0.0)
    n = 1.0 + visits.sum(0)
    lam = cpuct * np.sqrt(n) / ((prior > 0).sum(0) + n)
    top = lam * prior
    alpha = np.max(q + np.maximum(top, ALPHA_FLOOR), axis=0)
    prev = np.full_like(alpha, np.inf)
    conv = np.zeros(alpha.shape, bool)
    errs = []
    with np.errstate(divide="ignore", invalid="ignore"):
        for _ in range(NEWTON_CHUNK * NEWTON_MAX_CHUNKS):
            r = 1.0 / (alpha - q)
            frac = top * r
            err = frac.sum(0) - 1.0
            grad = -(frac * r).sum(0)
            errs.append(np.where(conv, np.nan, err))
            conv = conv | (err < NEWTON_TOL) | (err == prev)
            alpha = np.where(conv, alpha, alpha - err / np.where(
                grad == 0, 1.0, grad))
            prev = np.where(conv, prev, err)
        pi = top / (alpha - q)
    fresh = visits.sum(0) == 0
    return np.where(fresh, prior, pi), np.where(fresh, np.nan, errs)


def compare_walks(tree, probs, cpuct, ref: Walk, got: Walk, pi_tol=1e-5,
                  prefix_eps=1e-6, newton_eps=1e-5):
    """The parity contract between two walks of one tree on one uniform
    stream (host-side, numpy).  The two sum in different orders, which
    matters only at two kinds of floating-point tie: a Newton error within
    ``newton_eps`` of the stopping tolerance (one solve stops a step
    before the other, moving pi by up to ~1e-3), and a uniform within
    ``prefix_eps`` of a prefix sum of the policy (the CDF walk picks the
    neighbouring action).  Returns counts: ``diverged`` lanes (path, leaf
    or allocation differ) and ``root_mismatch`` lanes (root policy off by
    more than ``pi_tol``), how many of them are ``prefix_ties`` and
    ``newton_ties``, and the ``unexplained`` rest, which must be 0."""
    r = jax.tree.map(np.asarray, ref)
    g = jax.tree.map(np.asarray, got)
    probs = np.asarray(probs)
    prior, wsum, visits = (np.asarray(x) for x in (
        tree.prior, tree.wsum, tree.visits))
    lanes = np.arange(r.node.shape[0])

    def newton_tie(nodes, ls):
        _, errs = _policy64(prior[:, nodes, ls], wsum[:, nodes, ls],
                            visits[:, nodes, ls], cpuct)
        with np.errstate(invalid="ignore"):
            return np.any(np.abs(errs - NEWTON_TOL) < newton_eps, axis=0)

    root_diff = np.abs(r.root_pi - g.root_pi).max(0)
    root_bad = np.flatnonzero(root_diff > pi_tol)
    root_ties = newton_tie(np.zeros_like(root_bad), root_bad)

    rmask = r.nodes >= 0
    same_depth = ((r.nodes == g.nodes)
                  & (np.where(rmask, r.actions, 0)
                     == np.where(g.nodes >= 0, g.actions, 0)))
    lane_same = (same_depth.all(0) & (r.node == g.node)
                 & (r.needs_alloc == g.needs_alloc)
                 & (~r.needs_alloc | (r.leaf_action == g.leaf_action)))
    div = lanes[~lane_same]
    # first depth where the walks differ, and the node both stood on there
    d = np.where(same_depth[:, div].all(0), rmask[:, div].sum(0),
                 np.argmin(same_depth[:, div], axis=0))
    d = np.minimum(d, probs.shape[0] - 1)
    node = np.where(rmask[d, div], r.nodes[d, div], r.node[div])
    pi, _ = _policy64(prior[:, node, div], wsum[:, node, div],
                      visits[:, node, div], cpuct)
    prefix = (np.abs(np.cumsum(pi, axis=0) - probs[d, div]) < prefix_eps
              ).any(0)
    newton = newton_tie(node, div) & ~prefix
    return {
        "lanes": int(lanes.size),
        "root_pi_maxdiff": float(root_diff.max()),
        "root_mismatch": int(root_bad.size),
        "diverged": int(div.size),
        "prefix_ties": int(prefix.sum()),
        "newton_ties": int(newton.sum() + root_ties.sum()),
        "unexplained": int((~root_ties).sum() + (~(prefix | newton)).sum()),
    }
