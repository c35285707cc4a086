"""Batched regularized-policy solve (Grill et al. 2020, arXiv 2007.12509).

The reference's per-thread scalar Newton iteration - the stated bottleneck
of the whole system (README.md:81; kernel at mcts_gpu.jl:114-169,
scalar twin fast_mcts.jl:42-70) - becomes one batched solve over ``[A, G]``:

    lambda = cpuct * sqrt(n) / (A + n),      n = 1 + sum_a visits[a]
    solve   sum_a lambda * p[a] / (alpha - q[a]) = 1   for alpha,
    pi[a] = lambda * p[a] / (alpha - q[a])

The reference splits the sum into existing children plus a closed-form
``prior_rem / alpha`` term for unexpanded mass (mcts_gpu.jl:142-151); since
unvisited actions have q = 0 exactly, summing over *all* actions is
algebraically identical and vectorizes with no indirection.

Convergence matches the reference per game: stop when ``S - 1 < 1e-3`` or
the error repeats, with a hard cap of 100 steps; converged lanes freeze
while the rest iterate, and the while_loop exits as soon as every lane is
done (the typical case is < 10 steps).

These functions are shared verbatim by the jnp walk (``search.descend``)
and the GPU walk kernel (``walk_kernel``), so they use only primitives the
Pallas Triton lowering supports: min/max/sum reductions (no ``all``/``any``
reductions, no reversed slices).  Action rows padded with zeros (the
kernel pads A to a power of two) change no result.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# 12 chunks x 8 unrolled steps = 96 max updates (~ the reference's 100-cap,
# mcts_gpu.jl:141; convergence typically takes < 10).  The loop condition
# is evaluated once per chunk, not once per Newton step.
NEWTON_CHUNK = 8
NEWTON_MAX_CHUNKS = 12
NEWTON_TOL = 1e-3
ALPHA_FLOOR = 1e-4  # reference's per-action gap floor (mcts_gpu.jl:136)


def regularized_policy(prior, q, visits, cpuct):
    """prior/q/visits: f32[A, G] (games minor) -> pi: f32[A, G].

    Not normalized exactly (the solve stops at tolerance); sampling uses the
    CDF-with-fallback walk that the reference uses (mcts_gpu.jl:172-182).
    Per-lane convergence latching reproduces the reference's per-thread
    break (newerr < tol or repeated error): once a lane converges its alpha
    freezes for good.
    """
    n = 1.0 + visits.sum(0)
    num_actions = (prior > 0).sum(0).astype(jnp.float32)
    lam = cpuct * jnp.sqrt(n) / (num_actions + n)
    top = lam[None, :] * prior
    alpha0 = jnp.max(q + jnp.maximum(top, ALPHA_FLOOR), axis=0)

    def step(st):
        alpha, prev_err, conv = st
        # one reciprocal + two multiplies instead of two [A, G] divides
        r = 1.0 / (alpha[None, :] - q)
        frac = top * r
        s = frac.sum(0)
        grad = -(frac * r).sum(0)
        err = s - 1.0
        now_conv = (err < NEWTON_TOL) | (err == prev_err)
        conv = conv | now_conv
        delta = err / jnp.where(grad == 0, 1.0, grad)
        alpha = jnp.where(conv, alpha, alpha - delta)
        prev_err = jnp.where(conv, prev_err, err)
        return alpha, prev_err, conv

    def cond(st):
        (_, _, conv), j = st
        return (j < NEWTON_MAX_CHUNKS) & (jnp.min(conv.astype(jnp.int32)) == 0)

    def body(st):
        inner, j = st
        for _ in range(NEWTON_CHUNK):  # static unroll
            inner = step(inner)
        return inner, j + 1

    init = (
        alpha0,
        jnp.full_like(alpha0, jnp.inf),
        jnp.zeros(alpha0.shape, bool),
    )
    (alpha, _, _), _ = jax.lax.while_loop(cond, body, (init, jnp.int32(0)))
    return top / (alpha[None, :] - q)


def node_policy(prior_row, wsum_row, visits_row, cpuct):
    """Regularized policy for gathered node rows ([A, G] each): the Newton
    solve on current stats, with the fresh-node shortcut - a node whose
    edges have no visits samples its raw stored prior, exactly like the
    reference's prior->policy copy at expansion (mcts_gpu.jl:297-299)."""
    q_row = jnp.where(
        visits_row > 0, wsum_row / jnp.maximum(visits_row, 1.0), 0.0
    )
    pi = regularized_policy(prior_row, q_row, visits_row, cpuct)
    fresh = visits_row.sum(0) == 0.0  # [G]
    return jnp.where(fresh[None, :], prior_row, pi)


def cdf_sample(pi, prob):
    """Reference CDF walk (mcts_gpu.jl:172-182) over pi [A, G], prob [G]:
    pick the first action whose inclusive prefix sum reaches ``prob``; if
    the total mass is below ``prob``, fall back to the last action with
    positive probability."""
    num_actions = pi.shape[0]
    aio = jax.lax.broadcasted_iota(jnp.int32, pi.shape, 0)
    csum = jnp.cumsum(pi, axis=0)
    positive = pi > 0
    reach = (csum >= prob[None, :]) & positive
    first = jnp.min(jnp.where(reach, aio, num_actions), axis=0)
    last_pos = jnp.max(jnp.where(positive, aio, 0), axis=0)
    return jnp.where(first < num_actions, first, last_pos).astype(jnp.int32)
