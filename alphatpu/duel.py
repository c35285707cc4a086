"""Arena: two-network duels with gating and incremental Elo.

Reference equivalents: the 2-actor `mcts` move loop alternating actors by
round parity (mcts_gpu.jl:581-651), `duelnetwork` playing half the games
with each starter (mcts_gpu.jl:653-668), and the Elo update in the
generation orchestrator (selfplay.jl:62-77).

Duels always run with cpuct = 2.0 - the reference's 2-actor `mcts` uses its
own default and never receives the CLI flag (mcts_gpu.jl:581) - and without
root noise mixing (training=false path, mcts_gpu.jl:276-280).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .mcts.newton import cdf_sample
from .mcts.search import run_mcts
from .mcts.tree import init_tree, reset_tree
from .selfplay import broadcast_initial


class DuelConfig(NamedTuple):
    num_games: int = 1024  # selfplay.jl:56
    rollouts: int = 32  # selfplay.jl:56
    cpuct: float = 2.0  # mcts_gpu.jl:581 default, CLI flag not forwarded
    temp_moves: int = 15  # sample-vs-argmax cutoff (mcts_gpu.jl:605)
    max_moves: int | None = None


def duel_half(game, net_apply, params_first, params_second, rng,
              cfg: DuelConfig):
    """All games with ``params_first`` moving first.  Returns
    (wins_first, draws, wins_second, unfinished) as device scalars.  The
    reference loops until every game terminates; this scan is bounded by
    the move cap, and a game still running there (possible only for
    Reversi pass-chains) is counted in ``unfinished`` - excluded from the
    result tally rather than silently called a draw."""
    G = cfg.num_games
    T = cfg.max_moves or game.max_game_length
    positions0 = broadcast_initial(game, G)
    tree0 = init_tree(game, positions0, cfg.rollouts)
    # both nets stacked on a leading axis: per round one dynamic slice
    # copies a single net instead of where-blending both full pytrees
    params_pair = jax.tree.map(
        lambda a, b: jnp.stack([a, b]), params_first, params_second
    )

    def move_body(carry, t):
        positions, done, result, tree, rng = carry
        rng, k_mcts, k_samp = jax.random.split(rng, 3)
        # actor by round parity (mcts_gpu.jl:592-596)
        params_t = jax.tree.map(lambda s: s[t % 2], params_pair)
        tree = reset_tree(tree, positions)
        tree, pol = run_mcts(
            game, net_apply, params_t, tree, k_mcts,
            rollouts=cfg.rollouts, cpuct=cfg.cpuct, training=False,
        )
        alive = ~done
        u = jax.random.uniform(k_samp, (G,)) * pol.sum(0)  # pol is [A, G]
        sampled = cdf_sample(pol, u)
        greedy = jnp.argmax(pol, axis=0).astype(jnp.int32)
        action = jnp.where(t < cfg.temp_moves, sampled, greedy)
        newpos = jax.vmap(game.play)(positions, action)
        positions = jax.tree.map(
            lambda new, old: jnp.where(
                alive.reshape((-1,) + (1,) * (new.ndim - 1)), new, old
            ),
            newpos, positions,
        )
        f, r = jax.vmap(game.is_over)(positions)
        newly = alive & f
        result = jnp.where(newly, r, result)
        done = done | f
        return (positions, done, result, tree, rng), None

    init = (
        positions0,
        jnp.zeros((G,), bool),
        jnp.zeros((G,), jnp.int8),
        tree0,
        rng,
    )
    (positions, done, result, _, _), _ = jax.lax.scan(
        move_body, init, jnp.arange(T)
    )
    wins_first = ((result == 1) & done).sum()
    wins_second = ((result == -1) & done).sum()
    draws = ((result == 0) & done).sum()
    unfinished = (~done).sum()
    return wins_first, draws, wins_second, unfinished


_duel_half_jit = jax.jit(duel_half, static_argnums=(0, 1, 5))


def duel_network(game, net_apply, params_a, params_b, rng, cfg: DuelConfig):
    """Reference `duelnetwork` (mcts_gpu.jl:653-668): half the games with
    each network starting.  Returns host ints
    (wins_a, draws, wins_b, unfinished)."""
    half = cfg._replace(num_games=cfg.num_games // 2)
    k1, k2 = jax.random.split(rng)
    va1, n1, vb1, u1 = _duel_half_jit(
        game, net_apply, params_a, params_b, k1, half
    )
    vb2, n2, va2, u2 = _duel_half_jit(
        game, net_apply, params_b, params_a, k2, half
    )
    return (
        int(va1) + int(va2),
        int(n1) + int(n2),
        int(vb1) + int(vb2),
        int(u1) + int(u2),
    )


def elo_update(wins: int, draws: int, losses: int, current_elo: float):
    """Incremental Elo of the candidate vs the incumbent
    (selfplay.jl:64-65): EA = games / (w + d/2);
    new = -400 * log10(EA - 1) + current."""
    games = wins + draws + losses
    score = wins + 0.5 * draws
    if score <= 0:
        return current_elo - 400.0
    ea = games / score
    if ea <= 1.0:
        return current_elo + 400.0
    return -400.0 * math.log10(ea - 1.0) + current_elo
