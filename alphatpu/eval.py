"""Strength evaluation utilities.

The reference evaluates nets only by human / external-engine play
(testHex.jl etc., reference README.md:49-60).  Machine-side probes:

* :func:`eval_vs_random` - batched games of the candidate (full MCTS,
  greedy after the temperature cutoff) against a uniform-random legal
  mover; the cheapest absolute-strength floor.
* :func:`ladder` - round-robin duels between checkpoints using the arena
  (duel_network), for Elo-over-generations curves.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .duel import DuelConfig, duel_network
from .mcts.search import run_mcts
from .mcts.tree import init_tree, reset_tree
from .selfplay import broadcast_initial


class EvalConfig(NamedTuple):
    num_games: int = 256
    rollouts: int = 64
    cpuct: float = 1.5
    max_moves: int | None = None


@partial(jax.jit, static_argnums=(0, 1, 5, 6))
def _vs_random_half(game, net_apply, params, rng, positions0, cfg: EvalConfig,
                    net_first: bool):
    """All games with the net moving first (or second).  Returns
    (net_wins, draws, net_losses, unfinished); the net plays greedily
    (diversity comes from the random opponent's stream)."""
    G = cfg.num_games
    T = cfg.max_moves or game.max_game_length
    tree0 = init_tree(game, positions0, cfg.rollouts)

    def move_body(carry, t):
        positions, done, result, tree, rng = carry
        # independent streams for the search and the random mover
        rng, k_mcts, k_rnd = jax.random.split(rng, 3)
        net_turn = (t % 2 == 0) == net_first
        alive = ~done

        tree = reset_tree(tree, positions)
        tree, pol = run_mcts(
            game, net_apply, params, tree, k_mcts,
            rollouts=cfg.rollouts, cpuct=cfg.cpuct, training=False,
        )
        from .mcts.newton import cdf_sample

        net_action = jnp.argmax(pol, axis=0).astype(jnp.int32)

        legal = jax.vmap(game.legal_mask)(positions)  # [G, A]
        rnd = jax.random.uniform(k_rnd, (G,)) * legal.sum(-1)
        rnd_action = cdf_sample(legal.T.astype(jnp.float32), rnd)

        action = jnp.where(net_turn, net_action, rnd_action)
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

    init = (positions0, jnp.zeros((G,), bool), jnp.zeros((G,), jnp.int8),
            tree0, rng)
    (_, done, result, _, _), _ = jax.lax.scan(move_body, init, jnp.arange(T))
    net_sign = jnp.int8(1 if net_first else -1)
    wins = ((result == net_sign) & done).sum()
    losses = ((result == -net_sign) & done).sum()
    draws = ((result == 0) & done).sum()
    return wins, draws, losses, (~done).sum()


def eval_vs_random(game, net_apply, params, rng, cfg: EvalConfig = EvalConfig()):
    """(wins, draws, losses) for the net over ``num_games`` games vs a
    uniform-random legal mover, half starting each.  The rare game not
    finished at the move bound counts as a draw (explicitly tallied)."""
    half = cfg._replace(num_games=cfg.num_games // 2)
    positions0 = broadcast_initial(game, half.num_games)
    k1, k2 = jax.random.split(rng)
    w1, d1, l1, u1 = _vs_random_half(game, net_apply, params, k1, positions0,
                                     half, True)
    w2, d2, l2, u2 = _vs_random_half(game, net_apply, params, k2, positions0,
                                     half, False)
    return int(w1 + w2), int(d1 + d2 + u1 + u2), int(l1 + l2)


def ladder(game, net_apply, checkpoints, rng, cfg: DuelConfig = DuelConfig()):
    """Round-robin duels between ``checkpoints`` (list of (name, params)).
    Returns a list of (name_a, name_b, wins_a, draws, wins_b)."""
    out = []
    for i, (na, pa) in enumerate(checkpoints):
        for nb, pb in checkpoints[i + 1:]:
            rng, k = jax.random.split(rng)
            w, d, l, _ = duel_network(game, net_apply, pa, pb, k, cfg)
            out.append((na, nb, w, d, l))
    return out
