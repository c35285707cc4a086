"""Self-play: a whole generation of games as ONE jitted program.

The reference plays moves in a host loop - every move round downloads the
root policies, pushes samples to a CPU buffer, applies moves with scalar
`play`, compacts finished games and re-uploads positions
(mcts_gpu.jl:477-579).  Here the entire generation is a single
``lax.scan`` over move indices with done-masking instead of compaction:
fixed shapes, zero host syncs, and the replay buffer is written in-graph.

Semantics preserved from the reference:
* move selection: sample proportional to the root policy while
  ``move < 25``, argmax afterwards (mcts_gpu.jl:518-524),
* the recorded sample is (root encoding, root policy, player-to-move);
  values/features are back-filled for all moves of a finished game
  (main4IARow.jl:65-75) - here via a closed-form fill after the scan,
* result bookkeeping and mean game length (mcts_gpu.jl:541-577).

Deviation (documented): the reference loops until every game terminates;
this scan is bounded by ``max_moves`` (default: the game's
``maxLengthGame``) and the rare game still running at the bound (possible
only for Reversi pass-chains) is excluded from the buffer and counted in
``stats['unfinished']``.

Continuous mode additionally persists in-flight episodes across
generations through :class:`EpisodeCarry` (positions + the episode's
recorded samples + the PRNG stream), so the round bound drops **zero**
search compute: samples of an episode spanning a generation boundary are
back-filled and written as soon as the episode ends in a later generation.
The reference achieves the same zero-loss property by looping until every
game ends (mcts_gpu.jl:494-561); the carry is the fixed-shape equivalent.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .buffer import ReplayBuffer, write_samples
from .mcts.newton import cdf_sample
from .mcts.search import run_mcts
from .mcts.tree import init_tree, reset_tree


class SelfplayConfig(NamedTuple):
    num_games: int = 32768  # reference --samples default (main4IARow.jl:93)
    rollouts: int = 64  # --rollout default (main4IARow.jl:97)
    cpuct: float = 1.5  # --cpuct default (main4IARow.jl:109)
    temp_moves: int = 25  # sample-vs-argmax cutoff (mcts_gpu.jl:518)
    max_moves: int | None = None  # defaults to game.max_game_length
    # Continuous mode: lanes recycle into fresh games immediately on
    # termination (see selfplay_continuous).  ``num_games`` then means the
    # lane count; ``rounds`` the total move rounds played per lane.
    continuous: bool = False
    rounds: int | None = None  # defaults to 2 * game.max_game_length
    # Recompute the root policy after the final backup instead of returning
    # the last pre-backup policy (the reference's copy_pol quirk) - an
    # opt-in strength knob, see run_mcts.
    fresh_root_policy: bool = False


def broadcast_initial(game, num_games: int):
    single = game.initial()
    return jax.tree.map(
        lambda leaf: jnp.broadcast_to(leaf, (num_games,) + leaf.shape), single
    )


class EpisodeCarry(NamedTuple):
    """Cross-generation state of each lane's in-flight episode (continuous
    mode).  All leaves lead with the games axis so ``P('dp')`` shards the
    whole carry over a device mesh like the replay buffer.

    ``rng`` continues the selfplay PRNG stream: a run of k generations with
    a threaded carry draws the identical key sequence as one k-times-longer
    generation, which is what makes the chained-vs-single equivalence test
    exact (tests/test_selfplay.py)."""

    positions: object  # game position pytree, leading G
    count: jnp.ndarray  # i32[G] - moves already recorded this episode
    enc: jnp.ndarray  # i8[G, L, 2*VS] - root encodings, rows [0, count)
    pol: jnp.ndarray  # f32[G, L, A] - root policies
    player: jnp.ndarray  # i8[G, L] - player to move
    rng: jnp.ndarray  # PRNG key


def make_carry(game, num_games: int, rng) -> EpisodeCarry:
    """Fresh carry: all lanes start new episodes."""
    L = game.max_game_length
    return EpisodeCarry(
        positions=broadcast_initial(game, num_games),
        count=jnp.zeros((num_games,), jnp.int32),
        enc=jnp.zeros((num_games, L, 2 * game.vectorized_state), jnp.int8),
        pol=jnp.zeros((num_games, L, game.max_actions), jnp.float32),
        player=jnp.zeros((num_games, L), jnp.int8),
        rng=rng,
    )


def _decide_moves(game, net_apply, params, positions, tree, ep_move, rng,
                  cfg: SelfplayConfig):
    """One move round shared by both selfplay modes: search every lane's
    position, pick a move (sample while the lane's in-episode move index is
    below the temperature cutoff, argmax after - mcts_gpu.jl:518-524), and
    apply it.

    Returns ``(tree, root_enc, player, pol, ok, newpos, finished, result)``
    where ``ok`` is the per-lane legality of the chosen move (the
    reference's "faute" check, mcts_gpu.jl:526-529) and (finished, result)
    come from ``is_over`` on the played position.
    """
    G = positions.player.shape[0]
    k_mcts, k_samp = jax.random.split(rng)

    tree = reset_tree(tree, positions)
    tree, pol = run_mcts(
        game, net_apply, params, tree, k_mcts,
        rollouts=cfg.rollouts, cpuct=cfg.cpuct, training=True,
        final_root_policy=cfg.fresh_root_policy,
    )

    root_enc = jax.vmap(game.encode)(positions).astype(jnp.int8)

    # pol is [A, G] (games-minor); sampling matches the reference's
    # Weights() draw: uniform * total mass, CDF walk.
    u = jax.random.uniform(k_samp, (G,)) * pol.sum(0)
    sampled = cdf_sample(pol, u)
    greedy = jnp.argmax(pol, axis=0).astype(jnp.int32)
    action = jnp.where(ep_move < cfg.temp_moves, sampled, greedy)

    legal = jax.vmap(game.legal_mask)(positions)
    ok = jnp.take_along_axis(legal, action[:, None], axis=-1)[:, 0]

    newpos = jax.vmap(game.play)(positions, action)
    finished, result = jax.vmap(game.is_over)(newpos)
    return tree, root_enc, positions.player, pol, ok, newpos, finished, result


def selfplay_generation(
    game, net_apply, params, buffer: ReplayBuffer, rng, cfg: SelfplayConfig
):
    """Play ``cfg.num_games`` games to completion with MCTS selfplay and
    write every (state, policy, player, value, fstate) sample to the buffer.

    Returns (buffer, stats) where stats is a dict of scalars:
    wins / draws / losses (from the first mover's perspective), mean_length,
    illegal_moves (the reference's "faute" check, mcts_gpu.jl:526-529) and
    unfinished.
    """
    G = cfg.num_games
    T = cfg.max_moves or game.max_game_length
    positions0 = broadcast_initial(game, G)
    tree0 = init_tree(game, positions0, cfg.rollouts)

    def move_body(carry, t):
        positions, done, result, fin_t, illegal, tree, rng = carry
        rng, k_move = jax.random.split(rng)
        alive = ~done

        # every lane started at t=0 here, so the in-episode move index is t
        tree, root_enc, player_t, pol, ok, newpos, f, r = _decide_moves(
            game, net_apply, params, positions, tree,
            jnp.full((G,), t, jnp.int32), k_move, cfg,
        )
        illegal = illegal + (alive & ~ok).sum()
        positions = jax.tree.map(
            lambda new, old: jnp.where(
                alive.reshape((-1,) + (1,) * (new.ndim - 1)), new, old
            ),
            newpos,
            positions,
        )
        newly = alive & f
        result = jnp.where(newly, r, result)
        fin_t = jnp.where(newly, t, fin_t)
        done = done | f

        out = (root_enc, pol, player_t, alive)
        return (positions, done, result, fin_t, illegal, tree, rng), out

    init = (
        positions0,
        jnp.zeros((G,), bool),
        jnp.zeros((G,), jnp.int8),
        jnp.zeros((G,), jnp.int32),
        jnp.int32(0),
        tree0,
        rng,
    )
    (positions, done, result, fin_t, illegal, _, _), outs = jax.lax.scan(
        move_body, init, jnp.arange(T)
    )
    enc_s, pol_s, player_s, alive_s = outs  # enc [T,G,in], pol [T,A,G]
    pol_s = jnp.moveaxis(pol_s, 1, 2)  # -> [T, G, A] for row-major buffer

    final_feat = jax.vmap(game.final_feature)(positions)  # [G, fsize]
    res_f = result.astype(jnp.float32)
    play_f = player_s.astype(jnp.float32)
    value_s = (1.0 + res_f[None, :] * play_f) / 2.0  # [T, G]
    fstate_s = final_feat[None, :, :] * player_s[:, :, None]  # [T, G, fsize]
    mask = alive_s & done[None, :]  # only moves of games that finished

    A = game.max_actions
    buffer = write_samples(
        buffer,
        enc_s.reshape(T * G, -1),
        pol_s.reshape(T * G, A),
        player_s.reshape(T * G),
        value_s.reshape(T * G),
        fstate_s.reshape(T * G, -1),
        mask.reshape(T * G),
    )

    stats = {
        "wins": ((result == 1) & done).sum(),
        "draws": ((result == 0) & done).sum(),
        "losses": ((result == -1) & done).sum(),
        # reference records the 0-based round index at termination
        # (mcts_gpu.jl:536, 576)
        "mean_length": jnp.where(
            done.any(), fin_t.sum() / jnp.maximum(done.sum(), 1), 0.0
        ),
        "illegal_moves": illegal,
        "unfinished": (~done).sum(),
        "samples_written": mask.sum(),
    }
    return buffer, stats


def selfplay_continuous(
    game, net_apply, params, buffer: ReplayBuffer, rng, cfg: SelfplayConfig,
    carry: EpisodeCarry | None = None,
):
    """Continuous selfplay: every lane that finishes a game is recycled into
    a fresh one on the next move round, so all ``num_games`` lanes stay at
    ~100% utilization for all ``rounds`` rounds.

    The reference keeps utilization up by *compacting* the live-game vector
    every move (mcts_gpu.jl:550-560) - a host-side realloc that forces a
    device sync and (under jit) would force a recompile per shape.  Lane
    recycling is the fixed-shape equivalent and strictly better: instead of
    shrinking the batch as games die, dead lanes are refilled, so one
    generation plays ``rounds``-many *move decisions* per lane rather than
    one game per lane padded to the slowest game (~3x more samples per
    second at Connect-4's mean game length).

    Back-fill works per episode: each lane tracks its episode index ``eid``
    (bounded by rounds // min_game_length + 1); termination scatters the
    episode's (result, final feature) into per-lane tables; after the scan
    every sample (t, g) looks up its episode row and computes
    ``value = (1 + result * player) / 2``, ``fstate = final_feature * player``
    exactly as the reference back-fill (main4IARow.jl:65-75).

    ``carry`` (None = fresh start) persists in-flight episodes across calls:
    episode 0 of each lane continues from ``carry.positions`` and, when it
    terminates, the moves recorded in earlier generations (``carry.enc`` /
    ``pol`` / ``player`` rows below ``carry.count``) are back-filled and
    written together with this generation's samples, so nothing the search
    paid for is ever dropped (the reference plays every game to completion
    within the generation, mcts_gpu.jl:494-561 - same zero-loss property).
    When a carry is given its ``rng`` continues the stream and the ``rng``
    argument is ignored.

    Returns (buffer, stats, carry'); ``stats['games_finished']`` counts
    completed episodes, ``stats['carried']`` the in-flight rows handed to
    the next generation (they will be written once their episodes end).
    """
    G = cfg.num_games
    T = cfg.rounds or 2 * game.max_game_length
    E = T // game.min_game_length + 2  # episode table rows per lane
    L = game.max_game_length
    if carry is None:
        carry = make_carry(game, G, rng)
    positions0 = carry.positions
    tree0 = init_tree(game, positions0, cfg.rollouts)

    def move_body(carry, t):
        (positions, eid, ep_start, res_table, ftable, counters, illegal,
         tree, rng) = carry
        rng, k_move = jax.random.split(rng)

        ep_move = t - ep_start  # move index within the lane's episode
        tree, root_enc, player_t, pol, ok, positions, f, r = _decide_moves(
            game, net_apply, params, positions, tree, ep_move, k_move, cfg,
        )
        illegal = illegal + (~ok).sum()

        # terminated lanes: record the episode, then recycle.
        final_feat = jax.vmap(game.final_feature)(positions)  # [G, fsize] i8
        oh_e = (jnp.arange(E)[:, None] == eid[None, :]) & f[None, :]  # [E, G]
        res_table = jnp.where(oh_e, r[None, :], res_table)
        ftable = jnp.where(oh_e[:, :, None], final_feat[None], ftable)
        counters = {
            "wins": counters["wins"] + (f & (r == 1)).sum(),
            "draws": counters["draws"] + (f & (r == 0)).sum(),
            "losses": counters["losses"] + (f & (r == -1)).sum(),
            # 0-based round index at termination (mcts_gpu.jl:536, 576)
            "length_sum": counters["length_sum"] + jnp.where(f, ep_move, 0).sum(),
        }
        fresh = broadcast_initial(game, G)
        positions = jax.tree.map(
            lambda new, old: jnp.where(
                f.reshape((-1,) + (1,) * (new.ndim - 1)), new, old
            ),
            fresh,
            positions,
        )
        out = (root_enc, pol, player_t, eid.astype(jnp.int32))
        eid = eid + f.astype(jnp.int32)
        ep_start = jnp.where(f, t + 1, ep_start)
        carry = (positions, eid, ep_start, res_table, ftable, counters,
                 illegal, tree, rng)
        return carry, out

    counters0 = {
        "wins": jnp.int32(0),
        "draws": jnp.int32(0),
        "losses": jnp.int32(0),
        "length_sum": jnp.int32(0),
    }
    init = (
        positions0,
        jnp.zeros((G,), jnp.int32),  # eid
        -carry.count,  # ep_start: continuing episodes began count moves ago
        jnp.zeros((E, G), jnp.int8),  # res_table
        jnp.zeros((E, G, game.feature_size), jnp.int8),  # ftable
        counters0,
        jnp.int32(0),
        tree0,
        carry.rng,
    )
    (positions, eid_final, ep_start_f, res_table, ftable, counters, illegal,
     _, rng_f), outs = jax.lax.scan(move_body, init, jnp.arange(T))
    enc_s, pol_s, player_s, eid_s = outs  # enc [T,G,in], pol [T,A,G]
    pol_s = jnp.moveaxis(pol_s, 1, 2)  # -> [T, G, A]

    # per-sample episode lookups
    res_s = jnp.take_along_axis(res_table, eid_s, axis=0)  # [T, G] i8
    # ftable [E, G, fsize] gathered at eid_s -> [T, G, fsize]
    fstate_ep = jnp.take_along_axis(
        ftable, eid_s[:, :, None], axis=0
    )
    play_f = player_s.astype(jnp.float32)
    value_s = (1.0 + res_s.astype(jnp.float32) * play_f) / 2.0  # [T, G]
    fstate_s = fstate_ep * player_s[:, :, None]  # [T, G, fsize] i8
    completed = eid_s < eid_final[None, :]  # episode finished before round T

    # carried-in rows: they belong to episode 0 of this generation, finished
    # iff any episode finished on that lane.  Back-fill exactly like in-gen
    # rows, from episode-table row 0.
    lio = jnp.arange(L)[None, :]  # [1, L]
    pend_play_f = carry.player.astype(jnp.float32)  # [G, L]
    pend_value = (1.0 + res_table[0].astype(jnp.float32)[:, None]
                  * pend_play_f) / 2.0
    pend_fstate = ftable[0][:, None, :] * carry.player[:, :, None]
    pend_mask = (lio < carry.count[:, None]) & (eid_final > 0)[:, None]

    A = game.max_actions
    # carried rows are older than this generation's: write them first
    buffer = write_samples(
        buffer,
        jnp.concatenate(
            [carry.enc.reshape(G * L, -1), enc_s.reshape(T * G, -1)]),
        jnp.concatenate(
            [carry.pol.reshape(G * L, A), pol_s.reshape(T * G, A)]),
        jnp.concatenate(
            [carry.player.reshape(G * L), player_s.reshape(T * G)]),
        jnp.concatenate(
            [pend_value.reshape(G * L), value_s.reshape(T * G)]),
        jnp.concatenate(
            [pend_fstate.reshape(G * L, -1), fstate_s.reshape(T * G, -1)]),
        jnp.concatenate(
            [pend_mask.reshape(G * L), completed.reshape(T * G)]),
    )

    # next carry: rows of each lane's still-running episode.  s = round the
    # running episode started at (negative: it began -s moves before this
    # generation, i.e. it is the carried-in episode, still unfinished).
    s = ep_start_f  # i32[G]
    new_count = T - s
    overflow = new_count > L  # episode outlived maxLengthGame: reset lane
    src = jnp.clip(lio + s[:, None], 0, T - 1)  # [G, L] index into rounds
    from_old = lio < -s[:, None]

    def merge(old_GL, new_TG):  # [G, L, ...] <- [T, G, ...]
        new_G = jnp.moveaxis(new_TG, 0, 1)  # [G, T, ...]
        idx = src.reshape(src.shape + (1,) * (new_G.ndim - 2))
        gathered = jnp.take_along_axis(new_G, idx, axis=1)
        keep = from_old.reshape(from_old.shape + (1,) * (old_GL.ndim - 2))
        return jnp.where(keep, old_GL, gathered)

    new_count = jnp.where(overflow, 0, new_count)
    new_positions = jax.tree.map(
        lambda fresh, cur: jnp.where(
            overflow.reshape((-1,) + (1,) * (cur.ndim - 1)), fresh, cur
        ),
        broadcast_initial(game, G),
        positions,
    )
    new_carry = EpisodeCarry(
        positions=new_positions,
        count=new_count,
        enc=merge(carry.enc, enc_s),
        pol=merge(carry.pol, pol_s),
        player=merge(carry.player, player_s),
        rng=rng_f,
    )

    finished = eid_final.sum()
    written = pend_mask.sum() + completed.sum()
    stats = {
        "wins": counters["wins"],
        "draws": counters["draws"],
        "losses": counters["losses"],
        "mean_length": counters["length_sum"] / jnp.maximum(finished, 1),
        "illegal_moves": illegal,
        # rows DROPPED (episode outlived maxLengthGame - impossible for the
        # shipped games, guarded for robustness); in-flight rows are carried,
        # not dropped
        "unfinished": jnp.where(overflow, T - s, 0).sum(),
        "carried": new_count.sum(),
        "games_finished": finished,
        "samples_written": written,
    }
    return buffer, stats, new_carry
