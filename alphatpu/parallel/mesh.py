"""Multi-chip scale-out: shard the games axis over a device mesh.

The reference is single-process / single-GPU (SURVEY.md section 2.2); here
selfplay games and duels shard over a 1-axis ``dp`` mesh with ZERO
cross-device traffic during search (each device owns its games, trees and
replay-buffer shard), and the learner runs data-parallel with ``pmean``
gradient reduction.  Weight "broadcast" per generation is just the
replicated-parameter sharding of the updated pytree.

Everything routes through ``shard_map`` so the exact single-device programs
run unchanged on local shards; multi-host execution only needs
``jax.distributed.initialize`` before building the mesh.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..buffer import ReplayBuffer, buffer_size, sample_batch
from ..duel import DuelConfig, duel_half
from ..selfplay import SelfplayConfig, selfplay_continuous, selfplay_generation
from ..train import TrainConfig, loss_fn, train_epoch

AXIS = "dp"


def make_mesh(num_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if num_devices:
        if len(devices) < num_devices:
            raise ValueError(
                f"--devices {num_devices} requested but only {len(devices)} "
                f"JAX device(s) visible ({devices}); for a CPU host mesh set "
                f"jax_platforms=cpu and jax_num_cpu_devices before first "
                f"device use, for multi-host pass --multihost"
            )
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (AXIS,))


def device_keys(rng, mesh: Mesh):
    """One PRNG key per device, shardable with P(AXIS)."""
    return jax.random.split(rng, mesh.devices.size)


def _psum_stats(stats):
    finished = stats["wins"] + stats["draws"] + stats["losses"]
    length_sum = stats["mean_length"] * finished.astype(jnp.float32)
    out = {
        k: jax.lax.psum(stats[k], AXIS)
        for k in stats
        if k != "mean_length"
    }
    fin_tot = out["wins"] + out["draws"] + out["losses"]
    out["mean_length"] = jax.lax.psum(length_sum, AXIS) / jnp.maximum(
        fin_tot, 1
    ).astype(jnp.float32)
    return out


def sharded_selfplay_fn(game, net_apply, cfg: SelfplayConfig, mesh: Mesh):
    """Build a jitted sharded selfplay executor: the buffer rows and
    per-device rings shard over the mesh and each device plays
    ``cfg.num_games / D`` games locally.

    One-shot mode: ``(params, buffer, keys) -> (buffer, stats)``.
    Continuous mode additionally threads the cross-generation
    :class:`~alphatpu.selfplay.EpisodeCarry` (every leaf leads with the
    games axis, so ``P(AXIS)`` shards it like the buffer; its ``rng`` leaf
    is the per-device ``keys`` array and is refreshed from ``keys`` each
    call): ``(params, buffer, keys, carry) -> (buffer, stats, carry)``.
    """
    D = mesh.devices.size
    assert cfg.num_games % D == 0, "num_games must divide the mesh size"
    local_cfg = cfg._replace(num_games=cfg.num_games // D)

    if not cfg.continuous:
        @jax.jit
        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P()),
            check_vma=False,
        )
        def run(params, buffer, keys):
            buffer, stats = selfplay_generation(
                game, net_apply, params, buffer, keys[0], local_cfg
            )
            return buffer, _psum_stats(stats)

        return run

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(), P(AXIS)),
        check_vma=False,
    )
    def run_cont(params, buffer, keys, carry):
        buffer, stats, carry = selfplay_continuous(
            game, net_apply, params, buffer, keys[0], local_cfg,
            carry._replace(rng=keys[0]),
        )
        return buffer, _psum_stats(stats), carry._replace(rng=keys)

    return run_cont


def sharded_train_fn(game, cfg: TrainConfig, optimizer, mesh: Mesh):
    """Data-parallel learner: per-device batches from the local buffer
    shard, pmean'd gradients (``cfg.batch_size`` is the global batch)."""
    D = mesh.devices.size
    assert cfg.batch_size % D == 0
    local_cfg = cfg._replace(batch_size=cfg.batch_size // D)

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def run(params, opt_state, buffer, rng):
        return train_epoch(
            params, opt_state, buffer, rng, local_cfg, optimizer,
            axis_name=AXIS,
        )

    return run


def emulated_train_epoch(params, opt_state, buffer: ReplayBuffer, rng,
                         cfg: TrainConfig, optimizer, num_devices: int):
    """The reference :func:`sharded_train_fn` is checked against: its
    protocol replayed on one device.  Device d draws its local batch from
    its own buffer shard with the key folded by d (then by the update
    index), and the update applies the gradients averaged over devices.
    Returns (params, opt_state, mean loss)."""
    import optax

    D = num_devices
    per = buffer.capacity // D
    shards = [
        ReplayBuffer(*(leaf[d * per:(d + 1) * per] for leaf in buffer[:5]),
                     buffer.cursor[d:d + 1], buffer.total[d:d + 1])
        for d in range(D)
    ]
    nsamples = min(sum(int(buffer_size(s)) for s in shards), cfg.max_samples)
    n_updates = max(nsamples // cfg.batch_size - 1, 1)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for i in range(n_updates):
        out = [
            grad_fn(params, *sample_batch(
                s, jax.random.fold_in(jax.random.fold_in(rng, d), i),
                cfg.batch_size // D), cfg.feature_weight)
            for d, s in enumerate(shards)
        ]
        losses.append(jnp.mean(jnp.stack([loss for loss, _ in out])))
        gmean = jax.tree.map(lambda *gs: jnp.mean(jnp.stack(gs), axis=0),
                             *[g for _, g in out])
        updates, opt_state = optimizer.update(gmean, opt_state, params)
        params = optax.apply_updates(params, updates)
    return params, opt_state, jnp.mean(jnp.stack(losses))


def sharded_duel_fn(game, net_apply, cfg: DuelConfig, mesh: Mesh):
    """Duel games shard over the mesh; returns summed (w, d, l, unfinished)
    scalars."""
    D = mesh.devices.size
    assert cfg.num_games % D == 0
    local_cfg = cfg._replace(num_games=cfg.num_games // D)

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS)),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    def run(params_first, params_second, keys):
        w, d, l, u = duel_half(
            game, net_apply, params_first, params_second, keys[0], local_cfg
        )
        return (
            jax.lax.psum(w, AXIS),
            jax.lax.psum(d, AXIS),
            jax.lax.psum(l, AXIS),
            jax.lax.psum(u, AXIS),
        )

    return run


def sharded_duel_network(game, net_apply, cfg: DuelConfig, mesh: Mesh):
    """The full gating duel (`duelnetwork`, mcts_gpu.jl:653-668) with its
    games sharded over the mesh: half the games with each starter.  Returns
    a host fn ``(params_a, params_b, rng) -> (w, d, l, unfinished)``."""
    half = cfg._replace(num_games=cfg.num_games // 2)
    run = sharded_duel_fn(game, net_apply, half, mesh)

    def duel(params_a, params_b, rng):
        k1, k2 = jax.random.split(rng)
        va1, n1, vb1, u1 = run(params_a, params_b, device_keys(k1, mesh))
        vb2, n2, va2, u2 = run(params_b, params_a, device_keys(k2, mesh))
        return (
            int(va1) + int(va2),
            int(n1) + int(n2),
            int(vb1) + int(vb2),
            int(u1) + int(u2),
        )

    return duel
