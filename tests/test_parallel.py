"""Multi-device (8 virtual CPU devices) sharding tests: sharded selfplay,
data-parallel training equivalence, sharded duel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphatpu.buffer import buffer_size, create_buffer, global_buffer_size
from alphatpu.duel import DuelConfig
from alphatpu.games import make_game
from alphatpu.nets import apply_inference, config_for_game, init_params
from alphatpu.parallel import (
    device_keys,
    emulated_train_epoch,
    make_mesh,
    sharded_duel_fn,
    sharded_selfplay_fn,
    sharded_train_fn,
)
from alphatpu.selfplay import SelfplayConfig
from alphatpu.train import TrainConfig, make_optimizer, train_epoch


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return make_mesh()


def test_sharded_selfplay(mesh):
    game = make_game("tictactoe")
    params = init_params(jax.random.key(0), config_for_game(game, width=32, depth=2))
    D = mesh.devices.size
    cfg = SelfplayConfig(num_games=4 * D, rollouts=12)
    buf = create_buffer(game, capacity=128 * D, shards=D)
    run = sharded_selfplay_fn(game, apply_inference, cfg, mesh)
    buf, stats = run(params, buf, device_keys(jax.random.key(1), mesh))
    stats = {k: np.asarray(v) for k, v in stats.items()}
    assert stats["wins"] + stats["draws"] + stats["losses"] == 4 * D
    assert stats["illegal_moves"] == 0
    n = int(np.asarray(global_buffer_size(buf)))
    assert stats["samples_written"] == n
    assert 5 * 4 * D <= n <= 9 * 4 * D
    # every shard got its own games' samples
    totals = np.asarray(buf.total)
    assert totals.shape == (D,)
    assert (totals > 0).all()


def test_sharded_continuous_selfplay(mesh):
    """Continuous (lane-recycling) selfplay shards identically: per-device
    lanes, per-device episode tables, psum'd stats."""
    game = make_game("tictactoe")
    params = init_params(jax.random.key(0), config_for_game(game, width=32, depth=2))
    D = mesh.devices.size
    T = 16
    cfg = SelfplayConfig(num_games=2 * D, rollouts=12, continuous=True,
                         rounds=T)
    buf = create_buffer(game, capacity=128 * D, shards=D)
    run = sharded_selfplay_fn(game, apply_inference, cfg, mesh)
    keys = device_keys(jax.random.key(1), mesh)
    from alphatpu.selfplay import make_carry

    carry = make_carry(game, 2 * D, jax.random.key(2))._replace(rng=keys)
    buf, stats, carry = run(params, buf, keys, carry)
    stats = {k: np.asarray(v) for k, v in stats.items()}
    assert stats["illegal_moves"] == 0
    finished = stats["wins"] + stats["draws"] + stats["losses"]
    assert finished == stats["games_finished"]
    assert finished >= 2 * D  # >= one episode per lane in 16 rounds
    assert stats["unfinished"] == 0  # in-flight rows carry, never drop
    assert stats["samples_written"] + stats["carried"] == T * 2 * D
    assert int(np.asarray(carry.count).sum()) == stats["carried"]
    assert int(np.asarray(global_buffer_size(buf))) == stats["samples_written"]
    assert (np.asarray(buf.total) > 0).all()
    # a second chained generation flushes the carried rows
    buf, stats2, carry = run(params, buf, keys, carry)
    stats2 = {k: np.asarray(v) for k, v in stats2.items()}
    assert stats2["unfinished"] == 0
    assert int(np.asarray(global_buffer_size(buf))) == (
        stats["samples_written"] + stats2["samples_written"]
    )


def test_sharded_train_matches_single_device(mesh):
    """pmean-of-shard-gradients == single-device gradient on the same global
    batch: run one update with identical data distributed vs gathered."""
    game = make_game("tictactoe")
    cfg = TrainConfig(batch_size=64, epochs=1)
    params = init_params(jax.random.key(0), config_for_game(game, width=32, depth=2))
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(params)
    D = mesh.devices.size

    # one shared buffer whose shards all hold identical rows -> per-device
    # uniform sampling hits identical distributions; we check a weaker but
    # deterministic property: the sharded run executes, params stay
    # replicated, and loss is finite.
    buf = create_buffer(game, capacity=64 * D, shards=D)
    rng = np.random.default_rng(0)
    from alphatpu.buffer import write_samples

    n = 64 * D
    st = rng.integers(0, 2, (n, 18)).astype(np.int8)
    pol = rng.random((n, 9), dtype=np.float32)
    pol /= pol.sum(-1, keepdims=True)
    # fill shard-by-shard so every local ring sees data
    per = 64
    for d in range(D):
        sl = slice(d * per, (d + 1) * per)
        sub = create_buffer(game, capacity=per)
        sub = write_samples(
            sub,
            jnp.asarray(st[sl]), jnp.asarray(pol[sl]),
            jnp.ones(per, jnp.int8), jnp.full(per, 0.5),
            jnp.ones((per, 9), jnp.int8), jnp.ones(per, bool),
        )
        buf = buf._replace(
            state=buf.state.at[sl].set(sub.state),
            policy=buf.policy.at[sl].set(sub.policy),
            player=buf.player.at[sl].set(sub.player),
            value=buf.value.at[sl].set(sub.value),
            fstate=buf.fstate.at[sl].set(sub.fstate),
            cursor=buf.cursor.at[d].set(0),
            total=buf.total.at[d].set(per),
        )

    run = sharded_train_fn(game, cfg, optimizer, mesh)
    new_params, new_opt, loss = run(params, opt_state, buf, jax.random.key(7))
    assert np.isfinite(float(loss))
    assert not np.allclose(
        np.asarray(new_params["base"]), np.asarray(params["base"])
    )
    # outputs replicated across devices (single logical value)
    assert new_params["base"].shape == params["base"].shape


def test_sharded_duel(mesh):
    game = make_game("tictactoe")

    def biased(params, x):
        B = x.shape[0]
        return jnp.zeros((B, 9)).at[:, 4].set(params["b"]), jnp.full((B,), 0.5)

    D = mesh.devices.size
    cfg = DuelConfig(num_games=2 * D, rollouts=8)
    run = sharded_duel_fn(game, biased, cfg, mesh)
    w, d, l, u = run(
        {"b": jnp.float32(2.0)}, {"b": jnp.float32(0.0)},
        device_keys(jax.random.key(0), mesh),
    )
    assert int(w) + int(d) + int(l) + int(u) == 2 * D


def _filled_sharded_buffer(game, per_shard, D, seed=0):
    """A D-shard buffer with every shard's ring filled with distinct rows."""
    from alphatpu.buffer import write_samples

    rng = np.random.default_rng(seed)
    n = per_shard * D
    buf = create_buffer(game, capacity=n, shards=D)
    st = rng.integers(0, 2, (n, 18)).astype(np.int8)
    pol = rng.random((n, 9), dtype=np.float32)
    pol /= pol.sum(-1, keepdims=True)
    val = rng.random(n, dtype=np.float32)
    fst = rng.integers(-1, 2, (n, 9)).astype(np.int8)
    buf = buf._replace(
        state=jnp.asarray(st), policy=jnp.asarray(pol),
        player=jnp.ones((n,), jnp.int8), value=jnp.asarray(val),
        fstate=jnp.asarray(fst),
        cursor=jnp.zeros((D,), jnp.int32),
        total=jnp.full((D,), per_shard, jnp.int32),
    )
    return buf


def test_sharded_train_equals_emulated_data_parallel(mesh):
    """EXACT equality: the sharded learner's parameter update equals a
    host-side emulation of the same protocol (per-device local batches from
    each shard with the same folded keys, gradients averaged) - the
    data-parallel path changes the math in no way."""
    game = make_game("tictactoe")
    D = mesh.devices.size
    per = 64
    # global batch 128 over 8 devices = 16/device; nsamples = 512
    # -> n_updates = max(512 // 128 - 1, 1) = 3
    cfg = TrainConfig(batch_size=128)
    params = init_params(
        jax.random.key(0), config_for_game(game, width=32, depth=2)
    )
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(params)
    buf = _filled_sharded_buffer(game, per, D)

    run = sharded_train_fn(game, cfg, optimizer, mesh)
    rng = jax.random.key(7)
    sh_params, _, sh_loss = run(params, opt_state, buf, rng)

    em_params, _, _ = emulated_train_epoch(
        params, opt_state, buf, rng, cfg, optimizer, D)

    for k in params:
        np.testing.assert_allclose(
            np.asarray(sh_params[k]), np.asarray(em_params[k]),
            rtol=2e-5, atol=1e-6, err_msg=k,
        )


def test_production_pipeline_sharded_generation(mesh):
    """`run_generation` itself (not hand-assembled pieces) runs
    sharded over the mesh - two full generations via PipelineConfig(devices=D),
    exactly what `python -m alphatpu.cli --devices D` executes."""
    from alphatpu.pipeline import PipelineConfig, init_pipeline, run_generation
    from alphatpu.duel import DuelConfig

    game = make_game("tictactoe")
    D = mesh.devices.size
    cfg = PipelineConfig(
        selfplay=SelfplayConfig(num_games=2 * D, rollouts=8, continuous=True,
                                rounds=12),
        train=TrainConfig(batch_size=8 * D),
        duel=DuelConfig(num_games=2 * D, rollouts=8),
        buffer_capacity=128 * D,
        generations=2,
        width=32,
        depth=2,
        devices=D,
        log=lambda s: None,
    )
    state = init_pipeline(game, cfg)
    assert state.buffer.total.shape == (D,)
    p0 = np.asarray(state.train_params["base"])

    state, stats1 = run_generation(game, state, cfg)
    assert stats1["illegal_moves"] == 0
    assert stats1["games_finished"] >= 2 * D
    assert np.isfinite(stats1["loss"])
    assert not np.allclose(np.asarray(state.train_params["base"]), p0)
    # every device's buffer shard received samples
    assert (np.asarray(state.buffer.total) > 0).all()

    state, stats2 = run_generation(game, state, cfg)
    assert stats2["generation"] == 2
    w, d, l = stats2["duel"]
    assert w + d + l + stats2["duel_unfinished"] == 2 * D


def test_sharded_carry_resume_exact(mesh, tmp_path):
    """A MULTI-DEVICE resume continues in-flight
    episodes exactly, like single-device.  Run a sharded continuous
    generation whose round bound leaves lanes mid-episode, checkpoint it,
    reload through the same [D, *key_data] rng template the CLI builds for
    --devices D, then verify (a) the restored carry equals the live one
    leaf-for-leaf and (b) the NEXT sharded generation from the restored
    state is bit-identical (samples, stats, buffer) to continuing live -
    i.e. no in-flight episode was dropped or restarted."""
    import copy

    from alphatpu import checkpoint as ckpt
    from alphatpu.duel import DuelConfig
    from alphatpu.pipeline import (
        PipelineConfig, init_pipeline, run_generation,
    )
    from alphatpu.selfplay import make_carry

    game = make_game("tictactoe")
    D = mesh.devices.size
    cfg = PipelineConfig(
        # 5 rounds < mean episode length => lanes genuinely mid-episode
        selfplay=SelfplayConfig(num_games=2 * D, rollouts=8,
                                continuous=True, rounds=5),
        train=TrainConfig(batch_size=8 * D),
        duel=DuelConfig(num_games=2 * D, rollouts=8),
        buffer_capacity=128 * D,
        generations=2,
        width=32,
        depth=2,
        devices=D,
        ckpt_dir=str(tmp_path),
        save_buffer=True,
        log=lambda s: None,
    )
    state = init_pipeline(game, cfg)
    state, _ = run_generation(game, state, cfg)
    assert state.sp_carry is not None
    assert int(np.asarray(state.sp_carry.count).sum()) > 0

    # restore exactly like cli.py --resume --devices D
    tmpl = make_carry(game, cfg.selfplay.num_games, jax.random.key(0))
    kd = jax.random.key_data(tmpl.rng)
    tmpl = tmpl._replace(rng=jnp.zeros((D,) + kd.shape, kd.dtype))
    resumed = init_pipeline(game, cfg)
    manifest, loaded = ckpt.load_checkpoint(
        cfg.ckpt_dir,
        best_params=resumed.best_params,
        train_params=resumed.train_params,
        opt_state=resumed.opt_state,
        rng=jax.random.key_data(resumed.rng),
        buffer=resumed.buffer,
        sp_carry=tmpl,
    )
    assert manifest["has_carry"]
    want = state.sp_carry._replace(
        rng=jax.random.key_data(state.sp_carry.rng))
    for a, b in zip(jax.tree.leaves(loaded["sp_carry"]),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    resumed.best_params = loaded["best"]
    resumed.train_params = loaded["train"]
    resumed.opt_state = loaded["opt"]
    resumed.rng = jax.random.wrap_key_data(loaded["rng"])
    resumed.buffer = loaded["buffer"]
    resumed.sp_carry = loaded["sp_carry"]._replace(
        rng=jax.random.wrap_key_data(loaded["sp_carry"].rng))
    resumed.elo = manifest["elo"]
    resumed.generation = manifest["generation"]
    resumed.best_generation = manifest["best_generation"]

    live = copy.copy(state)
    live, s_live = run_generation(game, live, cfg)
    resumed, s_res = run_generation(game, resumed, cfg)
    for k in ("samples_written", "carried", "wins", "draws", "losses",
              "games_finished", "unfinished", "loss", "duel", "elo",
              "generation"):
        assert np.all(np.asarray(s_live[k]) == np.asarray(s_res[k])), k
    for a, b in zip(jax.tree.leaves(live.buffer),
                    jax.tree.leaves(resumed.buffer)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
