"""Command-line entry point.

Reference equivalent: the five `main*.jl` entry scripts + their ArgParse
tables (main4IARow.jl:88-143).  The six reference flags are kept with the
same names and defaults; everything the reference hard-codes at point of
use (duel size, temperature cutoffs, buffer capacity, net width/depth,
lr/weight-decay, ...) is promoted to a flag here (SURVEY.md section 5,
config/flag system).

Usage:
    python -m alphatpu.cli --game connect4 --samples 32768 --rollout 64 \
        --generation 100 --batchsize 8192 --cpuct 1.5
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="alphatpu", description="AlphaZero training on one or more GPUs"
    )
    p.add_argument("--game", default="connect4",
                   help="tictactoe | connect4 | gobang<N> | hex<N> | "
                        "reversi6x6 | reversi8x8")
    # --- the reference's six flags (README.md:25-44) ---
    p.add_argument("--samples", type=int, default=None,
                   help="selfplay games per generation (default: the "
                        "per-game reference default - 16384 for reversi8x8, "
                        "mainReversi8x8.jl:94, else 32768)")
    p.add_argument("--rollout", type=int, default=64,
                   help="MCTS rollouts per move")
    p.add_argument("--generation", type=int, default=100,
                   help="number of generations")
    p.add_argument("--batchsize", type=int, default=2 * 4096,
                   help="SGD batch size")
    p.add_argument("--cpuct", type=float, default=1.5,
                   help="exploration coefficient")
    p.add_argument("--noise", type=float, default=None,
                   help="accepted for reference CLI parity; the root mix is "
                        "the hard-coded 0.75/0.25 of the reference "
                        "(mcts_gpu.jl:273) and this flag is ignored there too")
    # --- promoted hard-coded constants ---
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--depth", type=int, default=None,
                   help="residual tower depth (default: per-game reference)")
    p.add_argument("--buffer-capacity", type=int, default=2_000_000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--feature-weight", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--duel-games", type=int, default=1024)
    p.add_argument("--duel-rollouts", type=int, default=32)
    p.add_argument("--continuous", action="store_true",
                   help="continuous selfplay: --samples parallel lanes play "
                        "back-to-back games for --rounds move rounds "
                        "(finished lanes recycle instantly)")
    p.add_argument("--rounds", type=int, default=None,
                   help="move rounds per lane in --continuous mode "
                        "(default 2x the game's max length)")
    p.add_argument("--bf16-inference", action="store_true",
                   help="evaluate the in-search net in bfloat16 (training "
                        "stays f32)")
    p.add_argument("--fresh-root-policy", action="store_true",
                   help="recompute the root policy after the final backup "
                        "instead of returning the last pre-backup policy "
                        "(the reference discards the final backup's "
                        "information, mcts_gpu.jl:330-339)")
    p.add_argument("--temp-moves", type=int, default=25)
    p.add_argument("--duel-temp-moves", type=int, default=15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (default Data<game>/)")
    p.add_argument("--no-checkpoint", action="store_true")
    p.add_argument("--save-buffer", action="store_true",
                   help="include the replay buffer in checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --ckpt-dir")
    p.add_argument("--devices", type=int, default=1,
                   help="shard selfplay lanes, replay buffer, learner and "
                        "duels over this many devices (0 = all available, "
                        "1 = single-device path)")
    p.add_argument("--multihost", action="store_true",
                   help="call jax.distributed.initialize() before building "
                        "the mesh: run one process per host under your "
                        "launcher and pass --devices 0 to span every "
                        "device of every process")
    p.add_argument("--coordinator", default=None,
                   help="with --multihost: coordinator address host:port "
                        "(default: auto-detect from the cluster environment)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="with --multihost: total process count (default: "
                        "auto-detect)")
    p.add_argument("--process-id", type=int, default=None,
                   help="with --multihost: this process's rank (default: "
                        "auto-detect)")
    p.add_argument("--stats-file", default=None,
                   help="append per-generation stats as JSON lines")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of the first "
                        "generation into this directory (in place of the "
                        "reference's per-stage timers, "
                        "mcts_gpu.jl:377-459)")
    return p


def default_samples(game_name: str) -> int:
    """The reference's per-game --samples default: 16384 for Reversi 8x8
    (mainReversi8x8.jl:94), 32768 everywhere else (main4IARow.jl:93)."""
    return 16384 if game_name == "reversi8x8" else 32768


def make_pipeline_config(args, game):
    from functools import partial

    import jax.numpy as jnp

    from .duel import DuelConfig
    from .nets import apply_inference
    from .pipeline import PipelineConfig
    from .selfplay import SelfplayConfig
    from .train import TrainConfig

    net_apply = (
        partial(apply_inference, compute_dtype=jnp.bfloat16)
        if args.bf16_inference else apply_inference
    )
    samples = args.samples or default_samples(args.game)
    return PipelineConfig(
        selfplay=SelfplayConfig(
            num_games=samples,
            rollouts=args.rollout,
            cpuct=args.cpuct,
            temp_moves=args.temp_moves,
            continuous=args.continuous,
            rounds=args.rounds,
            fresh_root_policy=args.fresh_root_policy,
        ),
        train=TrainConfig(
            batch_size=args.batchsize,
            lr=args.lr,
            weight_decay=args.weight_decay,
            feature_weight=args.feature_weight,
            epochs=args.epochs,
        ),
        duel=DuelConfig(
            num_games=args.duel_games,
            rollouts=args.duel_rollouts,
            temp_moves=args.duel_temp_moves,
        ),
        buffer_capacity=args.buffer_capacity,
        generations=args.generation,
        seed=args.seed,
        width=args.width,
        depth=args.depth,
        ckpt_dir=None if args.no_checkpoint else (
            args.ckpt_dir or f"Data{args.game}"
        ),
        save_buffer=args.save_buffer,
        net_apply=net_apply,
        devices=args.devices,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    from .runtime import setup_compile_cache

    setup_compile_cache()
    if args.multihost:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    from .games import make_game
    from .pipeline import init_pipeline, run_generation

    game = make_game(args.game)
    cfg = make_pipeline_config(args, game)
    D = cfg.num_devices()
    print(f"alphatpu: game={game.name} devices={jax.devices()}"
          + (f"  (dp mesh over {D})" if D > 1 else ""))
    state = init_pipeline(game, cfg)

    if args.resume and cfg.ckpt_dir and os.path.exists(
        os.path.join(cfg.ckpt_dir, "latest.json")
    ):
        from . import checkpoint as ckpt

        carry_tmpl = None
        if args.continuous and args.save_buffer:
            # exact-resume of in-flight episodes.  The carry's array leaves
            # are global [G, ...] regardless of the mesh; only the rng leaf
            # differs: a single key at D == 1, a stacked key per device at
            # D > 1 (pipeline.run_generation's device_keys).  Build the
            # template with the matching [D, *key_data] shape so a sharded
            # run resumes its in-flight episodes exactly like a
            # single-device one (no dropped episodes; the mesh resharding
            # happens on the next sp_fn call).  NB resume requires the
            # same --devices count the checkpoint was written with.
            import jax.numpy as jnp

            from .selfplay import make_carry

            c = make_carry(game, cfg.selfplay.num_games, state.rng)
            kd = jax.random.key_data(c.rng)
            if D > 1:
                kd = jnp.zeros((D,) + kd.shape, kd.dtype)
            carry_tmpl = c._replace(rng=kd)
        manifest, loaded = ckpt.load_checkpoint(
            cfg.ckpt_dir,
            best_params=state.best_params,
            train_params=state.train_params,
            opt_state=state.opt_state,
            rng=jax.random.key_data(state.rng),
            buffer=state.buffer if args.save_buffer else None,
            sp_carry=carry_tmpl,
        )
        state.best_params = loaded["best"]
        state.train_params = loaded["train"]
        state.opt_state = loaded["opt"]
        state.rng = jax.random.wrap_key_data(loaded["rng"])
        if "buffer" in loaded:
            state.buffer = loaded["buffer"]
        if "sp_carry" in loaded:
            state.sp_carry = loaded["sp_carry"]._replace(
                rng=jax.random.wrap_key_data(loaded["sp_carry"].rng))
        state.elo = manifest["elo"]
        state.generation = manifest["generation"]
        state.best_generation = manifest["best_generation"]
        print(f"resumed at generation {state.generation}, elo {state.elo:.1f}")

    t0 = time.time()
    first_gen = True
    while state.generation < cfg.generations:
        if args.profile_dir and first_gen:
            with jax.profiler.trace(args.profile_dir):
                state, stats = run_generation(game, state, cfg)
            print(f"profiler trace written to {args.profile_dir}")
        else:
            state, stats = run_generation(game, state, cfg)
        first_gen = False
        if args.stats_file:
            with open(args.stats_file, "a") as f:
                f.write(json.dumps(stats, default=float) + "\n")
    print(f"done: {cfg.generations} generations in {time.time() - t0:.0f}s; "
          f"best generation {state.best_generation}, elo {state.elo:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
