"""alphatpu - an AlphaZero framework in JAX (XLA, Pallas, shard_map).

Built from scratch with the capabilities of fabricerosay/AlphaGPU (Julia +
CUDA.jl), re-designed as array programs: thousands of games step in lockstep as
batched array programs under jit; the MCTS tree lives in SoA device arrays;
self-play, replay buffer and SGD stay on-device in one actor-learner loop;
the games axis shards across devices via `jax.sharding` / `shard_map`.
"""

__version__ = "0.1.0"

from . import bitboard, games  # noqa: F401
