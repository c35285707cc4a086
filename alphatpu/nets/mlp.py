"""AlphaZero residual MLP as a functional pytree.

The equivalent of the reference's `ressimplesf` training net
(DenseNet.jl:161-197) and its raw-array inference twin `snetwork2`
(DenseNet.jl:279-316).  One parameter pytree serves both roles - there is no
Flux->CuArray `convert_back` weight transfer (DenseNet.jl:331-341) because
jit compiles the same pure function for both paths.

Architecture (matching the reference exactly):
* base: Dense(in -> width), relu, NO bias (DenseNet.jl:195)
* tower: depth x residual blocks  b = relu(b + relu(b @ W_r)), no bias
  (DenseNet.jl:27-43 `resnets`, DenseNet.jl:294-299)
* policy head: Dense(width -> actions) with bias, raw logits
* value head: Dense(width -> 1) with bias, sigmoid  (value in [0, 1])
* feature head: Dense(width -> fsize) with bias, tanh - training only
  (the auxiliary final-state prediction loss, train.jl:12-15)

Weights are [in, out] so the games batch stays the leading axis of every
matmul.  Compute dtype is configurable: bf16 matmuls with f32 accumulation
(``--bf16-inference``) or f32 for inference, f32 for training.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import jax
import jax.numpy as jnp


class NetConfig(NamedTuple):
    in_dim: int
    actions: int
    fsize: int
    width: int = 512
    depth: int = 4  # 4 C4/Reversi6, 6 Gobang, 8 Hex/Reversi8 (main*.jl:123-128)


def init_params(key, cfg: NetConfig, dtype=jnp.float32) -> Dict[str, Any]:
    """Glorot-uniform weights, zero biases (Flux Dense defaults)."""
    k_base, k_res, k_p, k_v, k_f = jax.random.split(key, 5)
    glorot = jax.nn.initializers.glorot_uniform()
    res_keys = jax.random.split(k_res, cfg.depth)
    return {
        "base": glorot(k_base, (cfg.in_dim, cfg.width), dtype),
        "res": jnp.stack(
            [glorot(k, (cfg.width, cfg.width), dtype) for k in res_keys]
        ),
        "policy_w": glorot(k_p, (cfg.width, cfg.actions), dtype),
        "policy_b": jnp.zeros((cfg.actions,), dtype),
        "value_w": glorot(k_v, (cfg.width, 1), dtype),
        "value_b": jnp.zeros((1,), dtype),
        "feature_w": glorot(k_f, (cfg.width, cfg.fsize), dtype),
        "feature_b": jnp.zeros((cfg.fsize,), dtype),
    }


def _trunk(params, x, compute_dtype):
    """Activations *stay* in compute_dtype through the tower (matmuls
    accumulate in f32, outputs round back down), so with bf16 the trunk
    moves half the bytes per layer - the analogue of the reference's
    --math-mode=fast launch flag (README.md:23).  Under the default matmul
    precision an f32 product may itself run as TF32 on the GPU."""
    h = x.astype(compute_dtype)
    b = jax.nn.relu(
        jnp.dot(h, params["base"].astype(compute_dtype),
                preferred_element_type=jnp.float32)
    ).astype(compute_dtype)
    # Tower is a scan over stacked residual weights: one traced matmul
    # regardless of depth (vs. the reference's unrolled Julia loop).
    res = params["res"].astype(compute_dtype)

    def block(b, w):
        inner = jax.nn.relu(
            jnp.dot(b, w, preferred_element_type=jnp.float32)
        ).astype(compute_dtype)
        return jax.nn.relu(b + inner), None

    b, _ = jax.lax.scan(block, b, res)
    return b


def apply_inference(params, x, compute_dtype=jnp.float32):
    """(policy_logits, value) - the in-search evaluation path
    (reference snetwork2 forward, DenseNet.jl:294-304)."""
    b = _trunk(params, x, compute_dtype)
    logits = (
        jnp.dot(b, params["policy_w"].astype(b.dtype),
                preferred_element_type=jnp.float32)
        + params["policy_b"]
    )
    value = jax.nn.sigmoid(
        jnp.dot(b, params["value_w"].astype(b.dtype),
                preferred_element_type=jnp.float32)
        + params["value_b"]
    )
    return logits, value[..., 0]


def apply_training(params, x):
    """(policy_logits, value, feature) - the SGD path
    (reference networkf training forward, DenseNet.jl:173-189)."""
    b = _trunk(params, x, jnp.float32)
    logits = jnp.dot(b, params["policy_w"]) + params["policy_b"]
    value = jax.nn.sigmoid(jnp.dot(b, params["value_w"]) + params["value_b"])
    feature = jnp.tanh(jnp.dot(b, params["feature_w"]) + params["feature_b"])
    return logits, value[..., 0], feature


def config_for_game(game, width: int = 512, depth: int | None = None) -> NetConfig:
    """Reference per-game sizes: 512x4 Connect-4/Reversi6 (main4IARow.jl:123),
    512x6 Gobang (mainGobang.jl:128), 512x8 Hex/Reversi8 (mainHex.jl:128);
    README.md:16 quotes 128x6 for TicTacToe."""
    if depth is None:
        name = game.name
        if name == "tictactoe":
            width, depth = 128, 6
        elif name.startswith("gobang"):
            depth = 6
        elif name.startswith("hex") or name == "reversi8x8":
            depth = 8
        else:
            depth = 4
    return NetConfig(
        in_dim=2 * game.vectorized_state,
        actions=game.max_actions,
        fsize=game.feature_size,
        width=width,
        depth=depth,
    )
