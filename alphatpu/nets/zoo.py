"""Network zoo: alternative architectures behind the same (params, x) ->
(policy_logits, value) contract as :mod:`alphatpu.nets.mlp`.

Reference equivalent: the DenseNet.jl variant collection (SURVEY.md #17) -
`resnet`/`resnetb`/`resnetd` two-layer residual blocks (DenseNet.jl:45-87),
`resnetbatch` with BatchNorm (DenseNet.jl:13-26), the conv-input variant
`ressimplec` (DenseNet.jl:89-120), the value-only `networkq`
(DenseNet.jl:200-218) and the recurrent-policy `network_rec`
(DenseNet.jl:236-265).  Those are experimental and unused by the reference
training path; here each is a small functional pytree that can be swapped
into the engine via ``make_net`` (the search and learner only need the
``apply`` contract).

Convs run NHWC; the recurrent
variant uses a ``lax.scan`` GRU (static trip count, no Python loops).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .mlp import NetConfig, apply_inference as mlp_apply, init_params as mlp_init


def _glorot(key, shape, dtype=jnp.float32):
    return jax.nn.initializers.glorot_uniform()(key, shape, dtype)


# ---- two-layer residual MLP (reference resnet/resnetb/resnetd) ----


def init_res2(key, cfg: NetConfig):
    k0, k1, k2, kp, kv = jax.random.split(key, 5)
    keys1 = jax.random.split(k1, cfg.depth)
    keys2 = jax.random.split(k2, cfg.depth)
    return {
        "base": _glorot(k0, (cfg.in_dim, cfg.width)),
        "res_a": jnp.stack([_glorot(k, (cfg.width, cfg.width)) for k in keys1]),
        "res_b": jnp.stack([_glorot(k, (cfg.width, cfg.width)) for k in keys2]),
        "policy_w": _glorot(kp, (cfg.width, cfg.actions)),
        "policy_b": jnp.zeros((cfg.actions,)),
        "value_w": _glorot(kv, (cfg.width, 1)),
        "value_b": jnp.zeros((1,)),
    }


def apply_res2(params, x):
    b = jax.nn.relu(jnp.dot(x, params["base"]))

    def block(b, ws):
        wa, wb = ws
        h = jax.nn.relu(jnp.dot(b, wa))
        h = jnp.dot(h, wb)
        return jax.nn.relu(b + h), None

    b, _ = jax.lax.scan(block, b, (params["res_a"], params["res_b"]))
    logits = jnp.dot(b, params["policy_w"]) + params["policy_b"]
    value = jax.nn.sigmoid(jnp.dot(b, params["value_w"]) + params["value_b"])
    return logits, value[..., 0]


# ---- residual MLP with layer normalization (reference resnetbatch;
# LayerNorm instead of BatchNorm - no cross-batch state to carry through
# the in-search jit, same normalization role) ----


def init_norm(key, cfg: NetConfig):
    p = init_res2(key, cfg)
    p["scale"] = jnp.ones((cfg.depth, cfg.width))
    p["bias"] = jnp.zeros((cfg.depth, cfg.width))
    return p


def apply_norm(params, x):
    b = jax.nn.relu(jnp.dot(x, params["base"]))

    def block(b, ws):
        wa, wb, sc, bi = ws
        h = jax.nn.relu(jnp.dot(b, wa))
        h = jnp.dot(h, wb)
        h = b + h
        mu = h.mean(-1, keepdims=True)
        var = h.var(-1, keepdims=True)
        h = (h - mu) * jax.lax.rsqrt(var + 1e-5) * sc + bi
        return jax.nn.relu(h), None

    b, _ = jax.lax.scan(
        block, b,
        (params["res_a"], params["res_b"], params["scale"], params["bias"]),
    )
    logits = jnp.dot(b, params["policy_w"]) + params["policy_b"]
    value = jax.nn.sigmoid(jnp.dot(b, params["value_w"]) + params["value_b"])
    return logits, value[..., 0]


# ---- conv tower (reference ressimplec): input reshaped to NHWC planes ----


def make_conv_net(game, channels: int = 64, depth: int = 4):
    """(init, apply) for a conv-tower net on this game's board geometry.
    The board dims are static closure state (shapes must be static under
    jit); the plane encoding [mover cells; opponent cells] reshapes to
    NHWC."""
    rows = getattr(getattr(game, "spec", None), "rows", None) or game.n
    cols = getattr(getattr(game, "spec", None), "cols", None) or game.n
    A = game.max_actions
    C, D = channels, depth
    flat = rows * cols * C

    def init(key, cfg: NetConfig | None = None):
        k0, k1, kp, kv = jax.random.split(key, 4)
        keys = jax.random.split(k1, D)
        return {
            "stem": _glorot(k0, (3, 3, 2, C)),
            "convs": jnp.stack([_glorot(k, (3, 3, C, C)) for k in keys]),
            "policy_w": _glorot(kp, (flat, A)),
            "policy_b": jnp.zeros((A,)),
            "value_w": _glorot(kv, (flat, 1)),
            "value_b": jnp.zeros((1,)),
        }

    def apply(params, x):
        B = x.shape[0]
        # cells are stored column-major (cell = r + rows*c): [2, cols, rows]
        img = x.reshape(B, 2, cols, rows).transpose(0, 3, 2, 1)  # NHWC

        def conv(h, w):
            dn = jax.lax.conv_dimension_numbers(
                h.shape, w.shape, ("NHWC", "HWIO", "NHWC")
            )
            return jax.lax.conv_general_dilated(
                h, w, (1, 1), "SAME", dimension_numbers=dn
            )

        h = jax.nn.relu(conv(img, params["stem"]))

        def block(h, w):
            return jax.nn.relu(h + conv(h, w)), None

        h, _ = jax.lax.scan(block, h, params["convs"])
        flat_h = h.reshape(B, -1)
        logits = jnp.dot(flat_h, params["policy_w"]) + params["policy_b"]
        value = jax.nn.sigmoid(
            jnp.dot(flat_h, params["value_w"]) + params["value_b"]
        )
        return logits, value[..., 0]

    return init, apply


# ---- value-only net (reference networkq) ----


def init_value_only(key, cfg: NetConfig):
    k0, k1, kv = jax.random.split(key, 3)
    keys = jax.random.split(k1, cfg.depth)
    return {
        "base": _glorot(k0, (cfg.in_dim, cfg.width)),
        "res": jnp.stack([_glorot(k, (cfg.width, cfg.width)) for k in keys]),
        "value_w": _glorot(kv, (cfg.width, 1)),
        "value_b": jnp.zeros((1,)),
        "policy_b": jnp.zeros((cfg.actions,)),  # uniform-prior placeholder
    }


def apply_value_only(params, x):
    """Returns (uniform logits, value) - policy comes out flat so the
    search degenerates to value-guided exploration (reference networkq)."""
    b = jax.nn.relu(jnp.dot(x, params["base"]))

    def block(b, w):
        return jax.nn.relu(b + jax.nn.relu(jnp.dot(b, w))), None

    b, _ = jax.lax.scan(block, b, params["res"])
    value = jax.nn.sigmoid(jnp.dot(b, params["value_w"]) + params["value_b"])
    logits = jnp.broadcast_to(
        params["policy_b"], x.shape[:-1] + params["policy_b"].shape
    )
    return logits, value[..., 0]


# ---- recurrent-policy net (reference network_rec, LSTM policy head;
# here a GRU over a fixed number of "thought steps") ----


def init_recurrent(key, cfg: NetConfig):
    k0, kz, kr, kh, kp, kv = jax.random.split(key, 6)
    W = cfg.width
    return {
        "base": _glorot(k0, (cfg.in_dim, W)),
        "gru_z": _glorot(kz, (2 * W, W)),
        "gru_r": _glorot(kr, (2 * W, W)),
        "gru_h": _glorot(kh, (2 * W, W)),
        "policy_w": _glorot(kp, (W, cfg.actions)),
        "policy_b": jnp.zeros((cfg.actions,)),
        "value_w": _glorot(kv, (W, 1)),
        "value_b": jnp.zeros((1,)),
    }


def apply_recurrent(params, x, steps: int = 3):
    h = jax.nn.relu(jnp.dot(x, params["base"]))
    inp = h

    def step(h, _):
        hx = jnp.concatenate([h, inp], axis=-1)
        z = jax.nn.sigmoid(jnp.dot(hx, params["gru_z"]))
        r = jax.nn.sigmoid(jnp.dot(hx, params["gru_r"]))
        hc = jnp.tanh(
            jnp.dot(jnp.concatenate([r * h, inp], -1), params["gru_h"])
        )
        return (1 - z) * h + z * hc, None

    h, _ = jax.lax.scan(step, h, None, length=steps)
    logits = jnp.dot(h, params["policy_w"]) + params["policy_b"]
    value = jax.nn.sigmoid(jnp.dot(h, params["value_w"]) + params["value_b"])
    return logits, value[..., 0]


# ---- registry ----

ZOO = {
    "mlp": (mlp_init, mlp_apply),
    "res2": (init_res2, apply_res2),
    "norm": (init_norm, apply_norm),
    "value_only": (init_value_only, apply_value_only),
    "recurrent": (init_recurrent, apply_recurrent),
}


def make_net(name: str, key, cfg: NetConfig):
    """(params, apply) for a zoo architecture by name."""
    init, apply = ZOO[name]
    return init(key, cfg), apply
