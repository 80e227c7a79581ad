"""Functional NN building blocks for the audio-codec stacks.

Everything is channels-last (B, T, C)
and pure-functional: params are plain nested dicts, apply functions are
jittable with static config.

Behavioral parity sources (reference, /root/reference — behavior only):
  * Snake / ResidualUnit / WNConv:    third_party/sparktts/modules/blocks/layers.py
  * ConvNeXt / VocosBackbone / AdaLN: third_party/sparktts/modules/blocks/vocos.py
  * SamplingBlock:                    third_party/sparktts/modules/blocks/samper.py
  * PerceiverResampler / Attention:   third_party/sparktts/modules/speaker/perceiver_encoder.py

Weight-norm note: the reference folds weight norm away at load time
(bicodec.py:remove_weight_norm); we store only the folded weights, so a
"WNConv" here is just a conv whose weights came from a folded g·v/|v|.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

Params = Dict[str, Any]

_CONV_DN = ("NHC", "HIO", "NHC")  # (B,T,C) x (K,Cin/g,Cout) -> (B,T,C)


# ---------------------------------------------------------------------------
# Initializers


def trunc_normal(key, shape, std=0.02, dtype=jnp.float32):
    return std * jax.random.truncated_normal(key, -2.0, 2.0, shape, dtype)


def _linear_init(key, in_dim, out_dim, bias=True, std=None):
    # torch nn.Linear default: U(-1/sqrt(in), 1/sqrt(in))
    kw, kb = jax.random.split(key)
    bound = 1.0 / math.sqrt(in_dim)
    w = jax.random.uniform(kw, (in_dim, out_dim), minval=-bound, maxval=bound)
    p = {"w": w}
    if bias:
        p["b"] = jax.random.uniform(kb, (out_dim,), minval=-bound, maxval=bound)
    return p


def linear_init(key, in_dim, out_dim, bias=True):
    return _linear_init(key, in_dim, out_dim, bias)


def linear(p: Params, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Conv1d (channels-last) + transposed conv


def conv1d_init(key, in_ch, out_ch, kernel, groups=1, bias=True, std=None):
    kw, kb = jax.random.split(key)
    fan_in = (in_ch // groups) * kernel
    if std is None:
        bound = 1.0 / math.sqrt(fan_in)
        w = jax.random.uniform(
            kw, (kernel, in_ch // groups, out_ch), minval=-bound, maxval=bound
        )
    else:
        w = trunc_normal(kw, (kernel, in_ch // groups, out_ch), std=std)
    p = {"w": w}
    if bias:
        bound = 1.0 / math.sqrt(fan_in)
        p["b"] = jax.random.uniform(kb, (out_ch,), minval=-bound, maxval=bound)
    return p


def conv1d(
    p: Params,
    x,
    stride: int = 1,
    padding="SAME_TORCH",
    dilation: int = 1,
    groups: int = 1,
):
    """1-D conv on (B, T, C). `padding` is an int (symmetric, torch-style),
    a (lo, hi) pair, or "SAME_TORCH" meaning torch's `padding=(K-1)*d//2`."""
    k = p["w"].shape[0]
    if padding == "SAME_TORCH":
        pad = ((k - 1) * dilation) // 2
        padding = (pad, pad)
    elif isinstance(padding, int):
        padding = (padding, padding)
    y = jax.lax.conv_general_dilated(
        x,
        p["w"].astype(x.dtype),
        window_strides=(stride,),
        padding=(padding,),
        rhs_dilation=(dilation,),
        dimension_numbers=_CONV_DN,
        feature_group_count=groups,
    )
    if "b" in p:
        y = y + p["b"].astype(x.dtype)
    return y


def conv_transpose1d_init(key, in_ch, out_ch, kernel, groups=1, bias=True):
    # stored already in forward-conv layout (K, Cin/groups, Cout)
    kw, kb = jax.random.split(key)
    fan_in = (in_ch // groups) * kernel  # torch CT fan_in uses in_channels
    bound = 1.0 / math.sqrt(fan_in)
    w = jax.random.uniform(
        kw, (kernel, in_ch // groups, out_ch), minval=-bound, maxval=bound
    )
    p = {"w": w}
    if bias:
        p["b"] = jax.random.uniform(kb, (out_ch,), minval=-bound, maxval=bound)
    return p


def conv_transpose1d(
    p: Params,
    x,
    stride: int,
    padding: int = 0,
    output_padding: int = 0,
    dilation: int = 1,
    groups: int = 1,
):
    """Transposed conv with torch ConvTranspose1d length semantics:
    out = (T-1)*stride - 2*padding + dilation*(K-1) + output_padding + 1.

    Implemented as a fractionally-strided conv (lhs_dilation) — XLA lowers
    this to a gather+matmul, no scatter. The kernel is stored
    pre-flipped in forward layout (K, Cin/g, Cout); torch_import handles the
    flip/transpose from torch's (Cin, Cout/g, K).
    """
    k = p["w"].shape[0]
    lo = dilation * (k - 1) - padding
    hi = dilation * (k - 1) - padding + output_padding
    y = jax.lax.conv_general_dilated(
        x,
        p["w"].astype(x.dtype),
        window_strides=(1,),
        padding=((lo, hi),),
        lhs_dilation=(stride,),
        rhs_dilation=(dilation,),
        dimension_numbers=_CONV_DN,
        feature_group_count=groups,
    )
    if "b" in p:
        y = y + p["b"].astype(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms / activations


def layer_norm_init(dim):
    return {"g": jnp.ones((dim,)), "b": jnp.zeros((dim,))}


def layer_norm(p: Params, x, eps: float = 1e-6):
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    xn = (x - mu) * jax.lax.rsqrt(var + eps)
    return xn * p["g"] + p["b"]


def ada_layer_norm_init(key, cond_dim, dim):
    k1, k2 = jax.random.split(key)
    scale = _linear_init(k1, cond_dim, dim)
    shift = _linear_init(k2, cond_dim, dim)
    # reference init: scale.weight = ones, shift.weight = zeros (vocos.py AdaLayerNorm)
    scale["w"] = jnp.ones_like(scale["w"])
    shift["w"] = jnp.zeros_like(shift["w"])
    return {"scale": scale, "shift": shift}


def ada_layer_norm(p: Params, x, cond, eps: float = 1e-6):
    """x: (B, T, C); cond: (B, D)."""
    scale = linear(p["scale"], cond)[:, None, :]
    shift = linear(p["shift"], cond)[:, None, :]
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    xn = (x - mu) * jax.lax.rsqrt(var + eps)
    return xn * scale + shift


def batch_norm_init(dim):
    return {
        "g": jnp.ones((dim,)),
        "b": jnp.zeros((dim,)),
        "mean": jnp.zeros((dim,)),
        "var": jnp.ones((dim,)),
    }


def batch_norm(p: Params, x, eps: float = 1e-5):
    """Inference-mode batch norm over the channel (last) axis."""
    inv = jax.lax.rsqrt(p["var"] + eps) * p["g"]
    return (x - p["mean"]) * inv + p["b"]


def rms_norm_init(dim):
    return {"g": jnp.ones((dim,))}


def rms_norm_l2(p: Params, x):
    """The perceiver RMSNorm variant: F.normalize(x) * sqrt(d) * gamma."""
    d = x.shape[-1]
    xn = x * jax.lax.rsqrt(jnp.sum(x * x, axis=-1, keepdims=True) + 1e-24)
    return xn * math.sqrt(d) * p["g"]


def snake_init(dim):
    return {"alpha": jnp.ones((dim,))}


def snake(p: Params, x):
    """snake(x) = x + sin^2(alpha*x)/(alpha+1e-9), per-channel alpha."""
    a = p["alpha"]
    return x + jnp.sin(a * x) ** 2 / (a + 1e-9)


def gelu(x):
    return jax.nn.gelu(x, approximate=False)


def leaky_relu(x, slope=0.2):
    return jnp.where(x >= 0, x, slope * x)


# ---------------------------------------------------------------------------
# ConvNeXt / Vocos backbone


def convnext_block_init(key, dim, intermediate_dim, layer_scale, cond_dim=None):
    ks = jax.random.split(key, 4)
    p = {
        "dwconv": conv1d_init(ks[0], dim, dim, 7, groups=dim, std=0.02),
        "pw1": _linear_init(ks[1], dim, intermediate_dim),
        "pw2": _linear_init(ks[2], intermediate_dim, dim),
    }
    # reference re-inits conv/linear with trunc_normal(0.02), zero bias
    p["pw1"]["w"] = trunc_normal(ks[1], (dim, intermediate_dim))
    p["pw1"]["b"] = jnp.zeros((intermediate_dim,))
    p["pw2"]["w"] = trunc_normal(ks[2], (intermediate_dim, dim))
    p["pw2"]["b"] = jnp.zeros((dim,))
    p["dwconv"]["b"] = jnp.zeros((dim,))
    if cond_dim is not None:
        p["norm"] = ada_layer_norm_init(ks[3], cond_dim, dim)
    else:
        p["norm"] = layer_norm_init(dim)
    if layer_scale > 0:
        p["gamma"] = jnp.full((dim,), layer_scale)
    return p


def convnext_block(p: Params, x, cond=None):
    res = x
    x = conv1d(p["dwconv"], x, groups=x.shape[-1])
    if cond is not None:
        x = ada_layer_norm(p["norm"], x, cond)
    else:
        x = layer_norm(p["norm"], x)
    x = linear(p["pw1"], x)
    x = gelu(x)
    x = linear(p["pw2"], x)
    if "gamma" in p:
        x = p["gamma"] * x
    return res + x


def vocos_backbone_init(
    key, input_channels, dim, intermediate_dim, num_layers,
    layer_scale=None, cond_dim=None,
):
    ks = jax.random.split(key, num_layers + 2)
    layer_scale = layer_scale if layer_scale is not None else 1.0 / num_layers
    p = {
        "embed": conv1d_init(ks[0], input_channels, dim, 7, std=0.02),
        "blocks": [
            convnext_block_init(ks[i + 1], dim, intermediate_dim, layer_scale, cond_dim)
            for i in range(num_layers)
        ],
        "final_ln": layer_norm_init(dim),
    }
    p["embed"]["b"] = jnp.zeros((dim,))
    if cond_dim is not None:
        p["norm"] = ada_layer_norm_init(ks[-1], cond_dim, dim)
    else:
        p["norm"] = layer_norm_init(dim)
    return p


def vocos_backbone(p: Params, x, cond=None):
    """x: (B, T, C_in) -> (B, T, dim)."""
    x = conv1d(p["embed"], x)
    if cond is not None:
        x = ada_layer_norm(p["norm"], x, cond)
    else:
        x = layer_norm(p["norm"], x)
    for blk in p["blocks"]:
        x = convnext_block(blk, x, cond)
    return layer_norm(p["final_ln"], x)


# ---------------------------------------------------------------------------
# Sampling block (up/down), faithful to samper.py including the 3x identity sum


def sampling_block_init(key, dim, groups=1, upsample_scale=1, downsample_scale=1):
    p: Params = {}
    if upsample_scale > 1:
        p["deconv"] = conv_transpose1d_init(
            key, dim, dim, upsample_scale * 2, groups=groups
        )
    if downsample_scale > 1:
        p["conv"] = conv1d_init(key, dim, dim, 2 * downsample_scale, groups=groups)
    return p


def sampling_block(p: Params, x, dim, groups=1, upsample_scale=1, downsample_scale=1):
    """x: (B, T, C) -> (B, T', C). Mirrors SamplingBlock.forward: the three
    branches are summed, so scale-1 blocks multiply the input by 3."""
    if upsample_scale > 1:
        repeat_res = jnp.repeat(x, upsample_scale, axis=1)
        deconv_res = conv_transpose1d(
            p["deconv"],
            leaky_relu(x, 0.2),
            stride=upsample_scale,
            padding=upsample_scale // 2 + upsample_scale % 2,
            output_padding=upsample_scale % 2,
            groups=groups,
        )
        upmerge = repeat_res + deconv_res
    else:
        upmerge = x
        repeat_res = x

    if downsample_scale > 1:
        conv_res = conv1d(
            p["conv"],
            leaky_relu(upmerge, 0.2),
            stride=downsample_scale,
            padding=downsample_scale // 2 + downsample_scale % 2,
            groups=groups,
        )
        T = upmerge.shape[1] // downsample_scale * downsample_scale
        skip2 = jnp.mean(
            upmerge[:, :T].reshape(
                upmerge.shape[0], -1, downsample_scale, upmerge.shape[2]
            ),
            axis=2,
        )
        skip1 = jnp.mean(
            repeat_res[:, :T].reshape(
                repeat_res.shape[0], -1, downsample_scale, repeat_res.shape[2]
            ),
            axis=2,
        )
        # torch avg_pool1d floors; conv output length floors the same way,
        # but conv with its padding can be one longer — crop to match.
        L = min(conv_res.shape[1], skip2.shape[1])
        return conv_res[:, :L] + skip1[:, :L] + skip2[:, :L]
    # downsample <= 1: conv_res = skip2 = upmerge, skip1 = repeat_res
    return 2 * upmerge + repeat_res


# ---------------------------------------------------------------------------
# Attention + perceiver resampler (speaker encoder)


def attention_init(key, dim, dim_context=None, heads=8, dim_head=64):
    dim_context = dim_context or dim
    inner = heads * dim_head
    k1, k2, k3 = jax.random.split(key, 3)
    return {
        "to_q": _linear_init(k1, dim, inner, bias=False),
        "to_kv": _linear_init(k2, dim_context, inner * 2, bias=False),
        "to_out": _linear_init(k3, inner, dim, bias=False),
    }


def attention(p: Params, x, context=None, heads=8, include_queries=False):
    """x: (B, N, D); context: (B, M, Dc). Non-causal, no mask (codec use)."""
    ctx = x if context is None else context
    if context is not None and include_queries:
        ctx = jnp.concatenate([x, ctx], axis=1)
    q = linear(p["to_q"], x)
    kv = linear(p["to_kv"], ctx)
    k, v = jnp.split(kv, 2, axis=-1)

    B, N, _ = q.shape
    M = k.shape[1]
    dh = q.shape[-1] // heads
    q = q.reshape(B, N, heads, dh).transpose(0, 2, 1, 3)
    k = k.reshape(B, M, heads, dh).transpose(0, 2, 1, 3)
    v = v.reshape(B, M, heads, dh).transpose(0, 2, 1, 3)
    sim = jnp.einsum("bhnd,bhmd->bhnm", q, k) / math.sqrt(dh)
    attn = jax.nn.softmax(sim, axis=-1)
    out = jnp.einsum("bhnm,bhmd->bhnd", attn, v)
    out = out.transpose(0, 2, 1, 3).reshape(B, N, heads * dh)
    return linear(p["to_out"], out)


def geglu_ff_init(key, dim, mult=4):
    inner = int(dim * mult * 2 / 3)
    k1, k2 = jax.random.split(key)
    return {
        "in": _linear_init(k1, dim, inner * 2),
        "out": _linear_init(k2, inner, dim),
    }


def geglu_ff(p: Params, x):
    h = linear(p["in"], x)
    a, gate = jnp.split(h, 2, axis=-1)
    return linear(p["out"], gelu(gate) * a)


def perceiver_resampler_init(
    key, dim, dim_context, num_latents=32, depth=2, heads=8, dim_head=64, ff_mult=4
):
    ks = jax.random.split(key, 2 * depth + 2)
    p: Params = {
        "latents": 0.02 * jax.random.normal(ks[0], (num_latents, dim)),
        "layers": [
            {
                "attn": attention_init(ks[2 * i + 1], dim, dim, heads, dim_head),
                "ff": geglu_ff_init(ks[2 * i + 2], dim, ff_mult),
            }
            for i in range(depth)
        ],
        "norm": rms_norm_init(dim),
    }
    if dim_context != dim:
        p["proj_context"] = _linear_init(ks[-1], dim_context, dim)
    return p


def perceiver_resampler(p: Params, x, heads=8):
    """x: (B, T, dim_context) -> (B, num_latents, dim)."""
    if "proj_context" in p:
        x = linear(p["proj_context"], x)
    lat = jnp.broadcast_to(p["latents"], (x.shape[0],) + p["latents"].shape)
    for lyr in p["layers"]:
        lat = attention(lyr["attn"], lat, x, heads=heads, include_queries=True) + lat
        lat = geglu_ff(lyr["ff"], lat) + lat
    return rms_norm_l2(p["norm"], lat)
