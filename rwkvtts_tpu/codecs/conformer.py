"""Upsample conformer/transformer encoder for the CosyVoice flow stack.

Functional JAX port of the reference's wenet-style encoder
(behavioral parity sources, /root/reference):
  * UpsampleConformerEncoder: third_party/cosyvoice/transformer/upsample_encoder.py:105-331
  * ConformerEncoderLayer:    third_party/cosyvoice/transformer/encoder_layer.py:109-240
  * RelPositionMultiHeadedAttention + espnet rel-shift:
                              third_party/cosyvoice/transformer/attention.py:200-330
  * EspnetRelPositionalEncoding: third_party/cosyvoice/transformer/embedding.py:201-296
  * LinearNoSubsampling:      third_party/cosyvoice/transformer/subsampling.py:69-114
  * PreLookaheadLayer / Upsample1D: upsample_encoder.py:37-104

The deployed configs (model/flow/train_sfm_flow.yaml:32-45; CosyVoice2
release yaml) use macaron_style=False, use_cnn_module=False, so each layer
is: x += attn(LN(x)); x += ffn(LN(x)) with relative-position attention.

The rel-shift trick is replaced by a direct relative-index gather, which
XLA lowers to one take_along_axis — simpler and fusion-friendly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.codecs import nn

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class UpsampleConformerConfig:
    input_size: int = 512
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    num_up_blocks: int = 4
    pre_lookahead_len: int = 3
    up_stride: int = 2


# ---------------------------------------------------------------------------
# Relative positional encoding (espnet style)


def espnet_rel_pos(T: int, d_model: int) -> np.ndarray:
    """(1, 2T-1, d) positive-then-negative relative encodings
    (embedding.py:224-254)."""
    position = np.arange(T, dtype=np.float32)[:, None]
    div = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model)
    )
    pe_pos = np.zeros((T, d_model), np.float32)
    pe_pos[:, 0::2] = np.sin(position * div)
    pe_pos[:, 1::2] = np.cos(position * div)
    pe_neg = np.zeros((T, d_model), np.float32)
    pe_neg[:, 0::2] = np.sin(-position * div)
    pe_neg[:, 1::2] = np.cos(-position * div)
    pe = np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)  # (2T-1, d)
    return pe[None]


# ---------------------------------------------------------------------------
# Rel-pos multi-headed attention


def rel_attention_init(key, d_model, heads):
    ks = jax.random.split(key, 6)
    dk = d_model // heads
    bound = math.sqrt(6.0 / (heads * dk + dk))  # xavier_uniform on (h, d_k)
    return {
        "q": nn.linear_init(ks[0], d_model, d_model),
        "k": nn.linear_init(ks[1], d_model, d_model),
        "v": nn.linear_init(ks[2], d_model, d_model),
        "out": nn.linear_init(ks[3], d_model, d_model),
        "pos": nn.linear_init(ks[4], d_model, d_model, bias=False),
        "pos_bias_u": jax.random.uniform(ks[5], (heads, dk), minval=-bound, maxval=bound),
        "pos_bias_v": jax.random.uniform(ks[5], (heads, dk), minval=-bound, maxval=bound),
    }


def rel_attention(p: Params, x, pos_emb, heads: int, mask=None):
    """x: (B, T, D); pos_emb: (1, 2T-1, D); mask: (B, T, T) bool or None."""
    B, T, D = x.shape
    dk = D // heads
    q = nn.linear(p["q"], x).reshape(B, T, heads, dk)
    k = nn.linear(p["k"], x).reshape(B, T, heads, dk).transpose(0, 2, 1, 3)
    v = nn.linear(p["v"], x).reshape(B, T, heads, dk).transpose(0, 2, 1, 3)
    pe = nn.linear(p["pos"], pos_emb).reshape(1, -1, heads, dk).transpose(0, 2, 1, 3)

    q_u = (q + p["pos_bias_u"]).transpose(0, 2, 1, 3)  # (B, H, T, dk)
    q_v = (q + p["pos_bias_v"]).transpose(0, 2, 1, 3)

    ac = jnp.einsum("bhid,bhjd->bhij", q_u, k)
    bd_full = jnp.einsum("bhid,bhjd->bhij", q_v, pe)  # (B, H, T, 2T-1)
    # rel-shift as a direct gather: out[i, j] = bd[i, (T-1) - i + j]
    idx = (T - 1) - jnp.arange(T)[:, None] + jnp.arange(T)[None, :]
    bd = jnp.take_along_axis(
        bd_full, jnp.broadcast_to(idx, (B, heads, T, T)), axis=-1
    )
    scores = (ac + bd) / math.sqrt(dk)
    if mask is not None:
        scores = jnp.where(mask[:, None, :, :], scores, -jnp.inf)
    attn = jax.nn.softmax(scores, axis=-1)
    if mask is not None:
        attn = jnp.where(mask[:, None, :, :], attn, 0.0)
    out = jnp.einsum("bhij,bhjd->bhid", attn, v)
    out = out.transpose(0, 2, 1, 3).reshape(B, T, D)
    return nn.linear(p["out"], out)


# ---------------------------------------------------------------------------
# Encoder layer (attention + FFN, pre-norm)


def encoder_layer_init(key, d_model, heads, linear_units):
    ks = jax.random.split(key, 3)
    return {
        "attn": rel_attention_init(ks[0], d_model, heads),
        "ff_w1": nn.linear_init(ks[1], d_model, linear_units),
        "ff_w2": nn.linear_init(ks[2], linear_units, d_model),
        "norm_mha": nn.layer_norm_init(d_model),
        "norm_ff": nn.layer_norm_init(d_model),
    }


def encoder_layer(p: Params, x, pos_emb, heads, mask=None):
    h = nn.layer_norm(p["norm_mha"], x, eps=1e-12)
    x = x + rel_attention(p["attn"], h, pos_emb, heads, mask)
    h = nn.layer_norm(p["norm_ff"], x, eps=1e-12)
    # swish activation (wenet default for conformer FFN)
    h = nn.linear(p["ff_w1"], h)
    h = h * jax.nn.sigmoid(h)
    x = x + nn.linear(p["ff_w2"], h)
    return x


# ---------------------------------------------------------------------------
# Upsample conformer encoder


def init_params(key, cfg: UpsampleConformerConfig) -> Params:
    ks = jax.random.split(key, cfg.num_blocks + cfg.num_up_blocks + 8)
    d = cfg.output_size
    return {
        "embed": {
            "linear": nn.linear_init(ks[0], cfg.input_size, d),
            "ln": nn.layer_norm_init(d),
        },
        "lookahead": {
            "conv1": nn.conv1d_init(ks[1], d, d, cfg.pre_lookahead_len + 1),
            "conv2": nn.conv1d_init(ks[2], d, d, 3),
        },
        "encoders": [
            encoder_layer_init(ks[3 + i], d, cfg.attention_heads, cfg.linear_units)
            for i in range(cfg.num_blocks)
        ],
        "up_conv": nn.conv1d_init(ks[3 + cfg.num_blocks], d, d, cfg.up_stride * 2 + 1),
        "up_embed": {
            "linear": nn.linear_init(ks[4 + cfg.num_blocks], cfg.input_size, d),
            "ln": nn.layer_norm_init(d),
        },
        "up_encoders": [
            encoder_layer_init(
                ks[5 + cfg.num_blocks + i], d, cfg.attention_heads, cfg.linear_units
            )
            for i in range(cfg.num_up_blocks)
        ],
        "after_norm": nn.layer_norm_init(d),
    }


def _embed(p: Params, x, d_model: int):
    """LinearNoSubsampling + espnet rel-pos scaling."""
    h = nn.linear(p["linear"], x)
    h = nn.layer_norm(p["ln"], h, eps=1e-5)
    h = h * math.sqrt(d_model)
    pos = jnp.asarray(espnet_rel_pos(h.shape[1], d_model))
    return h, pos


def pre_lookahead(p: Params, x, pre_lookahead_len: int, context=None):
    """(B, T, C): lookahead conv (right-pad or context splice) + causal conv
    + residual (upsample_encoder.py:81-104)."""
    if context is None:
        h = jnp.pad(x, ((0, 0), (0, pre_lookahead_len), (0, 0)))
    else:
        h = jnp.concatenate([x, context[:, :pre_lookahead_len]], axis=1)
    h = nn.leaky_relu(nn.conv1d(p["conv1"], h, padding=0), 0.01)
    h = jnp.pad(h, ((0, 0), (2, 0), (0, 0)))
    h = nn.conv1d(p["conv2"], h, padding=0)
    return h + x


def apply(
    p: Params,
    cfg: UpsampleConformerConfig,
    x,
    mask: Optional[jax.Array] = None,
    context: Optional[jax.Array] = None,
) -> jax.Array:
    """x: (B, T, input_size) -> (B, T*up_stride, output_size).

    mask: (B, T) 1/0 padding mask (full attention within valid region —
    offline path; streaming chunk masks are built by the caller).
    """
    d = cfg.output_size
    h, pos = _embed(p["embed"], x, d)
    attn_mask = None
    if mask is not None:
        attn_mask = (mask[:, None, :] > 0) & (mask[:, :, None] > 0)
    h = pre_lookahead(p["lookahead"], h, cfg.pre_lookahead_len, context)
    for lyr in p["encoders"]:
        h = encoder_layer(lyr, h, pos, cfg.attention_heads, attn_mask)

    # upsample: nearest-repeat x2 then left-padded conv (Upsample1D)
    h = jnp.repeat(h, cfg.up_stride, axis=1)
    h = jnp.pad(h, ((0, 0), (cfg.up_stride * 2, 0), (0, 0)))
    h = nn.conv1d(p["up_conv"], h, padding=0)

    h, pos_up = _embed(p["up_embed"], h, d)
    attn_mask_up = None
    if mask is not None:
        mask_up = jnp.repeat(mask, cfg.up_stride, axis=1)
        attn_mask_up = (mask_up[:, None, :] > 0) & (mask_up[:, :, None] > 0)
    for lyr in p["up_encoders"]:
        h = encoder_layer(lyr, h, pos_up, cfg.attention_heads, attn_mask_up)
    return nn.layer_norm(p["after_norm"], h, eps=1e-5)
