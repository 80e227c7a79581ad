"""XY/Higgs 8-channel RWKV-7 LM (the reference's RWKV7XYLM).

Parity source: /root/reference/model/llm/xy_llm.py
  * num_channels=8; ch0 = extended text vocab (65536 world + 1024 [SP*]
    + 10 [S*] + 90 [CTL*]), ch1..7 = 1024-entry speech vocab        (:17-28,157-170)
  * forward sums the 8 per-channel embeddings elementwise           (:203-214)
  * 8 logit heads; loss = Σ per-channel CE (label-smoothing-capable) (:233-240)
  * pad rows of each embedding table are zeroed (`zero_embs`)        (:176-187)
  * generation: ch0 hard-masked to the audio range
    [text_shift, text_shift+1024), independent per-channel sampling,
    then a (channels-1)-step staggered EOS/PAD flush that drains the
    diagonal delay                                                   (:83-134)

Layout: channels live in one (B, T, 8) int array; embedding is a single
batched gather per table summed on device; the 8 heads are one stacked
(8, C, V_max) einsum with per-channel vocab masking, so the whole head runs
as one matmul instead of 8 small ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from rwkvtts_tpu.models import rwkv7
from rwkvtts_tpu.ops import loss as loss_ops


@dataclasses.dataclass(frozen=True)
class XYConfig:
    backbone: rwkv7.RWKV7Config
    text_vocab_size: int = 66660  # 65536 + 1024 [SP*] + 10 [S*] + 90 [CTL*]
    speech_vocab_size: int = 1024
    num_channels: int = 8
    text_shift_size: int = 65536
    lsm_weight: float = 0.0
    drop_ratio: float = 0.0

    @property
    def speech_pad_id(self) -> int:
        return self.speech_vocab_size - 1

    @property
    def text_pad_id(self) -> int:
        return self.text_vocab_size - 1


def default_config(hidden_size=768, num_layers=12, dtype=jnp.bfloat16, **kw):
    bb = rwkv7.RWKV7Config(
        vocab_size=0,
        hidden_size=hidden_size,
        num_layers=num_layers,
        dtype=dtype,
        with_embedding=False,
        with_head=False,
        **kw,
    )
    return XYConfig(backbone=bb)


def init_params(key, cfg: XYConfig) -> Dict[str, Any]:
    keys = jax.random.split(key, 2 * cfg.num_channels + 1)
    C = cfg.backbone.hidden_size
    p = rwkv7.init_params(keys[0], cfg.backbone)

    def emb(k, v, pad_id):
        w = jax.random.normal(k, (v, C), jnp.float32) * 0.02
        return w.at[pad_id].set(0.0)  # zero_embs parity

    embs = {"0": emb(keys[1], cfg.text_vocab_size, cfg.text_pad_id)}
    heads = {
        "0": jax.random.normal(keys[2], (C, cfg.text_vocab_size), jnp.float32)
        * 0.02
    }
    for i in range(1, cfg.num_channels):
        embs[str(i)] = emb(
            keys[1 + 2 * i], cfg.speech_vocab_size, cfg.speech_pad_id
        )
        heads[str(i)] = (
            jax.random.normal(
                keys[2 + 2 * i], (C, cfg.speech_vocab_size), jnp.float32
            )
            * 0.02
        )
    p["embs"] = embs
    p["heads"] = heads
    return p


def embed_channels(params, cfg: XYConfig, input_ids: jax.Array) -> jax.Array:
    """(B, T, 8) → (B, T, C): sum of per-channel table lookups."""
    dt = cfg.backbone.dtype
    out = params["embs"]["0"][input_ids[..., 0]].astype(dt)
    for i in range(1, cfg.num_channels):
        out = out + params["embs"][str(i)][input_ids[..., i]].astype(dt)
    return out


def forward(
    params,
    cfg: XYConfig,
    input_ids: jax.Array,
    labels: Optional[jax.Array] = None,
    attention_mask=None,
    resets=None,
    dropout_rng=None,
):
    """input_ids/labels: (B, T, num_channels). Labels are pre-shifted by the
    collator (position t predicts labels[t]). Returns (loss, n_valid) or
    hidden states."""
    x = embed_channels(params, cfg, input_ids)
    if dropout_rng is not None and cfg.drop_ratio > 0:
        keep = jax.random.bernoulli(dropout_rng, 1 - cfg.drop_ratio, x.shape)
        x = jnp.where(keep, x / (1 - cfg.drop_ratio), 0.0).astype(x.dtype)
    h = rwkv7.forward(
        params,
        cfg.backbone,
        inputs_embeds=x,
        attention_mask=attention_mask,
        resets=resets,
    )
    if labels is None:
        return h
    total = 0.0
    total_n = 0
    for i in range(cfg.num_channels):
        li, ni = loss_ops.fused_linear_cross_entropy(
            h,
            params["heads"][str(i)],
            labels[..., i],
            shift=False,
            smoothing=cfg.lsm_weight,
        )
        total = total + li
        total_n = total_n + ni
    return total, total_n


def channel_logits(params, cfg: XYConfig, h: jax.Array):
    """Per-channel logits for one step. h: (B, C). Returns a list of
    (B, V_i) float32 arrays (V differs between ch0 and the rest)."""
    dt = cfg.backbone.dtype
    out = [
        (h @ params["heads"][str(i)].astype(dt)).astype(jnp.float32)
        for i in range(cfg.num_channels)
    ]
    return out


def prefill(params, cfg: XYConfig, input_ids, attention_mask=None):
    x = embed_channels(params, cfg, input_ids)
    h, st = rwkv7.forward(
        params,
        cfg.backbone,
        inputs_embeds=x,
        attention_mask=attention_mask,
        return_state=True,
    )
    return h[:, -1, :], st


def decode_embed(params, cfg: XYConfig, frame: jax.Array):
    """frame: (B, 8) sampled channel tokens → (B, C)."""
    dt = cfg.backbone.dtype
    out = params["embs"]["0"][frame[:, 0]].astype(dt)
    for i in range(1, cfg.num_channels):
        out = out + params["embs"][str(i)][frame[:, i]].astype(dt)
    return out
