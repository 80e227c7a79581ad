"""Spark-TTS RWKV-7 speech LM (the reference's RWKV7ForSpeech).

Parity source: /root/reference/model/llm/spark_llm.py
  * vocab_size = 8193 (8192 BiCodec semantic codes + EOS id 8192)  (:26)
  * text_embedder 65536×C, global_embedder 4096×C, tts_tag_embedder 3×C (:28-31)
  * input dropout 0.02 during training (:34,124-125)
  * training loss = fused linear CE with internal label shift (:139-160)

Redesign: the reference's collators concatenate *embeddings* on
device per sample (utils/multiple_jsonl.py:34-54). Here collators are
host-side token-domain functions (data/spark.py) producing
(tokens, modality) int arrays; the embedding concat happens inside the
jitted model as four table gathers selected by modality — static shapes,
no host↔device chatter, works under GSPMD unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from rwkvtts_tpu.models import rwkv7
from rwkvtts_tpu.ops import loss as loss_ops

# Modality codes used by collators and embed_layout.
MOD_PAD = 0
MOD_TEXT = 1
MOD_GLOBAL = 2
MOD_TAG = 3
MOD_SEMANTIC = 4

# tts_tag_embedder rows (reference spark_llm.py:30-31 usage in
# utils/multiple_jsonl.py:29-31): 0=GLOBAL, 1=SEMANTIC, 2=START_TTS.
TAG_GLOBAL = 0
TAG_SEMANTIC = 1
TAG_START_TTS = 2


@dataclasses.dataclass(frozen=True)
class SparkTTSConfig:
    backbone: rwkv7.RWKV7Config
    text_vocab_size: int = 65536
    audio_global_vocab_size: int = 4096
    dropout: float = 0.02

    @property
    def semantic_vocab_size(self) -> int:  # incl. EOS
        return self.backbone.vocab_size

    @property
    def eos_token_id(self) -> int:
        return self.backbone.vocab_size - 1  # 8192


def default_config(
    hidden_size=768, num_layers=12, dtype=jnp.bfloat16, dropout=0.02, **kw
) -> SparkTTSConfig:
    bb = rwkv7.RWKV7Config(
        vocab_size=8193,
        hidden_size=hidden_size,
        num_layers=num_layers,
        dtype=dtype,
        **kw,
    )
    return SparkTTSConfig(backbone=bb, dropout=dropout)


def init_params(key, cfg: SparkTTSConfig) -> Dict[str, Any]:
    k0, k1, k2, k3 = jax.random.split(key, 4)
    C = cfg.backbone.hidden_size
    p = rwkv7.init_params(k0, cfg.backbone)
    emb = lambda k, v: jax.random.normal(k, (v, C), jnp.float32) * 0.02
    p["text_embedder"] = emb(k1, cfg.text_vocab_size)
    p["global_embedder"] = emb(k2, cfg.audio_global_vocab_size)
    p["tts_tag_embedder"] = emb(k3, 3)
    return p


def embed_layout(
    params, cfg: SparkTTSConfig, tokens: jax.Array, modality: jax.Array
) -> jax.Array:
    """(B,T) ids + (B,T) modality codes → (B,T,C) embeddings.

    Four gathers + select; pad positions embed to zero.
    """
    dt = cfg.backbone.dtype
    clip = lambda tbl, n: params[tbl][jnp.clip(tokens, 0, n - 1)].astype(dt)
    text = clip("text_embedder", cfg.text_vocab_size)
    glob = clip("global_embedder", cfg.audio_global_vocab_size)
    tag = clip("tts_tag_embedder", 3)
    sem = clip("embedding", cfg.semantic_vocab_size)
    m = modality[..., None]
    out = jnp.where(m == MOD_TEXT, text, 0.0)
    out = jnp.where(m == MOD_GLOBAL, glob, out)
    out = jnp.where(m == MOD_TAG, tag, out)
    out = jnp.where(m == MOD_SEMANTIC, sem, out)
    return out


def forward(
    params,
    cfg: SparkTTSConfig,
    tokens: jax.Array,
    modality: jax.Array,
    labels: Optional[jax.Array] = None,
    attention_mask: Optional[jax.Array] = None,
    resets: Optional[jax.Array] = None,
    dropout_rng: Optional[jax.Array] = None,
    l2_wrap: float = 0.0,
):
    """Training/eval forward. With labels → (loss, n_valid); else hidden."""
    x = embed_layout(params, cfg, tokens, modality)
    if dropout_rng is not None and cfg.dropout > 0:
        keep = jax.random.bernoulli(dropout_rng, 1 - cfg.dropout, x.shape)
        x = jnp.where(keep, x / (1 - cfg.dropout), 0.0).astype(x.dtype)
    h = rwkv7.forward(
        params,
        cfg.backbone,
        inputs_embeds=x,
        attention_mask=attention_mask,
        resets=resets,
    )
    if labels is None:
        return h
    return loss_ops.fused_linear_cross_entropy(
        h, params["head"], labels, shift=True, l2_wrap=l2_wrap
    )


# ---------------------------------------------------------------------------
# Generation-side helpers (prefill + per-step embedding); the jitted decode
# loop itself lives in infer/generate.py.
# ---------------------------------------------------------------------------


def prefill(
    params, cfg: SparkTTSConfig, tokens, modality, attention_mask=None
) -> Tuple[jax.Array, Any]:
    """Run the prompt; returns (last_hidden (B,C), model state)."""
    x = embed_layout(params, cfg, tokens, modality)
    h, st = rwkv7.forward(
        params,
        cfg.backbone,
        inputs_embeds=x,
        attention_mask=attention_mask,
        return_state=True,
    )
    return h[:, -1, :], st


def decode_embed(params, cfg: SparkTTSConfig, token_ids: jax.Array):
    """Embedding of a sampled semantic token (B,) → (B,C)."""
    return params["embedding"][token_ids].astype(cfg.backbone.dtype)
