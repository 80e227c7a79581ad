"""Vectorized segment packing.

The reference builds multi-segment prompts ([instr][audio][hints][answer],
[text][audio], ...) with host-side per-sample Python loops + pad_sequence
(model/llm/rwkv_asr.py:92-130, model/llm/rwkv_tts.py:47-80). Here that
becomes a right-aligned scatter computed inside jit: per-segment cumsum
ranks, one scatter per tensor, static shapes, GSPMD-compatible.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp


def right_align_pack(
    segments: Sequence[Tuple[jax.Array, jax.Array, Optional[jax.Array]]],
    T_total: int,
):
    """Pack (emb, mask, labels?) segments right-aligned by valid count.

    segments: list of (emb (B, L_k, C), mask (B, L_k), labels (B, L_k)|None).
    Returns (packed_emb (B, T_total, C), packed_mask (B, T_total) int32,
    packed_labels (B, T_total) int32 with -100 fill).
    """
    B, _, C = segments[0][0].shape
    v = [jnp.sum(m.astype(jnp.int32), axis=1) for (_, m, _) in segments]
    out_emb = jnp.zeros((B, T_total + 1, C), segments[0][0].dtype)
    out_mask = jnp.zeros((B, T_total + 1), jnp.int32)
    out_lab = jnp.full((B, T_total + 1), -100, jnp.int32)
    n = len(segments)
    bidx = jnp.arange(B)[:, None]
    for k, (emb, mask, lab) in enumerate(segments):
        mask_i = mask.astype(jnp.int32)
        suffix = sum(v[j] for j in range(k, n))  # (B,)
        rank = jnp.cumsum(mask_i, axis=1) - 1
        dest = T_total - suffix[:, None] + rank
        # Invalid positions AND overflow (total valid > T_total would make
        # dest negative, and JAX scatter would silently wrap) both go to the
        # dump slot at index T_total, which is cropped off on return.
        dest = jnp.where((mask_i > 0) & (dest >= 0), dest, T_total)
        out_emb = out_emb.at[bidx, dest].set(emb)
        out_mask = out_mask.at[bidx, dest].set(mask_i)
        if lab is not None:
            out_lab = out_lab.at[bidx, dest].set(jnp.where(mask_i > 0, lab, -100))
    return out_emb[:, :T_total], out_mask[:, :T_total], out_lab[:, :T_total]
