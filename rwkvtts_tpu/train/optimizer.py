"""Optimizer groups + LR schedule (optax).

Reference policy (train_scripts/train_spark_rwkv7speech_jsonl_with_properties.py:160-242):
  * AdamW betas (0.9, 0.95), eps 1e-18
  * weight decay only on >=2-D non-LoRA matrices
  * 2x learning rate for the decay-LoRA bias (att.w0 — rwkvfla names it
    `attn.w_lora.lora.2.bias`)
  * per-step LR: linear warmup then cosine from peak to final
"""
from __future__ import annotations

import re
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax


def lr_schedule(
    peak_lr: float,
    final_lr: float,
    warmup_steps: int,
    total_steps: int,
):
    def fn(step):
        step = jnp.asarray(step, jnp.float32)
        warm = peak_lr * step / jnp.maximum(warmup_steps, 1)
        t = (step - warmup_steps) / jnp.maximum(total_steps - warmup_steps, 1)
        t = jnp.clip(t, 0.0, 1.0)
        cos = final_lr + 0.5 * (peak_lr - final_lr) * (1 + jnp.cos(jnp.pi * t))
        return jnp.where(step < warmup_steps, warm, cos)

    return fn


_LORA_PAT = re.compile(r"att/(w1|w2|a1|a2|v1|v2|g1|g2|x_[rwkvag])$")
_LR2X_PAT = re.compile(r"att/w0$")


def _path_str(path) -> str:
    parts = []
    for p in path:
        parts.append(str(getattr(p, "key", getattr(p, "idx", p))))
    return "/".join(parts)


def param_group_label(path: str, leaf) -> str:
    if _LR2X_PAT.search(path):
        return "lr2x"
    # stacked block leaves have a leading layer axis; "matrix" means the
    # per-layer view is >= 2-D
    per_layer_ndim = leaf.ndim - 1 if path.startswith("blocks/") else leaf.ndim
    if per_layer_ndim >= 2 and not _LORA_PAT.search(path):
        return "decay"
    return "nodecay"


def group_labels(params) -> Any:
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: param_group_label(_path_str(path), leaf), params
    )


def build_optimizer(
    params,
    peak_lr: float = 1e-4,
    final_lr: float = 1e-5,
    warmup_steps: int = 1000,
    total_steps: int = 100_000,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-18,
    grad_clip: Optional[float] = 1.0,
    low_memory: Optional[str] = None,
) -> optax.GradientTransformation:
    """AdamW with the reference's group policy (see module docstring).

    ``low_memory`` swaps the moment estimator while keeping the LR groups,
    schedule, and weight-decay mask identical — the single-host answer to
    the reference's ZeRO-3 CPU-offload for its 1.5B LM
    (train_..._properties.py:377-387); on several cards the first choice
    is fsdp sharding (parallel/mesh.py), but one card may not hold fp32
    Adam state beside the rest (1.4B params: 5.7 GB weights + 11.4 GB
    moments):
      * "mu_bf16":   first moment stored bf16 (halves mu memory; update
                     math still fp32 — optax casts per-step)
      * "adafactor": factored second moment, no first moment
                     (optax.scale_by_factored_rms; state is O(rows+cols))
    """
    sched = lr_schedule(peak_lr, final_lr, warmup_steps, total_steps)
    sched2x = lr_schedule(2 * peak_lr, 2 * final_lr, warmup_steps, total_steps)

    def adamw(schedule, wd):
        if low_memory == "adafactor":
            scale = optax.scale_by_factored_rms(decay_rate=b2)
        elif low_memory == "mu_bf16":
            scale = optax.scale_by_adam(
                b1=b1, b2=b2, eps=eps, mu_dtype=jnp.bfloat16
            )
        elif low_memory is None:
            scale = optax.scale_by_adam(b1=b1, b2=b2, eps=eps)
        else:
            raise ValueError(f"unknown low_memory mode: {low_memory!r}")
        return optax.chain(
            scale,
            optax.add_decayed_weights(wd) if wd else optax.identity(),
            optax.scale_by_schedule(lambda s: -schedule(s)),
        )

    tx = optax.multi_transform(
        {
            "decay": adamw(sched, weight_decay),
            "nodecay": adamw(sched, 0.0),
            "lr2x": adamw(sched2x, 0.0),
        },
        group_labels(params),
    )
    if grad_clip:
        tx = optax.chain(optax.clip_by_global_norm(grad_clip), tx)
    return tx
