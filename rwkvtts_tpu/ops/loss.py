"""Loss functions.

The reference trains with rwkv-fla's FusedLinearCrossEntropyLoss (no logits
materialized; reference spark_llm.py:139-160). Here the same memory profile
is achieved by chunking the time axis and rematerializing: logits for each
time-chunk are computed, reduced to (loss, z-stats), and freed — XLA fuses
the hidden@W_head matmul with the log-softmax reduction per chunk.

Also here: label-smoothing KL loss (reference cosy_llm.py:47-52 via
cosyvoice's LabelSmoothingLoss) and the L2Wrap max-logit regularizer
(reference rwkv_asr_cuda_whisper.py:338-350) expressed as an explicit
auxiliary loss term (its gradient equals the reference's injected gradient).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

IGNORE_INDEX = -100


def _chunk_ce(hidden, w_head, bias, labels, valid, smoothing=0.0):
    """CE (optionally label-smoothed KL) for one time-chunk. hidden (M, C),
    labels (M,). Returns (sum_loss, sum_maxlogit_sq); invalid positions
    contribute zero."""
    # matmul in the input dtype (bf16 tensor cores) with fp32 accumulation;
    # all softmax statistics stay fp32
    logits = jnp.matmul(hidden, w_head, preferred_element_type=jnp.float32)
    if bias is not None:
        logits = logits + bias.astype(jnp.float32)
    V = logits.shape[-1]
    lse = jax.scipy.special.logsumexp(logits, axis=-1)
    lab = jnp.clip(labels, 0)
    picked = jnp.take_along_axis(logits, lab[:, None], axis=-1)[:, 0]
    if smoothing:
        # KL(t || p) with t = (1-e) on gold, e/(V-1) elsewhere — matches the
        # cosyvoice LabelSmoothingLoss (KLDivLoss incl. target entropy).
        conf = 1.0 - smoothing
        off = smoothing / max(V - 1, 1)
        logp_gold = picked - lse
        sum_logp = logits.sum(axis=-1) - V * lse
        _log = lambda v: math.log(v) if v > 0 else 0.0
        t_logt = conf * _log(conf) + (V - 1) * off * _log(off)
        loss = t_logt - (conf * logp_gold + off * (sum_logp - logp_gold))
    else:
        loss = lse - picked
    nll = jnp.where(valid, loss, 0.0)
    maxlogit = jnp.max(logits, axis=-1)
    max_sq = jnp.where(valid, maxlogit * maxlogit, 0.0)
    return nll.sum(), max_sq.sum()


def fused_linear_cross_entropy(
    hidden: jax.Array,
    w_head: jax.Array,
    labels: jax.Array,
    bias: Optional[jax.Array] = None,
    *,
    ignore_index: int = IGNORE_INDEX,
    chunk: int = 1024,
    l2_wrap: float = 0.0,
    shift: bool = False,
    smoothing: float = 0.0,
    normalize_length: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Mean CE over valid labels without materializing full (B,T,V) logits.

    hidden: (B, T, C); w_head: (C, V); labels: (B, T) int32.
    If shift, predicts labels[t+1] from hidden[t] (HF-style internal shift,
    reference spark_llm.py:156). smoothing>0 gives the label-smoothing KL
    (cosyvoice LabelSmoothingLoss semantics); normalize_length=False divides
    by batch size instead of token count.
    Returns (loss, n_valid). If l2_wrap > 0 adds l2_wrap/(2*B*T) * sum(max_logit^2),
    whose gradient matches the reference L2Wrap hook.
    """
    B, T, C = hidden.shape
    if shift:
        hidden = hidden[:, :-1]
        labels = labels[:, 1:]
        T = T - 1
    M = B * T
    h = hidden.reshape(M, C)
    lab = labels.reshape(M)
    valid = lab != ignore_index

    pad = (-M) % chunk
    if pad:
        h = jnp.pad(h, ((0, pad), (0, 0)))
        lab = jnp.pad(lab, (0, pad))
        valid = jnp.pad(valid, (0, pad))
    n_chunks = (M + pad) // chunk

    body = jax.checkpoint(
        functools.partial(
            _chunk_ce, w_head=w_head, bias=bias, smoothing=smoothing
        )
    )

    def scan_fn(acc, xs):
        hc, lc, vc = xs
        s, m2 = body(hc, labels=lc, valid=vc)
        return (acc[0] + s, acc[1] + m2), None

    xs = (
        h.reshape(n_chunks, chunk, C),
        lab.reshape(n_chunks, chunk),
        valid.reshape(n_chunks, chunk),
    )
    (total, max_sq), _ = jax.lax.scan(scan_fn, (0.0, 0.0), xs)
    n_valid = valid.sum()
    denom = jnp.maximum(n_valid, 1) if normalize_length else B
    loss = total / denom
    if l2_wrap > 0.0:
        loss = loss + (l2_wrap / (2.0 * M)) * max_sq
    return loss, n_valid


def cross_entropy(
    logits: jax.Array,
    labels: jax.Array,
    *,
    ignore_index: int = IGNORE_INDEX,
) -> Tuple[jax.Array, jax.Array]:
    """Plain mean CE on materialized logits (..., V)."""
    logits = logits.astype(jnp.float32)
    valid = labels != ignore_index
    lab = jnp.clip(labels, 0)
    lse = jax.scipy.special.logsumexp(logits, axis=-1)
    picked = jnp.take_along_axis(logits, lab[..., None], axis=-1)[..., 0]
    nll = jnp.where(valid, lse - picked, 0.0)
    n = valid.sum()
    return nll.sum() / jnp.maximum(n, 1), n


def label_smoothing_loss(
    logits: jax.Array,
    labels: jax.Array,
    *,
    smoothing: float = 0.0,
    ignore_index: int = IGNORE_INDEX,
    normalize_length: bool = True,
) -> jax.Array:
    """KL(label-smoothed target || softmax(logits)), cosyvoice-style.

    logits (..., V); labels (...). With smoothing e and vocab V, target is
    (1-e) on the gold id and e/(V-1) elsewhere.
    """
    logits = logits.astype(jnp.float32)
    V = logits.shape[-1]
    valid = labels != ignore_index
    lab = jnp.clip(labels, 0)
    logp = jax.nn.log_softmax(logits, axis=-1)
    conf = 1.0 - smoothing
    off = smoothing / max(V - 1, 1)
    # KL(t||p) = sum t*log t - sum t*log p; the entropy term is constant and
    # torch's KLDivLoss with log-input omits nothing, so keep both terms.
    t_logt = conf * jnp.log(jnp.maximum(conf, 1e-20)) + (V - 1) * off * jnp.log(
        jnp.maximum(off, 1e-20)
    )
    picked = jnp.take_along_axis(logp, lab[..., None], axis=-1)[..., 0]
    t_logp = conf * picked + off * (logp.sum(axis=-1) - picked)
    kl = jnp.where(valid, t_logt - t_logp, 0.0)
    denom = jnp.maximum(valid.sum(), 1) if normalize_length else kl.shape[0]
    return kl.sum() / denom


def accuracy(logits: jax.Array, labels: jax.Array, ignore_index=IGNORE_INDEX):
    """th_accuracy equivalent: argmax accuracy over valid positions."""
    pred = jnp.argmax(logits, axis=-1)
    valid = labels != ignore_index
    correct = jnp.where(valid, pred == labels, False)
    return correct.sum() / jnp.maximum(valid.sum(), 1)
