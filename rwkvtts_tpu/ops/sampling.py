"""On-device sampling: temperature / top-k / top-p, fully jittable.

The reference samples on host inside HF's generate loop or with a
vectorized torch sampler (reference rwkv_asr_cuda_whisper.py:525-571).
Here everything stays on device so the autoregressive decode loop never
round-trips to the host (SURVEY.md §7 hard-part #3).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

NEG_INF = -1e30


def apply_temperature(logits: jax.Array, temperature) -> jax.Array:
    t = jnp.maximum(jnp.asarray(temperature, jnp.float32), 1e-6)
    return logits.astype(jnp.float32) / t


def top_k_mask(logits: jax.Array, k: int) -> jax.Array:
    """Keep the k largest logits per row; mask the rest to -inf. Static k."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = jax.lax.top_k(logits, k)[0][..., -1:]
    return jnp.where(logits < kth, NEG_INF, logits)


def top_p_mask(logits: jax.Array, p) -> jax.Array:
    """Nucleus filtering. Keeps the smallest prefix of the sorted
    distribution with cumulative probability >= p (token at the crossing
    point included, matching torch semantics)."""
    sorted_logits = jnp.sort(logits, axis=-1)[..., ::-1]
    probs = jax.nn.softmax(sorted_logits, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    # number of tokens kept = first index where cum >= p, inclusive; the
    # argmax always survives (torch keeps >= 1 token, so p<=0 == greedy)
    first = jax.lax.broadcasted_iota(
        jnp.int32, sorted_logits.shape, sorted_logits.ndim - 1
    ) == 0
    keep_sorted = (cum - probs < p) | first
    # threshold logit = smallest kept logit
    kth = jnp.where(keep_sorted, sorted_logits, jnp.inf).min(
        axis=-1, keepdims=True
    )
    return jnp.where(logits < kth, NEG_INF, logits)


def sample(
    key: jax.Array,
    logits: jax.Array,
    *,
    temperature=1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    rank_bf16: bool = False,
) -> jax.Array:
    """Sample token ids from (..., V) logits. Returns (...,) int32.

    rank_bf16=True runs the full-vocab candidate RANKING (lax.top_k) in
    bf16 on the raw logits — temperature is order-preserving, so it (and
    the fp32 math) applies only to the k survivors. This removes the
    full-vocab fp32 convert + divide + fp32 TopK from the decode hot loop.
    Semantics: candidate selection at bf16
    resolution (~3 significant digits); probabilities on the kept set are
    exact fp32."""
    if rank_bf16 and top_k and 0 < top_k < logits.shape[-1] and top_p < 1.0:
        vals, idx = jax.lax.top_k(logits.astype(jnp.bfloat16), top_k)
        vals = apply_temperature(vals, temperature)
        probs = jax.nn.softmax(vals, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        first = jax.lax.broadcasted_iota(jnp.int32, vals.shape, vals.ndim - 1) == 0
        vals = jnp.where((cum - probs < top_p) | first, vals, NEG_INF)
        choice = jax.random.categorical(key, vals, axis=-1)
        return jnp.take_along_axis(idx, choice[..., None], axis=-1)[..., 0]
    x = apply_temperature(logits, temperature)
    if top_k and 0 < top_k < x.shape[-1] and top_p < 1.0:
        # fused top-k + nucleus: lax.top_k returns values sorted descending,
        # so the nucleus mask is a cumsum over k values — no full-vocab sort
        # (identical semantics to masking sequentially: NEG_INF'd entries
        # carry ~0 probability mass either way)
        vals, idx = jax.lax.top_k(x, top_k)
        probs = jax.nn.softmax(vals, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        # torch nucleus semantics keep >= 1 token: position 0 (the argmax)
        # always survives, so top_p <= 0 means greedy, not uniform-over-k
        first = jax.lax.broadcasted_iota(jnp.int32, vals.shape, vals.ndim - 1) == 0
        vals = jnp.where((cum - probs < top_p) | first, vals, NEG_INF)
        choice = jax.random.categorical(key, vals, axis=-1)
        return jnp.take_along_axis(idx, choice[..., None], axis=-1)[..., 0]
    if top_k:
        x = top_k_mask(x, top_k)
    if top_p < 1.0:
        x = top_p_mask(x, top_p)
    return jax.random.categorical(key, x, axis=-1)


def ras_sample(
    key: jax.Array,
    logits: jax.Array,
    recent: jax.Array,
    *,
    top_p: float = 0.8,
    top_k: int = 25,
    win_size: int = 10,
    tau_r: float = 0.1,
    rank_bf16: bool = False,
) -> jax.Array:
    """Repetition-aware sampling (VALL-E 2; reference
    third_party/cosyvoice/utils/common.py:108-113): nucleus-sample, and if
    the draw already appears >= win_size*tau_r times in the last `win_size`
    tokens, fall back to a draw from the full distribution.

    logits: (B, V); recent: (B, win_size) rolling window of past draws
    (pad with -1). Fully on-device, fixed shapes.

    rank_bf16: full-vocab ranking and the repetition-fallback draw run in
    bf16 (see sample()); the nucleus math on the k survivors stays fp32.
    """
    k1, k2 = jax.random.split(key)
    x = logits.astype(jnp.bfloat16 if rank_bf16 else jnp.float32)
    # fused top-k + nucleus (no full-vocab sort — see sample())
    vals, idx = jax.lax.top_k(x, min(top_k, x.shape[-1]))
    vals = vals.astype(jnp.float32)
    probs = jax.nn.softmax(vals, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    # >= 1 token survives (torch nucleus semantics): p <= 0 means greedy
    first = jax.lax.broadcasted_iota(jnp.int32, vals.shape, vals.ndim - 1) == 0
    vals = jnp.where((cum - probs < top_p) | first, vals, NEG_INF)
    choice = jax.random.categorical(k1, vals, axis=-1)
    tok = jnp.take_along_axis(idx, choice[..., None], axis=-1)[..., 0]
    rep = (recent == tok[:, None]).sum(axis=-1)
    fallback = jax.random.categorical(k2, x, axis=-1)
    return jnp.where(rep >= win_size * tau_r, fallback, tok)


def ras_sample_rows(
    keys: jax.Array,
    logits: jax.Array,
    recent: jax.Array,
    *,
    top_p: float = 0.8,
    top_k: int = 25,
    win_size: int = 10,
    tau_r: float = 0.1,
) -> jax.Array:
    """ras_sample with PER-ROW keys ((B,2) uint32 key data): each row's
    draw is a pure function of its own key, independent of what shares the
    batch — the slot-pool requirement (see sample_rows). Sampling params
    are pool-level statics."""
    x = logits.astype(jnp.float32)
    vals, idx = jax.lax.top_k(x, min(top_k, x.shape[-1]))
    probs = jax.nn.softmax(vals, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    # >= 1 token survives (torch nucleus semantics): p <= 0 means greedy
    first = jax.lax.broadcasted_iota(jnp.int32, vals.shape, vals.ndim - 1) == 0
    vals = jnp.where((cum - probs < top_p) | first, vals, NEG_INF)

    def one(kd, v, xr):
        kk = jax.random.wrap_key_data(kd, impl="threefry2x32")
        k1, k2 = jax.random.split(kk)
        return (
            jax.random.categorical(k1, v),
            jax.random.categorical(k2, xr),
        )

    choice, fallback = jax.vmap(one)(keys, vals, x)
    tok = jnp.take_along_axis(idx, choice[:, None], axis=-1)[:, 0]
    rep = (recent == tok[:, None]).sum(axis=-1)
    return jnp.where(rep >= win_size * tau_r, fallback, tok)


def sample_with_rejection(
    key: jax.Array,
    logits: jax.Array,
    *,
    temperature=1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    reject_ids: Optional[jax.Array] = None,
    max_trials: int = 16,
) -> jax.Array:
    """RAS-style rejection sampling (reference cosy_llm.py:162-178): resample
    while the draw is in `reject_ids`, up to max_trials, then fall back to
    masking the rejected ids outright. Fixed trip count → jit-friendly."""
    x = apply_temperature(logits, temperature)
    if top_k:
        x = top_k_mask(x, top_k)
    if top_p < 1.0:
        x = top_p_mask(x, top_p)

    if reject_ids is None:
        return jax.random.categorical(key, x, axis=-1)

    def is_rejected(tok):
        return jnp.any(tok[..., None] == reject_ids[None, :], axis=-1)

    k0, k1 = jax.random.split(key)
    tok = jax.random.categorical(k0, x, axis=-1)

    def body(i, tok):
        redraw = jax.random.categorical(jax.random.fold_in(k1, i), x, axis=-1)
        return jnp.where(is_rejected(tok), redraw, tok)

    tok = jax.lax.fori_loop(0, max_trials, body, tok)
    # final fallback: hard-mask rejected ids
    masked = x.at[..., reject_ids].set(NEG_INF) if reject_ids.ndim == 1 else x
    fallback = jnp.argmax(masked, axis=-1)
    return jnp.where(is_rejected(tok), fallback, tok)


def sample_rows(
    key: jax.Array,
    logits: jax.Array,
    *,
    temperature: jax.Array,
    top_k: int,
    top_p: jax.Array,
) -> jax.Array:
    """Per-ROW temperature / top-p (traced (B,) vectors) with a STATIC
    top-k cap: serving slots carry each request's sampling params, and the
    decode-chunk program stays one compiled shape for any mix of requests
    (rows wanting a smaller effective k express it through top_p; rows
    wanting no nucleus cut pass top_p=1). Same fused no-full-vocab-sort
    construction as sample().

    `key` is either one key for the whole batch or PER-ROW keys of shape
    (B, 2) (uint32 key data) — per-row keys make each row's draw a pure
    function of its own key, independent of what shares the batch."""
    x = logits.astype(jnp.float32)
    x = x / jnp.maximum(temperature.astype(jnp.float32), 1e-6)[:, None]
    V = x.shape[-1]
    k = top_k if 0 < top_k < V else V
    vals, idx = jax.lax.top_k(x, k)
    probs = jax.nn.softmax(vals, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    # keep >= 1 token per row (torch nucleus semantics): a request sending
    # top_p=0 gets greedy, not uniform-over-top-k
    first = jax.lax.broadcasted_iota(jnp.int32, vals.shape, vals.ndim - 1) == 0
    vals = jnp.where(
        (cum - probs < top_p.astype(jnp.float32)[:, None]) | first,
        vals, NEG_INF,
    )
    if key.ndim == 2:  # per-row keys
        choice = jax.vmap(
            lambda kk, v: jax.random.categorical(
                jax.random.wrap_key_data(kk, impl="threefry2x32"), v
            )
        )(key, vals)
    else:
        choice = jax.random.categorical(key, vals, axis=-1)
    return jnp.take_along_axis(idx, choice[..., None], axis=-1)[..., 0]
