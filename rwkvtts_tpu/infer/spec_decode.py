"""Lossless self-speculative greedy decoding for the B=1 latency path.

B=1 decode at deployed sizes is weight-bandwidth-bound: every step reads
all the weights to produce one token. Speculative
decoding attacks exactly that bound: a cheap DRAFT model proposes K
tokens one step at a time, then the full-precision model VERIFIES all K
in ONE chunked forward — reading the bf16 weights once per K tokens
instead of once per token (the verify pass's projections are (K,C)@(C,D)
matmuls, so the tensor cores amortize the weight read over the window).

Here the draft is the SAME model with int8/int4 decode weights
(models/rwkv7.pack_decode_params) — "self-speculative": no second model
to train or load; where int8 and bf16 agree on the top-1 token the
acceptance rate is ~1, and the output is BIT-EXACT the bf16 greedy
rollout either way.

Round structure (no commit pass, no rollback pass):
  - state S = verifier state after the committed prefix, h = last hidden;
  - draft d1..dK greedily with quantized weights, d1 from the VERIFIER's
    own h (so d1 is always accepted by construction);
  - one bf16 verify forward over d1..dK from S with per-position state
    collection (models/rwkv7.forward(collect_states=True)): logits V_i
    after consuming d1..di, greedy targets t_{i+1} = argmax(V_i);
  - accept a = 1 + longest prefix with d_{i+1} == t_{i+1}; emit d1..da;
  - next round resumes from position a-1's collected state and hidden —
    its first draft token argmax(V_{a-1}) IS the correction, so a
    rejection costs nothing beyond the shortened acceptance window.

The reference has no speculative path at all (its decode is the
one-token-per-launch CUDA kernel, cuda/rwkv7_state_fwd_fp16.cu); the
verify chunk is exactly the matmul-shaped prefill form the chunked WKV
already serves.

Two modes:
  - GREEDY (spec_generate_greedy): output bit-exact the plain greedy
    rollout;
  - exact speculative SAMPLING (spec_sample_generate): the standard
    accept/residual rule (accept d_i w.p. min(1, p(d_i)/q(d_i)); on
    rejection sample from normalize(max(p-q, 0))) — the emitted sequence
    is distributed EXACTLY as plain sampling from the verifier's filtered
    (temperature/top-k/top-p) distributions. The correction token is
    DEFERRED: a rejection at position a makes the residual distribution
    the OVERRIDE for the next round's first draft token (sampling from
    the residual is the exact correction, and a first token sampled from
    its own target distribution is always accepted) — so no round ever
    needs a commit/rollback pass, mirroring the greedy construction.

RAS (Cosy's repetition-aware sampler) re-samples based on window history,
which does not factor into per-step distributions — not supported here
(serving uses plain top-k/top-p for Spark; RAS paths keep the chunked
decode).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.models import rwkv7, spark
from rwkvtts_tpu.ops import sampling


def _logits(params, cfg, h):
    out = (h @ params["head"].astype(cfg.backbone.dtype)).astype(jnp.float32)
    if "head_bias" in params:
        out = out + params["head_bias"].astype(jnp.float32)
    return out


@functools.partial(jax.jit, static_argnames=("cfg", "k"))
def draft_greedy_k(params, cfg, h, state, k: int):
    """K greedy draft tokens from (h, state) with `params` (normally the
    int8/int4-packed layer views). Returns tokens (B, K); the draft's own
    final state is discarded — the verifier's collected states are the
    source of truth."""
    bb = cfg.backbone

    def step(c, _):
        h, st = c
        tok = jnp.argmax(_logits(params, cfg, h), axis=-1).astype(jnp.int32)
        x = params["embedding"][tok].astype(bb.dtype)
        h, st = rwkv7.decode_step(params, bb, x, st)
        return (h, st), tok

    (_, _), toks = jax.lax.scan(step, (h, state), None, length=k)
    return jnp.moveaxis(toks, 0, 1)


def _select_position(state, idx: jax.Array):
    """Slice a collect_states tree (leaves (L, B, T, ...)) at per-row
    position idx (B,) -> stacked decode state (leaves (L, B, ...))."""

    def sel(leaf):
        L, B = leaf.shape[:2]
        i = idx.reshape(1, B, 1, *([1] * (leaf.ndim - 3))).astype(jnp.int32)
        i = jnp.broadcast_to(i, (L, B, 1) + leaf.shape[3:])
        return jnp.take_along_axis(leaf, i, axis=2)[:, :, 0]

    return jax.tree.map(sel, state)


@functools.partial(jax.jit, static_argnames=("cfg",))
def verify_greedy_k(params, cfg, state, draft_toks):
    """One bf16 chunk pass over the K draft tokens. Returns
    (a (B,) accepted counts, h (B,C) hidden at position a-1,
    state after position a-1) — h/state are exactly where the committed
    sequence ends, so the next round's first greedy token doubles as the
    correction for a rejected draft."""
    bb = cfg.backbone
    x = params["embedding"][draft_toks].astype(bb.dtype)
    hidden, all_st = rwkv7.forward(
        params, bb, inputs_embeds=x, state=state, collect_states=True
    )
    targets = jnp.argmax(_logits(params, cfg, hidden), axis=-1).astype(jnp.int32)
    m = (draft_toks[:, 1:] == targets[:, :-1]).astype(jnp.int32)
    a = 1 + jnp.cumprod(m, axis=-1).sum(axis=-1)  # (B,) in [1, K]
    idx = a - 1
    h = jnp.take_along_axis(
        hidden, idx[:, None, None].astype(jnp.int32), axis=1
    )[:, 0]
    return a, h, _select_position(all_st, idx)


def spec_generate_greedy(
    params,
    cfg,
    tokens,
    modality,
    attention_mask=None,
    *,
    draft_params: Optional[Dict[str, Any]] = None,
    k: int = 8,
    max_new_tokens: int = 1024,
    eos_id: Optional[int] = None,
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Greedy generation via self-speculative decode (B=1).

    draft_params: the quantized param tree (pack_decode_params(...,
    quantize_int8=True) or int4) — defaults to `params` itself (still
    amortizes weight reads K-fold on the verify side, but the draft loop
    then reads bf16 weights; pass int8 for the full win).

    Returns (tokens (<=max_new_tokens,), stats) where stats carries the
    measured acceptance: rounds, drafted, accepted (==len(tokens) before
    EOS truncation), accept_rate.
    """
    assert tokens.shape[0] == 1, "speculative decode is the B=1 latency path"
    eos = cfg.eos_token_id if eos_id is None else eos_id
    h, state = spark.prefill(params, cfg, tokens, modality, attention_mask)
    dviews = rwkv7.layer_decode_views(
        params if draft_params is None else draft_params, cfg.backbone
    )
    out: list = []
    rounds = 0
    drafted = 0
    done = False
    while len(out) < max_new_tokens and not done:
        dstate = rwkv7.pack_decode_state(state, cfg.backbone)
        d = draft_greedy_k(dviews, cfg, h, dstate, k)
        a, h, state = verify_greedy_k(params, cfg, state, d)
        a_host = int(np.asarray(a)[0])
        d_host = np.asarray(d)[0]
        rounds += 1
        drafted += k
        for t in d_host[:a_host]:
            out.append(int(t))
            if int(t) == eos or len(out) >= max_new_tokens:
                done = True
                break
    stats = {
        "rounds": rounds,
        "drafted": drafted,
        "accepted": len(out),
        "accept_rate": len(out) / max(drafted, 1),
    }
    return np.asarray(out, np.int32), stats


# ---------------------------------------------------------------------------
# Exact speculative sampling (temperature / top-k / top-p)
# ---------------------------------------------------------------------------


def _filtered(logits, temperature, top_k, top_p):
    """The target/draft filtered logits — MUST be the same function on both
    sides for the accept/residual rule to be exact."""
    x = sampling.apply_temperature(logits, temperature)
    if top_k:
        x = sampling.top_k_mask(x, top_k)
    if top_p < 1.0:
        x = sampling.top_p_mask(x, top_p)
    return x


@functools.partial(
    jax.jit, static_argnames=("cfg", "k", "temperature", "top_k", "top_p")
)
def draft_sample_k(
    params, cfg, h, state, key, override_logits, use_override, k: int,
    temperature: float, top_k: int, top_p: float,
):
    """K sampled draft tokens + the filtered logits each was sampled from.

    The FIRST step's distribution comes from the verifier's own hidden
    (the head is never quantized, so q_1 == the target p at the boundary
    and d_1 is always accepted), or — after a rejection — from
    `override_logits` (the residual distribution, whose sample is the
    exact correction). Returns (toks (B,K), qlogits (B,K,V))."""
    bb = cfg.backbone

    def step(c, xs):
        h, st, first = c
        step_key = xs
        fl = _filtered(_logits(params, cfg, h), temperature, top_k, top_p)
        fl = jnp.where(first & use_override, override_logits, fl)
        tok = jax.random.categorical(step_key, fl, axis=-1).astype(jnp.int32)
        x = params["embedding"][tok].astype(bb.dtype)
        h, st = rwkv7.decode_step(params, bb, x, st)
        return (h, st, jnp.zeros((), bool)), (tok, fl)

    keys = jax.random.split(key, k)
    (_, _, _), (toks, qlog) = jax.lax.scan(
        step, (h, state, jnp.ones((), bool)), keys
    )
    return jnp.moveaxis(toks, 0, 1), jnp.moveaxis(qlog, 0, 1)


@functools.partial(
    jax.jit, static_argnames=("cfg", "temperature", "top_k", "top_p")
)
def verify_sample_k(
    params, cfg, state, draft_toks, qlogits, key,
    temperature: float, top_k: int, top_p: float,
):
    """Accept/residual verification of K sampled draft tokens.

    Returns (a accepted counts (B,), h at position a-1, state after
    position a-1, override_logits (B,V) = log residual at the rejection
    point, use_override (B,) bool — False on full acceptance)."""
    bb = cfg.backbone
    B, K = draft_toks.shape
    x = params["embedding"][draft_toks].astype(bb.dtype)
    hidden, all_st = rwkv7.forward(
        params, bb, inputs_embeds=x, state=state, collect_states=True
    )
    plog = _filtered(
        _logits(params, cfg, hidden), temperature, top_k, top_p
    )  # (B, K, V): row i = target dist AFTER consuming d_1..d_{i+1}
    p = jax.nn.softmax(plog, axis=-1)
    q = jax.nn.softmax(qlogits.astype(jnp.float32), axis=-1)
    # accept d[:, j] (j >= 1) iff u_j * q_j(d_j) <= p_{j-1}(d_j)
    d_tail = draft_toks[:, 1:, None]
    pd = jnp.take_along_axis(p[:, :-1], d_tail, axis=-1)[..., 0]  # (B, K-1)
    qd = jnp.take_along_axis(q[:, 1:], d_tail, axis=-1)[..., 0]
    u = jax.random.uniform(key, (B, K - 1))
    acc = (u * qd <= pd).astype(jnp.int32)
    a = 1 + jnp.cumprod(acc, axis=-1).sum(axis=-1)  # (B,) in [1, K]
    idx = (a - 1).astype(jnp.int32)
    h = jnp.take_along_axis(hidden, idx[:, None, None], axis=1)[:, 0]
    # residual at the rejection point: normalize(max(p_{a-1} - q_a, 0)).
    # On full acceptance (a == K) there is no rejection; use_override=False
    # and the next round's first token samples its own boundary target.
    p_rej = jnp.take_along_axis(p, idx[:, None, None], axis=1)[:, 0]
    q_rej = jnp.take_along_axis(
        q, jnp.minimum(idx + 1, K - 1)[:, None, None], axis=1
    )[:, 0]
    resid = jnp.maximum(p_rej - q_rej, 0.0)
    # a zero residual (p <= q pointwise can only happen via float round-off
    # when p == q) falls back to p itself
    fallback = jnp.sum(resid, axis=-1, keepdims=True) <= 0
    resid = jnp.where(fallback, p_rej, resid)
    override = jnp.where(resid > 0, jnp.log(resid), sampling.NEG_INF)
    use_override = a < K
    return a, h, _select_position(all_st, idx), override, use_override


def spec_sample_generate(
    params,
    cfg,
    tokens,
    modality,
    attention_mask=None,
    *,
    key=None,
    draft_params: Optional[Dict[str, Any]] = None,
    k: int = 8,
    max_new_tokens: int = 1024,
    temperature: float = 1.0,
    top_k: int = 50,
    top_p: float = 0.95,
    eos_id: Optional[int] = None,
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Sampled generation via self-speculative decode (B=1), exact in
    distribution w.r.t. plain sampling from the filtered target."""
    assert tokens.shape[0] == 1, "speculative decode is the B=1 latency path"
    if key is None:
        key = jax.random.PRNGKey(0)
    eos = cfg.eos_token_id if eos_id is None else eos_id
    h, state = spark.prefill(params, cfg, tokens, modality, attention_mask)
    dviews = rwkv7.layer_decode_views(
        params if draft_params is None else draft_params, cfg.backbone
    )
    vocab = params["head"].shape[-1]
    override = jnp.full((1, vocab), sampling.NEG_INF, jnp.float32)
    use_override = jnp.zeros((1,), bool)
    out: list = []
    rounds = 0
    drafted = 0
    done = False
    while len(out) < max_new_tokens and not done:
        key, kd, kv = jax.random.split(key, 3)
        dstate = rwkv7.pack_decode_state(state, cfg.backbone)
        d, qlog = draft_sample_k(
            dviews, cfg, h, dstate, kd, override[0], use_override[0],
            k, temperature, top_k, top_p,
        )
        a, h, state, override, use_override = verify_sample_k(
            params, cfg, state, d, qlog, kv, temperature, top_k, top_p
        )
        a_host = int(np.asarray(a)[0])
        d_host = np.asarray(d)[0]
        rounds += 1
        drafted += k
        for t in d_host[:a_host]:
            out.append(int(t))
            if int(t) == eos or len(out) >= max_new_tokens:
                done = True
                break
    stats = {
        "rounds": rounds,
        "drafted": drafted,
        "accepted": len(out),
        "accept_rate": len(out) / max(drafted, 1),
    }
    return np.asarray(out, np.int32), stats
