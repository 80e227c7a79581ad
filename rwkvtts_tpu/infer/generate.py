"""Jitted autoregressive generation.

The reference decodes through HF `generate` (host-side Python loop; e.g.
test_respark/simple_generate.py:46-56) or hand loops (cosy_llm.py:238-261).
Here the whole decode — embedding, all layers, sampling, EOS logic — is one
compiled program per step batch, driven by `lax.scan` with a donated state
pytree: no host round-trips, state in device memory, fixed shapes
(SURVEY.md §7 hard part #3).
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from rwkvtts_tpu.models import rwkv7, spark
from rwkvtts_tpu.ops import sampling


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg",
        "max_new_tokens",
        "top_k",
        "top_p",
        "temperature",
        "eos_id",
        "min_new_tokens",
    ),
    donate_argnums=(),
)
def spark_generate(
    params,
    cfg: spark.SparkTTSConfig,
    tokens: jax.Array,
    modality: jax.Array,
    attention_mask: jax.Array,
    key: jax.Array,
    *,
    max_new_tokens: int = 1024,
    min_new_tokens: int = 0,
    temperature: float = 1.0,
    top_k: int = 50,
    top_p: float = 0.95,
    eos_id: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Batched Spark semantic-token generation.

    tokens/modality/attention_mask: left-padded prompt batch (B, T).
    Returns (generated (B, max_new_tokens) int32, lengths (B,)); positions
    after EOS are filled with eos_id. Defaults follow the reference
    (top_k 50, top_p 0.95; test_respark/simple_generate.py:46-56).
    """
    if eos_id is None:
        eos_id = cfg.eos_token_id
    bb = cfg.backbone
    B = tokens.shape[0]

    h_last, state = spark.prefill(params, cfg, tokens, modality, attention_mask)
    state = rwkv7.pack_decode_state(state, bb)
    params = rwkv7.layer_decode_views(params, bb)

    def step(carry, step_key):
        h, st, done, n = carry
        logits = (h @ params["head"].astype(bb.dtype)).astype(jnp.float32)
        # EOS suppression below min length (reference cosy-style bound)
        if min_new_tokens > 0:
            logits = jnp.where(
                (n < min_new_tokens)[..., None]
                & (jnp.arange(logits.shape[-1]) == eos_id)[None, :],
                sampling.NEG_INF,
                logits,
            )
        tok = sampling.sample(
            step_key, logits, temperature=temperature, top_k=top_k, top_p=top_p
        )
        tok = jnp.where(done, eos_id, tok)
        new_done = done | (tok == eos_id)
        x = spark.decode_embed(params, cfg, tok)
        h, st = rwkv7.decode_step(params, bb, x, st)
        return (h, st, new_done, n + 1), tok

    keys = jax.random.split(key, max_new_tokens)
    init = (h_last, state, jnp.zeros((B,), bool), jnp.zeros((B,), jnp.int32))
    (_, _, done, _), toks = jax.lax.scan(step, init, keys)
    toks = jnp.moveaxis(toks, 0, 1)  # (B, max_new)
    lengths = jnp.argmax(toks == eos_id, axis=-1)
    lengths = jnp.where(jnp.any(toks == eos_id, axis=-1), lengths, max_new_tokens)
    return toks, lengths


@functools.partial(jax.jit, static_argnames=("cfg",))
def spark_prefill_carry(params, cfg, tokens, modality, attention_mask):
    """Prefill and build the chunked-decode carry for `spark_decode_chunk`."""
    B = tokens.shape[0]
    h_last, state = spark.prefill(params, cfg, tokens, modality, attention_mask)
    state = rwkv7.pack_decode_state(state, cfg.backbone)
    return (h_last, state, jnp.zeros((B,), bool), jnp.zeros((B,), jnp.int32))


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg", "chunk_len", "min_new_tokens", "temperature", "top_k", "top_p",
    ),
    donate_argnums=(2,),
)
def spark_decode_chunk(
    params,
    cfg,
    carry,
    key: jax.Array,
    *,
    chunk_len: int = 64,
    min_new_tokens: int = 0,
    temperature: float = 1.0,
    top_k: int = 50,
    top_p: float = 0.95,
):
    """Decode `chunk_len` Spark semantic tokens from a carried state; the
    host loop stops at EOS between chunks (early exit — a short utterance
    costs its own length, not max_new_tokens). Returns
    (carry, toks (B, chunk_len), done (B,))."""
    eos_id = cfg.eos_token_id
    bb = cfg.backbone
    params = rwkv7.layer_decode_views(params, bb)

    def step(c, step_key):
        h, st, done, n = c
        logits = (h @ params["head"].astype(bb.dtype)).astype(jnp.float32)
        if min_new_tokens > 0:
            logits = jnp.where(
                (n < min_new_tokens)[..., None]
                & (jnp.arange(logits.shape[-1]) == eos_id)[None, :],
                sampling.NEG_INF,
                logits,
            )
        tok = sampling.sample(
            step_key, logits, temperature=temperature, top_k=top_k, top_p=top_p
        )
        tok = jnp.where(done, eos_id, tok)
        done = done | (tok == eos_id)
        x = spark.decode_embed(params, cfg, tok)
        h, st = rwkv7.decode_step(params, bb, x, st)
        return (h, st, done, n + 1), tok

    keys = jax.random.split(key, chunk_len)
    carry, toks = jax.lax.scan(step, carry, keys)
    return carry, jnp.moveaxis(toks, 0, 1), carry[2]


def spark_generate_early_exit(
    params, cfg, tokens, modality, attention_mask, key,
    *, max_new_tokens: int = 1024, chunk_len: int = 64, **sample_kw,
):
    """Host-chunked Spark generation: same contract as `spark_generate`
    (post-EOS positions filled with EOS) but stops decoding once every
    sequence finished — short utterances don't pay the max-length scan."""
    import numpy as np

    eos_id = cfg.eos_token_id
    carry = spark_prefill_carry(params, cfg, tokens, modality, attention_mask)
    B = tokens.shape[0]
    chunks = []
    n = 0
    while n < max_new_tokens:
        key, sub = jax.random.split(key)
        cl = min(chunk_len, max_new_tokens - n)
        carry, toks, done = spark_decode_chunk(
            params, cfg, carry, sub, chunk_len=cl, **sample_kw
        )
        chunks.append(np.asarray(toks))
        n += cl
        if bool(np.asarray(done).all()):
            break
    out = np.concatenate(chunks, axis=1)
    pad = max_new_tokens - out.shape[1]
    if pad:
        out = np.concatenate(
            [out, np.full((B, pad), eos_id, out.dtype)], axis=1
        )
    lengths = np.argmax(out == eos_id, axis=-1)
    lengths = np.where((out == eos_id).any(axis=-1), lengths, max_new_tokens)
    return jnp.asarray(out), jnp.asarray(lengths)


def _make_cosy_step(
    params, cfg, *, min_new_tokens: int, top_k: int, top_p: float,
    win_size: int, tau_r: float, rank_bf16: bool = False,
):
    """One Cosy decode step (RAS sampling + EOS bookkeeping), shared by the
    fixed-length scan (`cosy_generate`) and the chunked streaming decoder
    (`cosy_decode_chunk`). carry = (h, state, done, recent, n)."""
    from rwkvtts_tpu.models import cosy

    eos_id = cfg.eos_token_id
    bb = cfg.backbone

    def step(carry, step_key):
        h, st, done, recent, n = carry
        logits = h @ params["head"].astype(bb.dtype)
        if not rank_bf16:
            logits = logits.astype(jnp.float32)
        if "head_bias" in params:
            logits = logits + params["head_bias"].astype(logits.dtype)
        logits = jnp.where(
            (n < min_new_tokens)[:, None]
            & (jnp.arange(logits.shape[-1]) == eos_id)[None, :],
            sampling.NEG_INF,
            logits,
        )
        tok = sampling.ras_sample(
            step_key, logits, recent,
            top_p=top_p, top_k=top_k, win_size=win_size, tau_r=tau_r,
            rank_bf16=rank_bf16,
        )
        tok = jnp.where(done, eos_id, tok)
        new_done = done | (tok == eos_id)
        recent = jnp.concatenate([recent[:, 1:], tok[:, None]], axis=1)
        x = cosy.decode_embed(params, cfg, tok)
        h, st = rwkv7.decode_step(params, bb, x, st)
        return (h, st, new_done, recent, n + 1), tok

    return step


@functools.partial(jax.jit, static_argnames=("cfg", "win_size"))
def cosy_prefill_carry(
    params, cfg, tokens, modality, attention_mask, win_size: int = 10,
):
    """Prefill and build the chunked-decode carry for `cosy_decode_chunk`."""
    from rwkvtts_tpu.models import cosy

    B = tokens.shape[0]
    h_last, state = cosy.prefill(params, cfg, tokens, modality, attention_mask)
    state = rwkv7.pack_decode_state(state, cfg.backbone)
    return (
        h_last,
        state,
        jnp.zeros((B,), bool),
        jnp.full((B, win_size), -1, jnp.int32),
        jnp.zeros((B,), jnp.int32),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg", "chunk_len", "top_k", "top_p", "win_size", "tau_r",
        "rank_bf16",
    ),
    donate_argnums=(2,),
)
def cosy_decode_chunk(
    params,
    cfg,
    carry,
    key: jax.Array,
    *,
    chunk_len: int = 32,
    min_new_tokens: int = 0,
    top_k: int = 25,
    top_p: float = 0.8,
    win_size: int = 10,
    tau_r: float = 0.1,
    rank_bf16: bool = False,
):
    """Decode `chunk_len` Cosy tokens from a carried state.

    The host loop calls this repeatedly, checks `done` between chunks, and
    stops early once every sequence hit EOS — the compiled-program answer to
    the reference's per-token Python loop with an early break
    (cosy_llm.py:238-261): fixed-shape compiled chunks, host control only
    at chunk granularity, so a 20×-content max length does not cost 20×
    compute. Returns (carry, toks (B, chunk_len), done (B,))."""
    params = rwkv7.layer_decode_views(params, cfg.backbone)
    step = _make_cosy_step(
        params, cfg, min_new_tokens=min_new_tokens, top_k=top_k, top_p=top_p,
        win_size=win_size, tau_r=tau_r, rank_bf16=rank_bf16,
    )
    keys = jax.random.split(key, chunk_len)
    carry, toks = jax.lax.scan(step, carry, keys)
    return carry, jnp.moveaxis(toks, 0, 1), carry[2]


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg",
        "max_new_tokens",
        "top_k",
        "top_p",
        "win_size",
        "tau_r",
    ),
)
def cosy_generate(
    params,
    cfg,
    tokens: jax.Array,
    modality: jax.Array,
    attention_mask: jax.Array,
    key: jax.Array,
    *,
    max_new_tokens: int = 1024,
    min_new_tokens: int = 0,
    top_k: int = 25,
    top_p: float = 0.8,
    win_size: int = 10,
    tau_r: float = 0.1,
) -> Tuple[jax.Array, jax.Array]:
    """CosyVoice speech-token generation with RAS sampling and EOS
    suppression below min length (reference cosy_llm.py:180-261).

    Returns (generated (B, max_new), lengths (B,)); post-EOS filled with EOS.
    """
    from rwkvtts_tpu.models import cosy

    eos_id = cfg.eos_token_id
    B = tokens.shape[0]
    h_last, state = cosy.prefill(params, cfg, tokens, modality, attention_mask)
    state = rwkv7.pack_decode_state(state, cfg.backbone)
    params = rwkv7.layer_decode_views(params, cfg.backbone)

    step = _make_cosy_step(
        params, cfg, min_new_tokens=min_new_tokens, top_k=top_k, top_p=top_p,
        win_size=win_size, tau_r=tau_r,
    )
    keys = jax.random.split(key, max_new_tokens)
    recent0 = jnp.full((B, win_size), -1, jnp.int32)
    init = (
        h_last,
        state,
        jnp.zeros((B,), bool),
        recent0,
        jnp.zeros((B,), jnp.int32),
    )
    (_, _, done, _, _), toks = jax.lax.scan(step, init, keys)
    toks = jnp.moveaxis(toks, 0, 1)
    lengths = jnp.argmax(toks == eos_id, axis=-1)
    lengths = jnp.where(
        jnp.any(toks == eos_id, axis=-1), lengths, max_new_tokens
    )
    return toks, lengths


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg",
        "max_new_tokens",
        "min_new_tokens",
        "temperature",
        "allow_eos",
    ),
)
def xy_generate(
    params,
    cfg,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    key: jax.Array,
    *,
    max_new_tokens: int = 512,
    min_new_tokens: int = 0,
    temperature: float = 1.0,
    allow_eos: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """XY 8-channel generation with the staggered flush automaton.

    input_ids: (B, T, 8) left-padded prompt. Returns
    (frames (B, max_new, 8), lengths (B,) — audio steps before the flush).

    Semantics follow the reference `CustomGenerationMixin._sample`
    (xy_llm.py:39-146): ch0 logits hard-masked to the audio range,
    independent per-channel sampling, and a (channels-1)-step flush that
    emits EOS on ch0 / staggered PADs on ch1..7 once ch0 leaves the audio
    range. Divergence by design: with `allow_eos` the ch0 EOS (text pad id)
    stays sample-able after `min_new_tokens`, so the flush is actually
    reachable — the reference masks it out and can only stop at max length.
    """
    from rwkvtts_tpu.models import xy as xy_model

    bb = cfg.backbone
    B = input_ids.shape[0]
    nch = cfg.num_channels
    lo = cfg.text_shift_size
    hi = cfg.text_shift_size + cfg.speech_vocab_size
    eos0 = cfg.text_pad_id
    pad = cfg.speech_pad_id

    h_last, state = xy_model.prefill(params, cfg, input_ids, attention_mask)
    state = rwkv7.pack_decode_state(state, bb)
    params = rwkv7.layer_decode_views(params, bb)

    ch_arange0 = jnp.arange(cfg.text_vocab_size)
    audio_mask0 = (ch_arange0 >= lo) & (ch_arange0 < hi)

    def step(carry, step_key):
        h, st, countdown, done, n = carry
        logits = xy_model.channel_logits(params, cfg, h)
        l0 = logits[0]
        allowed = audio_mask0
        if allow_eos:
            allowed = allowed | (ch_arange0 == eos0)
        l0 = jnp.where(allowed[None, :], l0, sampling.NEG_INF)
        if min_new_tokens > 0:
            l0 = jnp.where(
                (n < min_new_tokens)[:, None] & (ch_arange0 == eos0)[None, :],
                sampling.NEG_INF,
                l0,
            )
        keys = jax.random.split(step_key, nch)
        toks = [sampling.sample(keys[0], l0, temperature=temperature)]
        for i in range(1, nch):
            toks.append(
                sampling.sample(keys[i], logits[i], temperature=temperature)
            )
        frame = jnp.stack(toks, axis=-1)  # (B, 8)

        is_audio = (frame[:, 0] >= lo) & (frame[:, 0] < hi)
        start_flush = (~is_audio) & (countdown < 0)
        countdown = jnp.where(start_flush, nch - 1, countdown)
        flushing = countdown >= 0

        # during flush: ch0 -> EOS; ch i pads once countdown < nch - i
        frame = frame.at[:, 0].set(jnp.where(flushing, eos0, frame[:, 0]))
        for i in range(1, nch):
            pad_i = flushing & (countdown < nch - i)
            frame = frame.at[:, i].set(jnp.where(pad_i, pad, frame[:, i]))

        # finished sequences emit eos/pad frames
        frame = frame.at[:, 0].set(jnp.where(done, eos0, frame[:, 0]))
        frame = jnp.concatenate(
            [
                frame[:, :1],
                jnp.where(done[:, None], pad, frame[:, 1:]),
            ],
            axis=1,
        )

        countdown = jnp.where(flushing, countdown - 1, countdown)
        new_done = done | (flushing & (countdown < 0))
        n = n + jnp.where(is_audio & ~done, 1, 0)

        x = xy_model.decode_embed(params, cfg, frame)
        h, st = rwkv7.decode_step(params, bb, x, st)
        return (h, st, countdown, new_done, n), frame

    keys = jax.random.split(key, max_new_tokens)
    init = (
        h_last,
        state,
        jnp.full((B,), -1, jnp.int32),
        jnp.zeros((B,), bool),
        jnp.zeros((B,), jnp.int32),
    )
    (_, _, _, done, n_audio), frames = jax.lax.scan(step, init, keys)
    frames = jnp.moveaxis(frames, 0, 1)  # (B, T, 8)
    return frames, n_audio


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "num_tokens", "top_k", "top_p", "temperature"),
)
def spark_global_generate(
    params,
    cfg,
    tokens: jax.Array,
    modality: jax.Array,
    attention_mask: jax.Array,
    key: jax.Array,
    *,
    num_tokens: int = 32,
    temperature: float = 1.0,
    top_k: int = 50,
    top_p: float = 0.95,
):
    """Voice-designer decode: sample exactly `num_tokens` global (speaker)
    ids from the shared head restricted to [0, 4096), embedding each via the
    global_embedder (the `_global_tokens` training variant's inference path;
    reference utils/multiple_jsonl.py:313-400, test_respark
    tts_using_webrwkv_osx.py voice-design flow)."""
    from rwkvtts_tpu.models import spark

    bb = cfg.backbone
    B = tokens.shape[0]
    V = cfg.audio_global_vocab_size
    h_last, state = spark.prefill(params, cfg, tokens, modality, attention_mask)
    state = rwkv7.pack_decode_state(state, bb)
    params = rwkv7.layer_decode_views(params, bb)
    vocab_mask = jnp.arange(cfg.semantic_vocab_size) >= V

    def step(carry, step_key):
        h, st = carry
        logits = (h @ params["head"].astype(bb.dtype)).astype(jnp.float32)
        logits = jnp.where(vocab_mask[None, :], sampling.NEG_INF, logits)
        tok = sampling.sample(
            step_key, logits, temperature=temperature, top_k=top_k, top_p=top_p
        )
        x = params["global_embedder"][tok].astype(bb.dtype)
        h, st = rwkv7.decode_step(params, bb, x, st)
        return (h, st), tok

    keys = jax.random.split(key, num_tokens)
    (_, _), toks = jax.lax.scan(step, (h_last, state), keys)
    toks = jnp.moveaxis(toks, 0, 1)  # (B, num_tokens)
    return toks, jnp.full((B,), num_tokens, jnp.int32)


def greedy_spark_generate(params, cfg, tokens, modality, attention_mask, **kw):
    """Greedy decode == temperature→0 path used for golden-token tests."""
    return spark_generate(
        params,
        cfg,
        tokens,
        modality,
        attention_mask,
        jax.random.PRNGKey(0),
        temperature=1e-6,
        top_k=1,
        top_p=1.0,
        **kw,
    )
