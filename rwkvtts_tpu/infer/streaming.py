"""Incremental-state streaming CosyVoice synthesis.

The reference streams by re-running the flow over the ENTIRE token prefix
every hop and only caching vocoder state (third_party/cosyvoice/cli/
model.py:372-434: token2wav(token[:offset+hop+lookahead]) + hift mel/source
caches + Hamming fade) — per-hop cost grows linearly with the prefix, so a
long utterance costs O(n²) flow work.

This module keeps the same audible contract (hop/lookahead windows, 8-frame
mel overlap, source-cache continuation, Hamming crossfade) but makes every
stage O(1) per hop:

  * LM: chunked early-exit decode with a carried RWKV state
    (`generate.cosy_decode_chunk`) — tokens stream out while the flow
    consumes them, and decoding stops at EOS instead of running to the
    reference's 20×-content max length.
  * Flow: a FIXED-capacity token window [prompt | last ctx tokens | hop +
    lookahead] through one compiled program (`flow.inference_window`);
    absolute-position counter-based noise keeps window frames identical to
    what the full sequence would produce at those positions, replacing the
    reference's flow_cache (flow_matching.py:57-65).
  * Vocoder: HiFT mel cache (8 frames) + source cache (8*480 samples) +
    Hamming-window crossfade, exactly the reference's hift_cache_dict
    scheme (cli/model.py:355-358, 374-395).

All shapes are static: the whole stream compiles 2-3 programs total
regardless of utterance length.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Generator, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.codecs import flow as flow_lib
from rwkvtts_tpu.codecs import hift as hift_lib
from rwkvtts_tpu.data import cosy_collator
from rwkvtts_tpu.infer import generate as gen


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    # token_hop_len = 2 * input_frame_rate (cli/model.py:350); 25 Hz S3-v2
    # tokens -> 50-token hops = 2 s of audio per chunk.
    token_hop_len: int = 50
    # generated-token context kept in the flow window in addition to the
    # prompt; bounds how much left context conditions each new hop.
    ctx_tokens: int = 100
    mel_cache_len: int = 8  # cli/model.py:355
    n_timesteps: int = 10
    lm_chunk: int = 50  # LM decode steps between host-side EOS checks
    # LM chunk ramp: after the first audio chunk is out, decode
    # lm_chunk_max steps per dispatch instead (one extra compiled program).
    # Each dispatch+sync pays a fixed host round trip — bigger late chunks
    # cut that count without touching TTFA (the first, TTFA-critical chunk
    # stays lm_chunk). Cost: up to lm_chunk_max-1 wasted post-EOS decode
    # steps.
    lm_chunk_max: Optional[int] = None
    # SFM fast decode in the flow hop (flow.sfm_inference_window): the ODE
    # starts at t_h from the coarse prediction — use with n_timesteps ~5
    # for about half the CFM-10 estimator passes per hop. Requires
    # pipeline.flow_cfg.sfm and a trained sfm_head in flow_params.
    sfm: bool = False
    # HiFT calls are fixed-cost-bound at hop size (a call costs about the
    # same for 116 or 466 frames): vocode_every=K batches K hops of mel
    # into one vocoder call AFTER the first chunk (TTFA unchanged), cutting
    # the steady-state vocoder cost ~K×. Audio differs from K=1 only in
    # having K× fewer crossfade seams.
    vocode_every: int = 1
    # dispatch LM chunk N+1 before vocoding hop N — but only once the first
    # audio chunk is out: the device runs one program at a time, so a
    # prefetch enqueued before flow hop 0 DELAYS first audio by a whole LM
    # chunk. After the first chunk it hides host-side window prep.
    # Token-identical (same key split order); costs at most one wasted LM
    # chunk after EOS.
    lm_prefetch: bool = True
    # Hop ramp: the flow hop DOUBLES after each emitted hop, capped at
    # hop_max (None = fixed hop). The first chunk stays token_hop_len
    # (TTFA unchanged); steady state pays the flow/vocoder fixed costs
    # (roughly constant per call whatever its length) per 4-8 s of audio
    # instead of per 2 s. One compiled flow program per ramp stage
    # (log2(hop_max/hop) + 1 programs). The LM outruns playback, so
    # waiting for the bigger hop does not starve the stream.
    hop_max: Optional[int] = None


@functools.partial(
    jax.jit,
    static_argnames=("fcfg", "prompt_len", "slice_len", "n_timesteps", "sfm"),
)
def _flow_hop(
    fparams,
    fcfg,
    key,
    tokens_win,
    n_valid,
    prompt_feat,
    prompt_len: int,
    gen_start,
    new_off,
    slice_len: int,
    spk,
    n_timesteps: int,
    sfm: bool = False,
):
    """One windowed flow hop; returns (1, slice_len*ratio, 80) new mel.

    new_off: window-local index (in tokens) of the first NEW token; the
    fixed-size slice may over-read into padding — the host trims.
    n_valid: traced count of valid window entries (the mask is built
    in-jit — a host-built mask array would cost one more host transfer
    per hop)."""
    token_mask = (
        jnp.arange(tokens_win.shape[1])[None, :] < n_valid
    ).astype(jnp.float32)
    if sfm:
        mel = flow_lib.sfm_inference_window(
            fparams, fcfg, key, tokens_win, token_mask,
            prompt_len, gen_start, spk, n_timesteps=n_timesteps,
        )
    else:
        mel = flow_lib.inference_window(
            fparams, fcfg, key, tokens_win, token_mask, prompt_feat,
            prompt_len, gen_start, spk, n_timesteps=n_timesteps,
        )
    r = fcfg.token_mel_ratio
    start = r * (prompt_len + new_off)
    return jax.lax.dynamic_slice(
        mel, (0, start, 0), (1, r * slice_len, mel.shape[2])
    )


@functools.partial(jax.jit, static_argnames=("hcfg",))
def _hift_hop(hparams, hcfg, key, mel, cache_source, hop_idx=None):
    """hop_idx: traced counter folded into the key IN-jit (an eager
    fold_in per hop costs host round trips)."""
    if hop_idx is not None:
        key = jax.random.fold_in(key, hop_idx)
    return hift_lib.inference(hparams, hcfg, key, mel, cache_source)


class CosyStreamSession:
    """One streaming utterance: feed text, iterate wav chunks.

    Parity: CosyVoice2Model.tts(stream=True) (cli/model.py:406-446) minus
    the thread pair — the LM chunk and the flow hop are two compiled
    programs dispatched back-to-back from one host loop; async dispatch
    already overlaps them."""

    def __init__(
        self,
        pipeline,  # infer.cosy_pipeline.CosyPipeline
        stream_cfg: StreamConfig = StreamConfig(),
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        seed: int = 0,
    ):
        self.pipe = pipeline
        self.scfg = stream_cfg
        self.fcfg = pipeline.flow_cfg
        self.hcfg = pipeline.hift_cfg
        if stream_cfg.sfm and "sfm_head" not in pipeline.flow_params:
            # refuse rather than silently running plain CFM at the
            # SFM-tuned low step count (degraded audio mislabeled "sfm")
            raise ValueError(
                "StreamConfig.sfm=True but flow_params has no 'sfm_head' "
                "(cfg.sfm checkpoint required); unset sfm or load an "
                "SFM-trained flow"
            )
        self.seed = seed
        self.prompt_tokens = np.asarray(prompt_speech_tokens, np.int64)
        if spk_embedding is None:
            spk_embedding = np.zeros((self.fcfg.spk_embed_dim,), np.float32)
        self.spk = jnp.asarray(spk_embedding[None])
        P = len(self.prompt_tokens)
        if prompt_mel is None:
            prompt_mel = np.zeros(
                (self.fcfg.token_mel_ratio * P, self.fcfg.output_size),
                np.float32,
            )
        self.prompt_mel = jnp.asarray(prompt_mel[None])
        self.P = P
        la = self.fcfg.pre_lookahead_len
        self.la = la
        h = stream_cfg.token_hop_len
        self.hop_cap = max(stream_cfg.hop_max or h, h)
        # ramp slice lengths (static jit arg -> one compiled flow program
        # each): the doubling stages. The final remainder (at most
        # cur_hop + la - 1 <= hop_cap + la - 1 tokens) fits the largest
        # stage's slice. With hop_max=None this degenerates to the single
        # round-3 shape {h + la} — no extra padded flow compute on the
        # fixed-hop path.
        stages = [h]
        while stages[-1] < self.hop_cap:
            stages.append(min(2 * stages[-1], self.hop_cap))
        self._slice_lens = [s + la for s in stages]
        # upper bound across stages (diagnostics only; _window_mel sizes
        # the actual buffer per stage)
        self.gen_cap = stream_cfg.ctx_tokens + self._slice_lens[-1]
        self.cap = P + self.gen_cap
        self.cur_hop = h  # doubles per emitted hop up to hop_cap
        # vocoder caches (reference hift_cache_dict, cli/model.py:374-395)
        up = self.hcfg.total_upsample
        self.scl = stream_cfg.mel_cache_len * up
        self.window = np.hamming(2 * self.scl)
        self.mel_cache: Optional[np.ndarray] = None  # (1, 8, 80)
        self.source_cache: Optional[np.ndarray] = None  # (1, scl)
        self.speech_cache: Optional[np.ndarray] = None  # (1, scl)
        self.token_offset = 0
        self.hop_idx = 0
        self._mel_accum: list = []  # pending hops for batched vocoding
        # device keys made ONCE: eager PRNGKey/fold_in inside the hop loop
        # would cost host<->device round trips per hop
        self._flow_key = jax.random.PRNGKey(seed)
        self._hift_key = jax.random.PRNGKey(seed + 1)

    # -- flow stage -------------------------------------------------------

    def _window_mel(self, tokens: np.ndarray, off: int, n_new: int) -> np.ndarray:
        """Mel for tokens[off : off+n_new] conditioned on the bounded window."""
        scfg, fcfg = self.scfg, self.fcfg
        end = min(off + n_new + self.la, len(tokens))
        w0 = max(0, off - scfg.ctx_tokens)
        gen_win = tokens[w0:end]
        n_valid = self.P + len(gen_win)
        # static slice length: the smallest ramp-stage slice that covers
        # n_new — the precomputed set bounds the compiled flow programs.
        # The window BUFFER is sized per stage too: the conformer encodes
        # the whole padded window, so a buffer sized for the largest stage
        # would make every hop (incl. the TTFA-critical first one) pay the
        # max-stage cost.
        slice_len = next(s for s in self._slice_lens if s >= n_new)
        cap = self.P + scfg.ctx_tokens + slice_len
        buf = np.zeros((1, cap), np.int32)
        buf[0, : self.P] = self.prompt_tokens
        buf[0, self.P : n_valid] = gen_win
        sfm = scfg.sfm  # __init__ guarantees sfm_head exists when set
        mel = _flow_hop(
            self.pipe.flow_params, fcfg,
            self._flow_key,
            jnp.asarray(buf), np.int32(n_valid), self.prompt_mel,
            self.P, np.int32(w0), np.int32(off - w0), slice_len,
            self.spk, scfg.n_timesteps, sfm,
        )
        return np.asarray(mel)[:, : fcfg.token_mel_ratio * n_new]

    # -- vocoder stage ----------------------------------------------------

    def _vocode(self, new_mel: np.ndarray, finalize: bool) -> np.ndarray:
        """HiFT with mel/source caches + Hamming crossfade
        (cli/model.py:372-404)."""
        hop_frames = self.fcfg.token_mel_ratio * self.scfg.token_hop_len
        n_real = new_mel.shape[1]
        # edge-pad the final partial chunk UP to a whole number of hops (one
        # compiled HiFT program per hop-count, not per remainder length);
        # the padded tail is trimmed from the emitted wav below. n_real == 0
        # (utterance length an exact hop multiple) still flushes the
        # held-back crossfade tail, like the reference's final token2wav
        # with empty remain tokens (cli/model.py:437-446).
        pad_to = max(hop_frames, -(-n_real // hop_frames) * hop_frames)
        if finalize and n_real < pad_to:
            edge = (
                new_mel[:, -1:]
                if n_real > 0
                else np.asarray(self.mel_cache[:, -1:])
            )
            new_mel = np.concatenate(
                [new_mel, np.repeat(edge, pad_to - n_real, 1)], 1
            )
        if self.mel_cache is not None:
            mel_in = np.concatenate([self.mel_cache, new_mel], axis=1)
        else:
            mel_in = new_mel
        cache_src = (
            jnp.asarray(self.source_cache)
            if self.source_cache is not None
            else jnp.zeros((1, 0))
        )
        wav, source = _hift_hop(
            self.pipe.hift_params, self.hcfg, self._hift_key,
            jnp.asarray(mel_in), cache_src, np.int32(self.hop_idx),
        )
        wav = np.array(wav)  # copy: np.asarray(jax) is read-only
        source = np.array(source)
        if self.speech_cache is not None:
            scl = self.scl
            wav[:, :scl] = (
                wav[:, :scl] * self.window[:scl]
                + self.speech_cache * self.window[scl:]
            )
        up = self.hcfg.total_upsample
        if finalize:
            out = wav[0, : (mel_in.shape[1] - (new_mel.shape[1] - n_real)) * up]
        else:
            out = wav[0, : -self.scl]
            self.mel_cache = mel_in[:, -self.scfg.mel_cache_len :]
            self.source_cache = source[:, -self.scl :]
            self.speech_cache = wav[:, -self.scl :]
        self.hop_idx += 1
        return out

    # -- hop driver -------------------------------------------------------

    def emit_ready(self, tokens: np.ndarray, lm_done: bool):
        """Yield wav chunks for every complete hop available in `tokens`.

        The FIRST available hop is vocoded immediately (TTFA); afterwards
        hops accumulate in groups of `vocode_every` per HiFT call — the
        vocoder is fixed-cost-bound at hop size, so
        batching cuts its steady-state share ~K×."""
        K = max(1, self.scfg.vocode_every)
        while len(tokens) - self.token_offset >= self.cur_hop + self.la:
            hop = self.cur_hop
            mel = self._window_mel(tokens, self.token_offset, hop)
            self.token_offset += hop
            self.cur_hop = min(2 * hop, self.hop_cap)  # ramp
            if self.mel_cache is None and not self._mel_accum:
                yield self._vocode(mel, finalize=False)
            else:
                self._mel_accum.append(mel)
                if len(self._mel_accum) >= K:
                    yield self._vocode(
                        np.concatenate(self._mel_accum, 1), finalize=False
                    )
                    self._mel_accum = []
        if lm_done:
            n_rem = len(tokens) - self.token_offset
            mels = self._mel_accum
            self._mel_accum = []
            if n_rem > 0:
                mels.append(self._window_mel(tokens, self.token_offset, n_rem))
            self.token_offset = len(tokens)
            if mels:
                yield self._vocode(np.concatenate(mels, 1), finalize=True)
            elif self.mel_cache is not None:
                yield self._vocode(
                    np.zeros((1, 0, self.fcfg.output_size), np.float32),
                    finalize=True,
                )


def stream_synthesize(
    pipeline,
    text: str,
    prompt_text: str = "",
    prompt_wav: Optional[np.ndarray] = None,
    prompt_speech_tokens: Sequence[int] = (),
    prompt_mel: Optional[np.ndarray] = None,
    spk_embedding: Optional[np.ndarray] = None,
    stream_cfg: StreamConfig = StreamConfig(),
    seed: int = 0,
    max_new_tokens: int = 2048,
    top_p: float = 0.8,
    top_k: int = 25,
) -> Generator[np.ndarray, None, None]:
    """Streaming zero-shot TTS: yields wav chunks as the LM decodes.

    First audio is emitted after ~(hop + lookahead) tokens instead of after
    the full utterance; LM work stops at EOS (chunked early exit)."""
    if prompt_wav is not None:
        prompt_speech_tokens, prompt_mel, spk_embedding = (
            pipeline.frontend_zero_shot(prompt_wav)
        )
    sess = CosyStreamSession(
        pipeline, stream_cfg, prompt_speech_tokens, prompt_mel, spk_embedding,
        seed=seed,
    )

    text_ids = pipeline.tok.encode(prompt_text) + pipeline.tok.encode(text)
    sample = cosy_collator.build_prompt(text_ids, list(prompt_speech_tokens))
    from rwkvtts_tpu.data.spark_collator import pad_prompts_left

    batch = pad_prompts_left([sample])
    # bucket the prompt length to a multiple of 64 (left-pad, mask 0) so
    # the prefill program compiles once per bucket, not once per text
    T = batch["tokens"].shape[1]
    cap = ((T + 63) // 64) * 64
    if cap != T:
        batch = {
            k: np.pad(np.asarray(v), ((0, 0), (cap - T, 0)))
            for k, v in batch.items()
        }
    content_len = cosy_collator.content_length(text_ids)
    min_len = int(content_len * 2)
    max_len = min(int(content_len * 20), max_new_tokens)

    carry = gen.cosy_prefill_carry(
        pipeline.lm_params, pipeline.lm_cfg,
        jnp.asarray(batch["tokens"]), jnp.asarray(batch["modality"]),
        jnp.asarray(batch["attention_mask"]),
    )
    key = jax.random.PRNGKey(seed)
    eos = pipeline.lm_cfg.eos_token_id
    tokens = np.zeros((0,), np.int64)
    n_decoded = 0
    lm_done = False

    def dispatch(carry, key):
        # chunk ramp: the TTFA-critical first chunk stays lm_chunk; once
        # audio is flowing, lm_chunk_max steps per dispatch (fewer fixed
        # per-dispatch round trips). Two compiled programs total.
        n = stream_cfg.lm_chunk
        if stream_cfg.lm_chunk_max and sess.hop_idx > 0:
            n = max(n, stream_cfg.lm_chunk_max)
        key, sub = jax.random.split(key)
        return key, gen.cosy_decode_chunk(
            pipeline.lm_params, pipeline.lm_cfg, carry, sub,
            chunk_len=n, min_new_tokens=min_len,
            top_k=top_k, top_p=top_p,
            rank_bf16=getattr(pipeline, "lm_rank_bf16", False),
        )

    key, pending = dispatch(carry, key)
    while not lm_done:
        carry, toks, done = pending
        # enqueue chunk N+1 BEFORE syncing chunk N — but only after the
        # first audio chunk is out (sess.hop_idx > 0): the device is
        # serial, so an early prefetch would run ahead of flow hop 0 and
        # delay first audio by a whole LM chunk.
        # Token order and key splits are identical to the sequential loop;
        # at most one post-EOS chunk of wasted device work per utterance.
        prefetched = stream_cfg.lm_prefetch and sess.hop_idx > 0
        if prefetched:
            key, pending = dispatch(carry, key)
        chunk = np.asarray(toks)[0]
        n_decoded += len(chunk)
        if bool(np.asarray(done)[0]):
            eos_pos = np.argmax(chunk == eos)
            chunk = chunk[:eos_pos] if np.any(chunk == eos) else chunk
            lm_done = True
        elif n_decoded >= max_len:
            lm_done = True
        if not lm_done and not prefetched:
            key, pending = dispatch(carry, key)
        tokens = np.concatenate([tokens, chunk.astype(np.int64)])
        yield from sess.emit_ready(tokens, lm_done)
