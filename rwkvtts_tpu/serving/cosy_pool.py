"""Slot-pool decoding + concurrent streaming for the Cosy LM.

The reference streams one utterance per engine thread (cli/model.py:406-446
llm_job/flow hop pair; service/tts_service.py one request per worker). Here
N concurrent STREAMS share ONE compiled chunk loop over a slot pool — the
continuous-batching engine of serving/continuous.py applied to the
CosyVoice LM (RAS sampling, per-row min-length EOS suppression) — and each
stream's tokens feed its own incremental-state vocoder session
(infer/streaming.CosyStreamSession, O(1) per hop). Decode cost per step is
nearly flat in occupied slots, so concurrent streams ride almost free until
the per-slot state traffic dominates the step.

Row purity: each row's sampling key is fold_in(PRNGKey(its seed), its own
step index), so a (prompt, seed) stream reproduces exactly no matter what
else shares the pool (tested: tests/test_cosy_pool.py).

v1 scope: single-device, no overlap mode (the Spark batcher carries both;
lift them here the same way if pooled streaming becomes the bottleneck).
"""
from __future__ import annotations

import dataclasses
import functools
import queue
import threading
import time
from typing import Any, Dict, Generator, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.models import cosy, rwkv7
from rwkvtts_tpu.ops import sampling
from rwkvtts_tpu.serving import pool_common


@dataclasses.dataclass
class _Slot:
    req_id: Optional[int] = None
    tokens: Optional[List[int]] = None
    max_new: int = 0


@functools.partial(jax.jit, donate_argnums=(0,))
def _insert_many(carry, hk, stk, recent0, slots, take, minvec, svec):
    """Swap the first `take` prefilled rows into slot positions (see
    serving/continuous._insert_many — same traced-count fori_loop, Cosy
    carry layout: h, st, done, recent, n, minlen, seed)."""

    def body(j, c):
        h, st, done, recent, n, minlen, seed = c
        slot = slots[j]

        def ins(cl, s):
            row = jax.lax.dynamic_slice_in_dim(s, j, 1, axis=0)
            idx = (slot,) + (jnp.int32(0),) * (cl.ndim - 1)
            return jax.lax.dynamic_update_slice(cl, row.astype(cl.dtype), idx)

        h = ins(h, hk)
        st = jax.tree.map(ins, st, stk)
        recent = ins(recent, recent0)
        done = done.at[slot].set(False)
        n = n.at[slot].set(0)
        minlen = minlen.at[slot].set(minvec[j])
        seed = seed.at[slot].set(svec[j])
        return (h, st, done, recent, n, minlen, seed)

    return jax.lax.fori_loop(0, take, body, carry)


@functools.partial(jax.jit, donate_argnums=(0,))
def _mark_done(carry, slot_mask):
    """Flip device-side done for slots retired host-side by the max cap."""
    h, st, done, n_rest = carry[0], carry[1], carry[2], carry[3:]
    return (h, st, done | slot_mask) + n_rest


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "chunk", "top_k", "top_p", "win_size", "tau_r"),
    donate_argnums=(1,),
)
def _decode_chunk(params, carry, cfg, chunk, top_k, top_p, win_size, tau_r):
    """One compiled chunk for the whole pool: RAS sampling with per-row
    keys, per-row min-length EOS suppression (reference cosy_llm.py:169-211
    semantics, batched)."""
    bb = cfg.backbone
    eos_id = cfg.eos_token_id

    def step(c, _):
        h, st, done, recent, n, minlen, seed = c
        logits = (h @ params["head"].astype(bb.dtype)).astype(jnp.float32)
        if "head_bias" in params:
            logits = logits + params["head_bias"].astype(jnp.float32)
        logits = jnp.where(
            (n < minlen)[:, None]
            & (jnp.arange(logits.shape[-1]) == eos_id)[None, :],
            sampling.NEG_INF,
            logits,
        )
        keys = jax.vmap(
            lambda s, i: jax.random.key_data(
                jax.random.fold_in(jax.random.key(s, impl="threefry2x32"), i)
            )
        )(seed, n)
        tok = sampling.ras_sample_rows(
            keys, logits, recent,
            top_p=top_p, top_k=top_k, win_size=win_size, tau_r=tau_r,
        )
        tok = jnp.where(done, eos_id, tok)
        done = done | (tok == eos_id)
        recent = jnp.concatenate([recent[:, 1:], tok[:, None]], axis=1)
        x = cosy.decode_embed(params, cfg, tok)
        h, st = rwkv7.decode_step(params, bb, x, st)
        return (h, st, done, recent, n + 1, minlen, seed), tok

    carry, toks = jax.lax.scan(step, carry, None, length=chunk)
    return carry, jnp.moveaxis(toks, 0, 1), carry[2]


class CosyPoolBatcher:
    """Slot-pool decoder for the Cosy LM with INCREMENTAL token delivery.

    step() returns events (req_id, new_tokens, done) — partial tokens every
    chunk, which is what streaming consumers need (the Spark batcher's
    step() only reports finished requests).
    """

    def __init__(
        self,
        params,
        cfg,
        n_slots: int = 8,
        chunk: int = 16,
        prompt_cap: int = 128,
        top_k: int = 25,
        top_p: float = 0.8,
        win_size: int = 10,
        tau_r: float = 0.1,
        seed: int = 0,
        overlap: bool = False,
    ):
        self.cfg = cfg
        bb = cfg.backbone
        self.params = params
        self.params_l = rwkv7.layer_decode_views(params, bb)
        self.n_slots = n_slots
        self.chunk = chunk
        self.prompt_cap = prompt_cap
        self.top_k, self.top_p = top_k, top_p
        self.win_size, self.tau_r = win_size, tau_r
        self.seed = seed
        self._next_id = 0
        # (rid, prompt_batch, max_new, min_new, seed)
        self._queue: List[
            Tuple[int, Dict[str, np.ndarray], int, int, int]
        ] = []
        self._slots = [_Slot() for _ in range(n_slots)]
        # overlap mode (continuous.py's double-buffering, same proof):
        # dispatch chunk N+1 BEFORE syncing chunk N's tokens, so the host
        # transfer hides behind the device's next chunk. Token-identical —
        # each row's key is a pure function of (request seed, step index).
        # Trade: events arrive one chunk later.
        self.overlap = overlap
        # pending (tokens_on_device, owners-at-dispatch); stale owners are
        # resolved via _active (request finished/cancelled meanwhile)
        self._pending: Optional[Tuple[Any, List[Optional[int]]]] = None
        self._active: Dict[int, _Slot] = {}

        def _prefill_packed(p, c, tokens, modality, mask):
            hk, st = cosy.prefill(p, c, tokens, modality, mask)
            return hk, rwkv7.pack_decode_state(st, c.backbone)

        self._prefill = jax.jit(_prefill_packed, static_argnames=("c",))
        self._carry = self._fresh_carry()

    def _fresh_carry(self):
        bb = self.cfg.backbone
        st = rwkv7.init_model_state(bb, self.n_slots)
        st = rwkv7.pack_decode_state(st, bb)
        return (
            jnp.zeros((self.n_slots, bb.hidden_size), bb.dtype),
            st,
            jnp.ones((self.n_slots,), bool),
            jnp.full((self.n_slots, self.win_size), -1, jnp.int32),
            jnp.zeros((self.n_slots,), jnp.int32),
            jnp.zeros((self.n_slots,), jnp.int32),
            jnp.full((self.n_slots,), self.seed, jnp.int32),
        )

    # -- client API -------------------------------------------------------

    def add_request(
        self,
        prompt_batch: Dict[str, np.ndarray],
        max_new_tokens: int,
        min_new_tokens: int = 0,
        seed: Optional[int] = None,
    ) -> int:
        rid = self._next_id
        self._next_id += 1
        self._queue.append((
            rid, prompt_batch, max_new_tokens,
            # int32-safe: oversized client values must not OverflowError
            # on the pool thread at admission (pool_common)
            pool_common.clamp_i32(min_new_tokens),
            pool_common.clamp_seed(self.seed if seed is None else seed),
        ))
        return rid

    def idle(self) -> bool:
        return (
            not self._queue
            and all(s.req_id is None for s in self._slots)
            and self._pending is None
        )

    def warmup(self, prompt_widths: Optional[List[int]] = None):
        """Precompile every program (see continuous.ContinuousBatcher);
        widths round up to the admission buckets."""
        for width in pool_common.warmup_widths(prompt_widths, self.prompt_cap):
            dummy = {
                "tokens": np.zeros((1, width), np.int32),
                "modality": np.zeros((1, width), np.int32),
                "attention_mask": np.ones((1, width), np.int32),
            }
            bucket = 1
            while True:
                pb = {k: np.repeat(v, bucket, 0) for k, v in dummy.items()}
                hk, stk = self._prefill(
                    self.params, self.cfg, pb["tokens"], pb["modality"],
                    pb["attention_mask"],
                )
                self._carry = _insert_many(
                    self._carry, hk, stk,
                    np.full((bucket, self.win_size), -1, np.int32),
                    np.zeros((bucket,), np.int32), np.int32(0),
                    np.zeros((bucket,), np.int32), np.zeros((bucket,), np.int32),
                )
                if bucket >= self.n_slots:
                    break
                bucket *= 2
        self._carry, _, _ = _decode_chunk(
            self.params_l, self._carry, self.cfg, self.chunk,
            self.top_k, self.top_p, self.win_size, self.tau_r,
        )
        self._carry = _mark_done(self._carry, np.zeros(self.n_slots, bool))
        self._carry = self._fresh_carry()

    # -- engine -----------------------------------------------------------

    def _pad_prompt(self, batch):
        return pool_common.pad_prompt(batch, self.prompt_cap)

    def _admit(self):
        free = [i for i, s in enumerate(self._slots) if s.req_id is None]
        if not free or not self._queue:
            return
        take = min(len(free), len(self._queue))
        reqs = [self._queue.pop(0) for _ in range(take)]
        bucket = 1
        while bucket < take:
            bucket *= 2
        pbs = [self._pad_prompt(b) for _, b, _, _, _ in reqs]
        pbs += [pbs[-1]] * (bucket - take)
        slot_ids = [free[j] for j in range(take)]
        slot_ids += [slot_ids[-1]] * (bucket - take)
        minvec = np.zeros((bucket,), np.int32)
        svec = np.zeros((bucket,), np.int32)
        for j, (_, _, _, mn, s) in enumerate(reqs):
            minvec[j], svec[j] = mn, s
        stacked = pool_common.stack_admission(pbs)
        hk, stk = self._prefill(
            self.params, self.cfg, stacked["tokens"], stacked["modality"],
            stacked["attention_mask"],
        )
        self._carry = _insert_many(
            self._carry, hk, stk,
            np.full((bucket, self.win_size), -1, np.int32),
            np.asarray(slot_ids, np.int32), np.int32(take), minvec, svec,
        )
        for j, (rid, _, max_new, _, _) in enumerate(reqs):
            rec = _Slot(req_id=rid, tokens=[], max_new=max_new)
            self._slots[free[j]] = rec
            self._active[rid] = rec  # shared record: slot index can go stale

    def _process(
        self, toks: np.ndarray, owners: List[Optional[int]]
    ) -> List[Tuple[int, np.ndarray, bool]]:
        """Turn one chunk's tokens into (rid, NEW tokens, done) events.
        `owners` is the slot->rid map AT DISPATCH TIME: in overlap mode an
        owner can be stale (finished/cancelled off an earlier chunk), in
        which case its row is EOS padding and is discarded."""
        eos = self.cfg.eos_token_id
        events: List[Tuple[int, np.ndarray, bool]] = []
        capped = np.zeros(self.n_slots, bool)
        for i, rid in enumerate(owners):
            if rid is None:
                continue
            s = self._active.get(rid)
            if s is None:
                continue
            row = toks[i]
            hit = np.flatnonzero(row == eos)
            new = row[: hit[0]] if hit.size else row
            room = s.max_new - len(s.tokens)
            new = new[:room]
            s.tokens.extend(int(t) for t in new)
            done = bool(hit.size) or len(s.tokens) >= s.max_new
            events.append((rid, new.astype(np.int64), done))
            if done:
                self._active.pop(rid)
                if self._slots[i].req_id == rid:
                    self._slots[i] = _Slot()
                if not hit.size:
                    capped[i] = True
        if capped.any():
            self._carry = _mark_done(self._carry, capped)
        return events

    def step(self) -> List[Tuple[int, np.ndarray, bool]]:
        """Admit, decode one chunk, return (req_id, NEW tokens, done) per
        active request — done requests' slots are freed. With overlap=True
        the returned events are the PREVIOUS chunk's (the fresh chunk syncs
        on the next call while the device keeps working)."""
        self._admit()
        active = any(s.req_id is not None for s in self._slots)
        if self.overlap:
            pending, self._pending = self._pending, None
            if active:
                self._carry, toks_dev, _ = _decode_chunk(
                    self.params_l, self._carry, self.cfg, self.chunk,
                    self.top_k, self.top_p, self.win_size, self.tau_r,
                )
                self._pending = (toks_dev, [s.req_id for s in self._slots])
            if pending is None:
                return []
            return self._process(np.asarray(pending[0]), pending[1])
        if not active:
            return []
        self._carry, toks_dev, _ = _decode_chunk(
            self.params_l, self._carry, self.cfg, self.chunk,
            self.top_k, self.top_p, self.win_size, self.tau_r,
        )
        return self._process(
            np.asarray(toks_dev), [s.req_id for s in self._slots]
        )

    def cancel(self, rid: int) -> None:
        """Stop decoding a request (client went away): free its slot and
        flip the device done flag so it stops burning chunk work."""
        self._queue = [q for q in self._queue if q[0] != rid]
        self._active.pop(rid, None)
        capped = np.zeros(self.n_slots, bool)
        for i, s in enumerate(self._slots):
            if s.req_id == rid:
                self._slots[i] = _Slot()
                capped[i] = True
        if capped.any():
            self._carry = _mark_done(self._carry, capped)

    def drain(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        acc: Dict[int, List[int]] = {}
        while not self.idle():
            for rid, new, done in self.step():
                acc.setdefault(rid, []).extend(new.tolist())
                if done:
                    out[rid] = acc.pop(rid)
        return out


class CosyStreamHub:
    """N concurrent streaming utterances over ONE slot pool.

    Each stream: admit the LM prompt into the shared pool, feed the growing
    token array into a per-stream CosyStreamSession (incremental flow/HiFT,
    O(1) per hop), yield wav chunks. A single pump thread advances the pool;
    vocoder hops run on the consumer threads so slow readers don't stall
    the LM chunk loop.
    """

    def __init__(self, pipeline, n_slots: int = 8, chunk: int = 16,
                 prompt_cap: int = 128, top_k: int = 25, top_p: float = 0.8,
                 warmup: bool = False, warmup_widths=None,
                 overlap: bool = False, stream_cfg=None,
                 first_chunk_priority: bool = True):
        self.pipe = pipeline
        # TTFA fairness on the ONE serial device: streams that already
        # produced audio briefly defer their vocoder hops while any
        # admitted stream still awaits its FIRST chunk. The pool decodes
        # all slots in lockstep, so every first hop becomes ready at once
        # — without this, early streams' hop-2+ vocodes queue AHEAD of
        # late streams' first chunks. Steady streams hold >=
        # one hop of audio, so a bounded defer cannot underrun playback.
        self.first_chunk_priority = first_chunk_priority
        self._first_pending: set = set()
        self._first_cv = threading.Condition()
        # hub-wide vocoder/flow streaming config (infer/streaming.
        # StreamConfig): the solo-stream levers — SFM few-step flow, small
        # ctx window, vocode_every hop batching — apply per SESSION, so
        # without this every pooled stream paid the CFM-10/ctx-100/
        # vocode-1 defaults while solo streaming ran SFM-5/ctx-50/
        # vocode-2. Per-call
        # `stream_cfg` overrides; `hop_tokens` overrides the hop only.
        self.stream_cfg = stream_cfg
        self.batcher = CosyPoolBatcher(
            pipeline.lm_params, pipeline.lm_cfg, n_slots=n_slots,
            chunk=chunk, prompt_cap=prompt_cap, top_k=top_k, top_p=top_p,
            overlap=overlap,
        )
        if warmup:
            self.batcher.warmup(warmup_widths)
        self._sinks: Dict[int, "queue.Queue"] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._pump = threading.Thread(target=self._run, daemon=True)
        self._pump.start()

    def close(self):
        self._stop.set()
        self._wake.set()
        self._pump.join(timeout=5)
        # unblock any consumer still waiting on its queue
        with self._lock:
            for q in self._sinks.values():
                q.put((np.zeros((0,), np.int64), True, "hub closed"))

    def _fail_all(self, err: str):
        """Pool-level failure containment: answer every live stream with
        the error and reset the engine, instead of dying silently and
        hanging every q.get() forever (the dispatcher-thread analogue of
        ContinuousTTSService._run's containment)."""
        with self._lock:
            sinks = dict(self._sinks)
            b = self.batcher
            b._queue.clear()
            b._slots = [_Slot() for _ in range(b.n_slots)]
            b._carry = b._fresh_carry()
            b._active.clear()
            b._pending = None
        for q in sinks.values():
            q.put((np.zeros((0,), np.int64), True, err))
        with self._first_cv:
            self._first_pending.clear()
            self._first_cv.notify_all()

    def _run(self):
        while not self._stop.is_set():
            with self._lock:
                idle = self.batcher.idle()
            if idle:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                with self._lock:
                    events = self.batcher.step()
            except Exception as e:  # noqa: BLE001 — the pump must survive
                self._fail_all(f"pool decode failed: {e}")
                continue
            for rid, new, done in events:
                q = self._sinks.get(rid)
                if q is not None:
                    q.put((new, done, None))

    def stream(
        self,
        text: str,
        prompt_text: str = "",
        prompt_wav: Optional[np.ndarray] = None,
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        hop_tokens: int = 25,
        seed: int = 0,
        max_new_tokens: int = 2048,
        timeout: Optional[float] = None,
        stream_cfg=None,
    ) -> Generator[np.ndarray, None, None]:
        """One streaming utterance; safe to call from many threads at once.
        Mirrors infer/streaming.stream_synthesize, LM stage pooled.
        `timeout` bounds the WHOLE stream (seconds); on expiry the request
        is cancelled and a TimeoutError raised. A pool-level decode failure
        surfaces as RuntimeError instead of a silent hang. `stream_cfg`
        (per-call) or the hub-level default set the vocoder/flow levers;
        `hop_tokens` overrides the hop on the hub default only."""
        import dataclasses as _dc

        from rwkvtts_tpu.data import cosy_collator
        from rwkvtts_tpu.data.spark_collator import pad_prompts_left
        from rwkvtts_tpu.infer import streaming

        if prompt_wav is not None:
            prompt_speech_tokens, prompt_mel, spk_embedding = (
                self.pipe.frontend_zero_shot(prompt_wav)
            )
        if stream_cfg is not None:
            scfg = stream_cfg
        elif self.stream_cfg is not None:
            scfg = _dc.replace(self.stream_cfg, token_hop_len=hop_tokens)
        else:
            scfg = streaming.StreamConfig(token_hop_len=hop_tokens)
        sess = streaming.CosyStreamSession(
            self.pipe, scfg, prompt_speech_tokens, prompt_mel, spk_embedding,
            seed=seed,
        )
        text_ids = self.pipe.tok.encode(prompt_text) + self.pipe.tok.encode(text)
        sample = cosy_collator.build_prompt(
            text_ids, list(prompt_speech_tokens)
        )
        batch = pad_prompts_left([sample])
        content_len = cosy_collator.content_length(text_ids)
        min_len = int(content_len * 2)
        max_len = min(int(content_len * 20), max_new_tokens)

        q: "queue.Queue" = queue.Queue()
        with self._lock:
            rid = self.batcher.add_request(
                batch, max_len, min_new_tokens=min_len, seed=seed
            )
            self._sinks[rid] = q
        if self.first_chunk_priority:
            with self._first_cv:
                self._first_pending.add(rid)
        self._wake.set()
        tokens = np.zeros((0,), np.int64)
        done = False
        emitted = False
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                try:
                    new, done, err = q.get(
                        timeout=None if deadline is None
                        else max(deadline - time.monotonic(), 0.001)
                    )
                except queue.Empty:
                    raise TimeoutError(
                        f"stream exceeded {timeout}s"
                    ) from None
                if err is not None:
                    raise RuntimeError(err)
                if len(new):
                    tokens = np.concatenate([tokens, new])
                if emitted and self.first_chunk_priority:
                    # bounded politeness: let pending first chunks take
                    # the device first (never blocks pre-first streams).
                    # Patience is a fraction of THIS stream's buffered hop
                    # audio (hop_tokens at 25 Hz) so a full-patience defer
                    # cannot underrun the client's playback, and the
                    # stream's own deadline is honored.
                    hop_audio = scfg.token_hop_len / 25.0
                    patience = time.monotonic() + min(1.5, 0.6 * hop_audio)
                    if deadline is not None:
                        patience = min(patience, deadline)
                    with self._first_cv:
                        while (self._first_pending
                               and time.monotonic() < patience):
                            self._first_cv.wait(timeout=0.05)
                for chunk_wav in sess.emit_ready(tokens, lm_done=done):
                    if not emitted:
                        emitted = True
                        with self._first_cv:
                            self._first_pending.discard(rid)
                            self._first_cv.notify_all()
                    yield chunk_wav
                if done:
                    return
        finally:
            self._sinks.pop(rid, None)
            with self._first_cv:
                self._first_pending.discard(rid)
                self._first_cv.notify_all()
            if not done:
                # consumer abandoned mid-stream: stop burning the slot
                with self._lock:
                    self.batcher.cancel(rid)
