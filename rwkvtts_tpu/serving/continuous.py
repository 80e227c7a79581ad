"""Continuous (in-flight) batching for RWKV decode serving.

The reference serves with a thread pool of independent engines
(service/tts_service.py) and our BatchedTTSService groups same-voice
requests into one static batch. This module goes further: a fixed pool of
B decode SLOTS runs one compiled chunk loop forever, and new requests are
swapped into finished slots between chunks — the "continuous batching" of
modern LLM serving. RWKV makes the swap unusually clean: per-sequence
state is a fixed-size pytree (no paged KV cache, no length-dependent
allocation), so admitting a request is one `dynamic_update_slice` per
state leaf.

Throughput intuition: decode cost per step is nearly flat in occupied
slots while the step is bound by reading the weights (the batch dim rides
free until the per-slot state traffic dominates), so keeping slots full
converts latency into throughput without per-request batching delays.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.models import rwkv7, spark
from rwkvtts_tpu.ops import sampling
from rwkvtts_tpu.serving import pool_common


@dataclasses.dataclass
class _Slot:
    req_id: Optional[int] = None
    tokens: Optional[List[int]] = None
    max_new: int = 0


@functools.partial(jax.jit, donate_argnums=(0,))
def _insert_many(carry, hk, stk, slots, take, tvec, pvec, svec):
    """Swap the first `take` prefilled requests (rows of hk/stk) into batch
    positions `slots[j]`, along with each request's sampling params
    (tvec/pvec/svec: per-request temperature / top-p / seed). A fori_loop
    with a TRACED count: one small compiled program per prefill-batch
    shape, regardless of how many requests are admitted."""

    def body(j, c):
        h, st, done, n, temp, topp, seed = c
        slot = slots[j]

        def ins(cl, s):
            row = jax.lax.dynamic_slice_in_dim(s, j, 1, axis=0)
            idx = (slot,) + (jnp.int32(0),) * (cl.ndim - 1)
            return jax.lax.dynamic_update_slice(cl, row.astype(cl.dtype), idx)

        h = ins(h, hk)
        st = jax.tree.map(ins, st, stk)
        done = done.at[slot].set(False)
        n = n.at[slot].set(0)
        temp = temp.at[slot].set(tvec[j])
        topp = topp.at[slot].set(pvec[j])
        seed = seed.at[slot].set(svec[j])
        return (h, st, done, n, temp, topp, seed)

    return jax.lax.fori_loop(0, take, body, carry)


@functools.partial(jax.jit, donate_argnums=(0,))
def _mark_done(carry, slot_mask):
    """Set the device-side done flag for retired slots. Without this a slot
    freed host-side by the max_new cap (no EOS sampled) keeps decoding
    discarded tokens every chunk until a new request lands in it — wasted
    compute. One tiny program, amortized over the whole pool."""
    h, st, done, n, temp, topp, seed = carry
    return (h, st, done | slot_mask, n, temp, topp, seed)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "chunk", "top_k"),
    donate_argnums=(1,),
)
def _decode_chunk(params, carry, cfg, chunk: int, top_k: int):
    """Temperature/top-p/seed ride PER SLOT in the carry (traced vectors),
    so a pool of mixed requests samples with each request's own params in
    one compiled program; top_k is the static cap (rows express smaller
    effective k through top_p).

    Each row's sampling key is fold_in(PRNGKey(its seed), its own step
    index n) — a pure function of the REQUEST, not of pool cohabitation,
    admission timing, or chunk boundaries. The same (prompt, seed) request
    therefore reproduces exactly no matter what else shares the pool
    (tested: test_continuous.py::test_seed_determinism_across_pool_mixes)."""
    step = _make_pool_step(params, cfg, top_k)
    carry, toks = jax.lax.scan(step, carry, None, length=chunk)
    return carry, jnp.moveaxis(toks, 0, 1), carry[2]


def _make_pool_step(params, cfg, top_k: int):
    """One slot-pool decode step (head -> per-slot sampling -> EOS
    bookkeeping -> backbone)."""
    bb = cfg.backbone
    eos_id = cfg.eos_token_id

    def step(c, _):
        h, st, done, n, temp, topp, seed = c
        logits = (h @ params["head"].astype(bb.dtype)).astype(jnp.float32)
        keys = jax.vmap(
            lambda s, i: jax.random.key_data(
                jax.random.fold_in(
                    jax.random.key(s, impl="threefry2x32"), i
                )
            )
        )(seed, n)
        tok = sampling.sample_rows(
            keys, logits, temperature=temp, top_k=top_k, top_p=topp
        )
        tok = jnp.where(done, eos_id, tok)
        done = done | (tok == eos_id)
        x = spark.decode_embed(params, cfg, tok)
        h, st = rwkv7.decode_step(params, bb, x, st)
        return (h, st, done, n + 1, temp, topp, seed), tok

    return step


class ContinuousBatcher:
    """Slot-pool decoder for the Spark speech LM.

    Usage:
        cb = ContinuousBatcher(params, cfg, n_slots=8)
        rid = cb.add_request(prompt_batch, max_new_tokens=256)
        while not cb.idle():
            for req_id, toks in cb.step():
                ...  # finished sequences
    """

    def __init__(
        self,
        params,
        cfg,
        n_slots: int = 8,
        chunk: int = 16,
        prompt_cap: int = 128,
        temperature: float = 1.0,
        top_k: int = 1,  # greedy default: deterministic serving
        top_p: float = 1.0,
        seed: int = 0,
        mesh: Optional[jax.sharding.Mesh] = None,
        overlap: bool = False,
    ):
        self.cfg = cfg
        bb = cfg.backbone
        self.mesh = mesh
        if mesh is not None:
            # dp-sharded slot pool: the slot axis of every carry leaf is
            # split over the mesh's "dp" axis and params are replicated, so
            # one chunk program decodes n_slots rows across all the cards
            # (the multi-card version of this engine; the reference's
            # thread-pool service has no multi-GPU story at all,
            # service/tts_service.py:14-120). Decode-step math is
            # batch-row-independent, so sharded output is bit-identical to
            # single-device (tests/test_continuous.py, test_sharded_decode).
            if n_slots % mesh.shape["dp"] != 0:
                raise ValueError(
                    f"n_slots={n_slots} not divisible by dp={mesh.shape['dp']}"
                )
            from jax.sharding import NamedSharding, PartitionSpec

            self._repl = NamedSharding(mesh, PartitionSpec())
            self._slot_sh = lambda x: NamedSharding(
                mesh, PartitionSpec("dp", *([None] * (x.ndim - 1)))
            )
            params = jax.device_put(params, self._repl)
        # stacked params for prefill (scan-over-layers forward), layered
        # views for the decode chunk (per-layer state leaves)
        self.params = params
        self.params_l = rwkv7.layer_decode_views(params, bb)
        self.n_slots = n_slots
        self.chunk = chunk
        self.prompt_cap = prompt_cap
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.seed = seed  # default per-request seed
        self._next_id = 0
        # (rid, prompt_batch, max_new, temperature, top_p, seed)
        self._queue: List[
            Tuple[int, Dict[str, np.ndarray], int, float, float, int]
        ] = []
        self._slots = [_Slot() for _ in range(n_slots)]

        # prefill + pack_decode_state as ONE jitted program: the per-layer
        # state split would otherwise run as ~3*L eager dispatches per
        # admission
        def _prefill_packed(p, c, tokens, modality, mask):
            hk, st = spark.prefill(p, c, tokens, modality, mask)
            return hk, rwkv7.pack_decode_state(st, c.backbone)

        self._prefill = jax.jit(_prefill_packed, static_argnames=("c",))
        self._carry = self._fresh_carry()
        # overlap mode: dispatch chunk N+1 BEFORE syncing chunk N's tokens,
        # so the host transfer + post-processing hide behind the device's
        # next chunk (async dispatch). Outputs are IDENTICAL to the
        # unoverlapped pool: each row's sampling key is a pure function of
        # (its request's seed, its own on-device step index), so the
        # one-chunk-later slot free/readmission cannot change any draw
        # (tests/test_continuous.py::test_overlap_matches_sequential).
        # Trade: requests finish one chunk later (latency) and a freed
        # slot idles one extra chunk (occupancy) — a win when the host
        # sync is expensive relative to the chunk.
        self.overlap = overlap
        # pending (tokens_on_device, owners-at-dispatch); owners can go
        # stale if a request finished meanwhile -> resolved via _active
        self._pending: Optional[Tuple[Any, List[Optional[int]]]] = None
        self._active: Dict[int, _Slot] = {}
        # step() time/occupancy breakdown (reset_stats() to clear):
        #   admit_s  host prep + prefill dispatch+sync for admissions
        #   chunk_s  decode-chunk dispatch + device + token transfer (the
        #            np.asarray sync bounds it)
        #   host_s   python post-processing of finished rows
        #   active_rows / (chunks * n_slots) = slot occupancy
        self.stats = {
            "admit_s": 0.0, "chunk_s": 0.0, "host_s": 0.0,
            "chunks": 0, "active_rows": 0, "admitted": 0,
        }
        # guards stats against a concurrent /api/stats snapshot observing
        # a chunk whose time/rows aren't recorded yet
        self._stats_lock = threading.Lock()

    def _fresh_carry(self):
        bb = self.cfg.backbone
        st = rwkv7.pack_decode_state(
            rwkv7.init_model_state(bb, self.n_slots), bb
        )
        carry = (
            jnp.zeros((self.n_slots, bb.hidden_size), bb.dtype),
            st,
            jnp.ones((self.n_slots,), bool),  # empty slots count as done
            jnp.zeros((self.n_slots,), jnp.int32),
            jnp.full((self.n_slots,), self.temperature, jnp.float32),
            jnp.full((self.n_slots,), self.top_p, jnp.float32),
            jnp.full((self.n_slots,), self.seed, jnp.int32),
        )
        if self.mesh is not None:
            carry = jax.tree.map(
                lambda x: jax.device_put(x, self._slot_sh(x)), carry
            )
        return carry

    def _insert(self, hk, stk, slots, take, tvec, pvec, svec):
        return _insert_many(
            self._carry, hk, stk, slots, take, tvec, pvec, svec
        )

    def _chunk(self):
        return _decode_chunk(
            self.params_l, self._carry, self.cfg, self.chunk, self.top_k
        )

    # -- client API -------------------------------------------------------

    def add_request(
        self,
        prompt_batch: Dict[str, np.ndarray],
        max_new_tokens: int,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        seed: Optional[int] = None,
    ) -> int:
        """prompt_batch: a B=1 left-padded batch ({tokens, modality,
        attention_mask}) as produced by spark_collator.pad_prompts_left.
        temperature/top_p/seed default to the pool-level values; they ride
        in the slot carry, so mixed-request sampling params cost nothing —
        and a (prompt, seed) pair reproduces exactly regardless of what
        else shares the pool."""
        rid = self._next_id
        self._next_id += 1
        self._queue.append((
            rid, prompt_batch, max_new_tokens,
            self.temperature if temperature is None else float(temperature),
            self.top_p if top_p is None else float(top_p),
            # int32-safe: an oversized client seed must not OverflowError
            # on the dispatcher thread (pool_common.clamp_seed)
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
        """Compile every program ahead of serving: the prefill at each
        power-of-two admission size (for every width in `prompt_widths`,
        default just prompt_cap — pass the larger power-of-two widths your
        traffic can reach so a long prompt never compiles at admission
        time), the insert loop, the decode chunk, and the retire-by-cap
        flag update. One-time cost (persisted by the jit cache); call
        before taking traffic so admissions never stall on a compile.
        Widths round up to the admission buckets (prompt_cap doubled), so
        --warmup-widths 200 warms the width-256 program real prompts use."""
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
                self._carry = self._insert(
                    hk, stk,
                    np.zeros((bucket,), np.int32), np.int32(0),
                    np.ones((bucket,), np.float32),
                    np.ones((bucket,), np.float32),
                    np.zeros((bucket,), np.int32),
                )
                if bucket >= self.n_slots:
                    break
                bucket *= 2
        self._carry, _, _ = self._chunk()
        # a request retired by its max_new cap (no EOS) fires _mark_done
        # mid-serving — compile it now, not on the first capped request
        self._carry = _mark_done(self._carry, np.zeros(self.n_slots, bool))
        # reset engine state touched by the warmup chunk
        self._carry = self._fresh_carry()

    # -- engine -----------------------------------------------------------

    def _pad_prompt(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return pool_common.pad_prompt(batch, self.prompt_cap)

    def _admit(self):
        """Admit as many queued requests as there are free slots with ONE
        batched prefill (a per-request B=1 prefill costs a full host->
        device dispatch each)."""
        free = [i for i, s in enumerate(self._slots) if s.req_id is None]
        if not free or not self._queue:
            return
        take = min(len(free), len(self._queue))
        reqs = [self._queue.pop(0) for _ in range(take)]
        # pad the admission batch to a power of two: bounds the number of
        # distinct prefill shapes (compiles); rows beyond `take` are inert
        # (the insert loop stops at `take`)
        bucket = 1
        while bucket < take:
            bucket *= 2
        pbs = [self._pad_prompt(b) for _, b, _, _, _, _ in reqs]
        pbs += [pbs[-1]] * (bucket - take)
        slot_ids = [free[j] for j in range(take)]
        slot_ids += [slot_ids[-1]] * (bucket - take)
        tvec = np.ones((bucket,), np.float32)
        pvec = np.ones((bucket,), np.float32)
        svec = np.zeros((bucket,), np.int32)
        for j, (_, _, _, t, p, s) in enumerate(reqs):
            tvec[j], pvec[j], svec[j] = t, p, s
        stacked = pool_common.stack_admission(pbs)
        hk, stk = self._prefill(
            self.params, self.cfg, stacked["tokens"], stacked["modality"],
            stacked["attention_mask"],
        )
        self._carry = self._insert(
            hk, stk, np.asarray(slot_ids, np.int32),
            np.int32(take), tvec, pvec, svec,
        )
        for j, (rid, _, max_new, _, _, _) in enumerate(reqs):
            rec = _Slot(req_id=rid, tokens=[], max_new=max_new)
            self._slots[free[j]] = rec
            self._active[rid] = rec  # shared record: slot index may go stale

    def reset_stats(self):
        with self._stats_lock:
            for k in self.stats:
                self.stats[k] = 0

    def snapshot_stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            return dict(self.stats)

    def _process(
        self, toks: np.ndarray, owners: List[Optional[int]]
    ) -> List[Tuple[int, List[int]]]:
        """Host post-processing of one chunk's tokens. `owners` is the
        slot->req_id mapping AT DISPATCH TIME of that chunk — in overlap
        mode an owner can be stale (its request finished off an earlier
        chunk), in which case its row is discarded via the _active check."""
        eos = self.cfg.eos_token_id
        finished = []
        capped = np.zeros(self.n_slots, bool)
        for i, rid in enumerate(owners):
            if rid is None:
                continue
            s = self._active.get(rid)
            if s is None:
                continue  # finished on an earlier chunk; row is EOS padding
            row = toks[i]
            hit = np.flatnonzero(row == eos)
            take = row[: hit[0]] if hit.size else row
            s.tokens.extend(int(t) for t in take)
            if hit.size or len(s.tokens) >= s.max_new:
                finished.append((rid, s.tokens[: s.max_new]))
                self._active.pop(rid)
                if self._slots[i].req_id == rid:
                    self._slots[i] = _Slot()
                if not hit.size:
                    capped[i] = True  # retired by cap: device flag still False
        if capped.any():
            self._carry = _mark_done(self._carry, capped)
        return finished

    def step(self) -> List[Tuple[int, List[int]]]:
        """Admit waiting requests, decode one chunk, return finished
        (req_id, tokens) pairs. With overlap=True the returned requests are
        the ones finished by the PREVIOUS chunk — the freshly dispatched
        chunk is synced on the next call while the device keeps working."""
        t0 = time.perf_counter()
        n_q = len(self._queue)
        self._admit()
        t1 = time.perf_counter()
        active = sum(1 for s in self._slots if s.req_id is not None)
        dispatched = False
        if self.overlap:
            pending, self._pending = self._pending, None
            if active:
                self._carry, toks_dev, _ = self._chunk()
                self._pending = (toks_dev, [s.req_id for s in self._slots])
                dispatched = True
            t2 = time.perf_counter()
            finished = (
                self._process(np.asarray(pending[0]), pending[1])
                if pending is not None else []
            )
        else:
            self._carry, toks_dev, _ = self._chunk()
            dispatched = True
            toks = np.asarray(toks_dev)
            t2 = time.perf_counter()
            finished = self._process(toks, [s.req_id for s in self._slots])
        with self._stats_lock:
            self.stats["admitted"] += n_q - len(self._queue)
            self.stats["admit_s"] += t1 - t0
            # overlap: chunk_s is dispatch-only (the sync lives in host_s)
            self.stats["chunk_s"] += t2 - t1
            if dispatched:
                self.stats["chunks"] += 1
                self.stats["active_rows"] += active
            self.stats["host_s"] += time.perf_counter() - t2
        return finished

    def drain(self) -> Dict[int, List[int]]:
        """Run until every queued request finishes."""
        out: Dict[int, List[int]] = {}
        while not self.idle():
            for rid, toks in self.step():
                out[rid] = toks
        return out
