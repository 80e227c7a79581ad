"""TTS serving core: speaker library + batched request worker.

Reference parity (/root/reference/service/):
  * tts_service.py:14-120 — TTS_Service with a worker queue over engines
  * rwkv_tts_service.py:67-178 — /api/rwkv_tts payloads: {text, prompt_text?,
    audio (base64 wav)? , speaker?}, wav response; /api/speakers lists the
    demo prompt library (demos/<speaker>/*.wav)

Redesign (SURVEY.md §7.12): instead of a thread per engine, one
dispatcher thread groups queued requests that share a speaker/voice into a
single batched decode call — RWKV decode throughput scales with batch,
so batching is the serving win.
"""
from __future__ import annotations

import base64
import dataclasses
import io
import logging
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

log = logging.getLogger("rwkvtts_tpu")

from rwkvtts_tpu.utils import audio_io


@dataclasses.dataclass
class TTSRequest:
    text: str
    speaker: Optional[str] = None
    prompt_text: Optional[str] = None
    prompt_wav: Optional[np.ndarray] = None
    properties: Optional[Dict[str, Any]] = None
    global_tokens: Optional[List[int]] = None  # a designed voice, unsaved
    seed: int = 0
    temperature: float = 1.0
    top_k: int = 50
    top_p: float = 0.95
    # per-request decode cap; clamped to the service's max_new_tokens
    max_new_tokens: Optional[int] = None


@dataclasses.dataclass
class TTSResponse:
    wav: np.ndarray
    sample_rate: int
    error: Optional[str] = None


class SpeakerLibrary:
    """demos/<speaker>/*.wav prompt library; caches codec tokens per speaker."""

    def __init__(self, demo_dir: Optional[str], codec=None, sample_rate: int = 16000):
        self.demo_dir = demo_dir
        self.codec = codec
        self.sample_rate = sample_rate
        self._cache: Dict[str, Dict[str, Any]] = {}

    def speakers(self) -> List[str]:
        """All voices: demo-dir prompt folders plus registered (designed/
        cached) entries."""
        names = set(self._cache)
        if self.demo_dir and os.path.isdir(self.demo_dir):
            names.update(
                d for d in os.listdir(self.demo_dir)
                if os.path.isdir(os.path.join(self.demo_dir, d))
            )
        return sorted(names)

    def register(self, name: str, global_tokens: Sequence[int], semantic_tokens: Sequence[int] = ()):
        self._cache[name] = {
            "global_tokens": list(global_tokens),
            "semantic_tokens": list(semantic_tokens),
        }

    def get(self, name: str) -> Dict[str, Any]:
        if name in self._cache:
            return self._cache[name]
        if not self.demo_dir:
            raise KeyError(name)
        d = os.path.join(self.demo_dir, name)
        wavs = sorted(
            f for f in os.listdir(d) if f.endswith(".wav")
        )
        if not wavs:
            raise KeyError(name)
        wav = audio_io.load_wav(os.path.join(d, wavs[0]), self.sample_rate, volume_normalize=True)
        if self.codec is None:
            raise RuntimeError("codec required to tokenize speaker prompts")
        glob, sem = self.codec.tokenize(wav)
        entry = {
            "global_tokens": glob.reshape(-1).tolist(),
            "semantic_tokens": sem.reshape(-1).tolist(),
        }
        self._cache[name] = entry
        return entry


class BatchedTTSService:
    """Queue + dispatcher: groups same-voice requests into one batched
    pipeline call. synthesize() is the blocking client API; the HTTP layers
    sit on top."""

    def __init__(
        self,
        pipeline,  # SparkPipeline-compatible: synthesize(list[str], global_tokens=…)
        speakers: Optional[SpeakerLibrary] = None,
        max_batch: int = 8,
        max_wait_ms: float = 30.0,
        max_new_tokens: int = 1024,
        voices=None,  # CosyVoiceLibrary: stored zero-shot conditions for stream()
    ):
        self.pipeline = pipeline
        self.speakers = speakers or SpeakerLibrary(None)
        self.voices = voices
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_new_tokens = max_new_tokens
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client API ---------------------------------------------------------

    def synthesize(self, req: TTSRequest, timeout: float = 300.0) -> TTSResponse:
        done = threading.Event()
        box: Dict[str, Any] = {}
        self._q.put((req, done, box))
        if not done.wait(timeout):
            return TTSResponse(np.zeros(0, np.float32), 16000, error="timeout")
        return box["resp"]

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)

    def stats(self) -> Dict[str, Any]:
        """Engine counters for observability (GET /api/stats); the grouped
        dispatcher only reports its queue depth."""
        return {"mode": "grouped", "queued": self._q.qsize()}

    # -- dispatcher -----------------------------------------------------------

    def _voice_key(self, req: TTSRequest):
        if req.speaker:
            return ("spk", req.speaker)
        if req.global_tokens:
            return ("glob", tuple(req.global_tokens))
        if req.properties:
            return ("props", tuple(sorted(req.properties.items())))
        return ("unique", id(req))

    def stream(self, req: TTSRequest, hop_tokens: int = 50):
        """Streaming synthesis generator: yields float32 wav chunks as the
        LM decodes (incremental-state pipeline, infer/streaming.py). Unlike
        `synthesize` this bypasses the batching queue — a stream occupies
        its request for its whole duration, like the reference's
        thread-per-utterance llm_job (cli/model.py:416)."""
        fn = getattr(self.pipeline, "synthesize_streaming", None)
        if fn is None:
            raise NotImplementedError("pipeline has no streaming path")
        kw: Dict[str, Any] = {
            "seed": req.seed, "hop_tokens": hop_tokens,
            "top_k": req.top_k, "top_p": req.top_p,
        }
        prompt_text = req.prompt_text or ""
        if req.prompt_wav is not None:
            # frontend once, then stream with the extracted condition
            toks, mel, emb = self.pipeline.frontend_zero_shot(req.prompt_wav)
            kw.update(
                prompt_speech_tokens=toks, prompt_mel=mel, spk_embedding=emb,
            )
        elif req.speaker:
            # stored zero-shot condition (CosyVoiceLibrary holds the
            # tokens/mel/embedding triple streaming needs)
            if self.voices is None:
                raise ValueError(
                    "streaming with a named speaker needs a voice library"
                )
            try:
                v = self.voices.get(req.speaker)
            except KeyError:
                raise ValueError(f"unknown speaker: {req.speaker!r}") from None
            kw.update(
                prompt_speech_tokens=v["tokens"], prompt_mel=v["mel"],
                spk_embedding=v["emb"],
            )
            prompt_text = prompt_text or v.get("text", "")
        elif req.global_tokens or req.properties:
            raise ValueError(
                "streaming supports prompt_wav or a stored speaker voice; "
                "use /api/rwkv_tts for global_tokens/properties requests"
            )
        yield from fn(req.text, prompt_text, **kw)

    def design_voice(
        self,
        properties: Dict[str, Any],
        name: Optional[str] = None,
        seed: int = 0,
    ) -> List[int]:
        """Voice designer (the reference desktop GUI's core flow,
        gradio/tts_gui_simple.py:289-370 / tts_using_webrwkv_osx.py):
        SPCT properties -> 32 global speaker tokens; optionally save them
        as a named speaker in the library for reuse."""
        tokens = self.pipeline.design_voice(properties, seed=seed)
        if name:
            self.speakers.register(name, tokens)
        return tokens

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait_ms / 1e3
            key0 = self._voice_key(first[0])
            while len(batch) < self.max_batch and time.perf_counter() < deadline:
                try:
                    item = self._q.get(timeout=max(deadline - time.perf_counter(), 0.001))
                except queue.Empty:
                    break
                if self._voice_key(item[0]) == key0:
                    batch.append(item)
                else:
                    self._q.put(item)  # different voice: next round
                    break
            self._process(batch)

    def _process(self, batch):
        reqs = [b[0] for b in batch]
        try:
            r0 = reqs[0]
            # grouped decode runs the whole batch to the LONGEST requested
            # cap (the padding waste the continuous path eliminates);
            # 64-bucketed so serving compiles whole decode chunks only
            cap = max(
                min(r.max_new_tokens or self.max_new_tokens, self.max_new_tokens)
                for r in reqs
            )
            cap = min(-(-cap // 64) * 64, self.max_new_tokens)
            kw: Dict[str, Any] = {
                "max_new_tokens": cap,
                "seed": r0.seed,
                "temperature": r0.temperature,
                "top_k": r0.top_k,
                "top_p": r0.top_p,
            }
            if r0.speaker:
                entry = self.speakers.get(r0.speaker)
                kw["global_tokens"] = entry["global_tokens"]
            elif r0.global_tokens:
                kw["global_tokens"] = list(r0.global_tokens)
            elif r0.prompt_wav is not None:
                kw["prompt_wav"] = r0.prompt_wav
                kw["prompt_text"] = r0.prompt_text
            elif r0.properties is not None:
                kw["properties"] = r0.properties
            texts = [r.text for r in reqs]
            results = self.pipeline.synthesize(texts, **kw)
            if not isinstance(results, list):
                results = [results]
            for (req, done, box), res in zip(batch, results):
                box["resp"] = TTSResponse(res.wav, res.sample_rate)
                done.set()
        except Exception as e:  # noqa: BLE001 — service must answer
            for req, done, box in batch:
                box["resp"] = TTSResponse(np.zeros(0, np.float32), 16000, error=str(e))
                done.set()


class ContinuousTTSService(BatchedTTSService):
    """The production serving path: every /api/rwkv_tts request is admitted
    into a ContinuousBatcher slot.

    Unlike the grouped dispatcher above — which can only batch requests
    that share a voice, leaving the decode program under-occupied on mixed
    traffic — the slot pool decodes MIXED voices and MIXED lengths in one
    program: a Spark voice lives in the prompt tokens (global tokens are
    part of the [TAG2|text|TAG0|global|TAG1|...] layout), so slots are
    voice-agnostic. Admission prefill is still batched across whatever is
    queued, which is the only thing same-voice grouping ever bought.
    Beats the reference's one-engine-per-thread pool
    (/root/reference/service/tts_service.py:14-120): no per-request engine
    affinity, no padding waste, requests join mid-flight.

    Per-request temperature/top_p are honored: they ride in the slot carry
    as traced vectors, so a pool of mixed sampling params runs one compiled
    chunk program. top_k is the pool-level static cap (a request wanting a
    tighter distribution expresses it through top_p).
    """

    def __init__(
        self,
        pipeline,  # infer.spark_pipeline.SparkPipeline (cfg/params/tok/codec)
        speakers: Optional[SpeakerLibrary] = None,
        n_slots: int = 8,
        chunk: int = 16,
        prompt_cap: int = 128,
        max_new_tokens: int = 1024,
        temperature: float = 1.0,
        top_k: int = 50,
        top_p: float = 0.95,
        seed: int = 0,
        voices=None,
        warmup: bool = False,
        warmup_widths=None,  # prompt widths to precompile (default: prompt_cap)
        dp: int = 1,
        overlap: bool = False,
    ):
        from rwkvtts_tpu.serving.continuous import ContinuousBatcher

        mesh = None
        if dp > 1:
            # shard the slot pool over a dp device mesh — one chunk program
            # decodes all slots across the cards (bit-identical to the
            # single-device pool, tests/test_continuous.py)
            from rwkvtts_tpu.parallel import mesh as mesh_lib

            mesh = mesh_lib.make_mesh(dp=dp)
        self.batcher = ContinuousBatcher(
            pipeline.params, pipeline.cfg, n_slots=n_slots, chunk=chunk,
            prompt_cap=prompt_cap, temperature=temperature, top_k=top_k,
            top_p=top_p, seed=seed, mesh=mesh, overlap=overlap,
        )
        if warmup:
            self.batcher.warmup(warmup_widths)
        # super() starts the worker thread -> batcher must exist first
        super().__init__(
            pipeline, speakers, max_new_tokens=max_new_tokens, voices=voices,
        )

    def stats(self) -> Dict[str, Any]:
        st = self.batcher.snapshot_stats()
        chunks = max(1, st["chunks"])
        return {
            "mode": "continuous",
            "n_slots": self.batcher.n_slots,
            "chunk": self.batcher.chunk,
            "queued": self._q.qsize(),
            **{k: round(v, 3) if isinstance(v, float) else v
               for k, v in st.items()},
            "occupancy": round(
                st["active_rows"] / (chunks * self.batcher.n_slots), 3
            ),
            "chunk_ms_per_step": round(
                1e3 * st["chunk_s"] / chunks / self.batcher.chunk, 3
            ),
        }

    # -- request -> prompt ----------------------------------------------------

    def _resolve_voice(self, req: TTSRequest):
        """-> (text, global_tokens, prompt_semantics, properties_str);
        mirrors SparkPipeline.synthesize's voice resolution."""
        from rwkvtts_tpu.data.properties import properties_string

        text, prompt_sem, props_str = req.text, [], None
        if req.speaker:
            globals_ = self.speakers.get(req.speaker)["global_tokens"]
        elif req.global_tokens:
            globals_ = list(req.global_tokens)
        elif req.prompt_wav is not None:
            if self.pipeline.codec is None:
                raise ValueError("audio tokenizer required for prompt_wav")
            glob, sem = self.pipeline.codec.tokenize(req.prompt_wav)
            globals_ = glob.reshape(-1).tolist()
            if req.prompt_text:
                text = req.prompt_text + text
                prompt_sem = sem.reshape(-1).tolist()
        elif req.properties is not None:
            globals_ = self.pipeline.design_voice(req.properties, seed=req.seed)
            props_str = properties_string(
                req.properties.get("age", "youth-adult"),
                req.properties.get("gender", "female"),
                req.properties.get("emotion", "NEUTRAL"),
                req.properties.get("pitch", "medium_pitch"),
                req.properties.get("speed", "medium"),
            )
        else:
            raise ValueError(
                "need speaker, global_tokens, prompt_wav, or properties"
            )
        return text, globals_, prompt_sem, props_str

    def _admit(self, item, pending) -> None:
        req, done, box = item
        try:
            text, globals_, prompt_sem, props = self._resolve_voice(req)
            pb = self.pipeline._prompt_batch(
                [text], [globals_], [prompt_sem], [props]
            )
            cap = min(req.max_new_tokens or self.max_new_tokens,
                      self.max_new_tokens)
            rid = self.batcher.add_request(
                pb, cap, temperature=req.temperature, top_p=req.top_p,
                seed=req.seed,
            )
            pending[rid] = (req, done, box, globals_)
        except Exception as e:  # noqa: BLE001 — service must answer
            box["resp"] = TTSResponse(np.zeros(0, np.float32), 16000, error=str(e))
            done.set()

    def _finish(self, toks, globals_) -> TTSResponse:
        codec = self.pipeline.codec
        sr = getattr(self.pipeline, "sample_rate", 16000)
        if codec is None or not toks:
            return TTSResponse(np.zeros(0, np.float32), sr)
        g = np.asarray(globals_, np.int64)[None, None, :]
        sem = np.asarray(toks, np.int64)[None]
        return TTSResponse(np.asarray(codec.detokenize(g, sem))[0], sr)

    # -- dispatcher -----------------------------------------------------------

    def _run(self):
        cb = self.batcher
        pending: Dict[int, Any] = {}
        while not self._stop.is_set():
            # admit everything queued right now (one batched prefill)
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                self._admit(item, pending)
            if cb.idle():
                try:
                    item = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                self._admit(item, pending)
                continue  # loop back to drain any burst before stepping
            try:
                finished = cb.step()
            except Exception as e:  # noqa: BLE001 — the worker must survive
                # a failed chunk (fresh-shape compile error, transient
                # device fault) may leave the donated carry in an unknown
                # state: answer every in-flight request with the error and
                # reset the pool, instead of killing the daemon thread and
                # timing out every future request (the grouped dispatcher's
                # _process has the same containment)
                log.exception("decode chunk failed; resetting slot pool")
                for rid, (req, done, box, _g) in list(pending.items()):
                    box["resp"] = TTSResponse(
                        np.zeros(0, np.float32), 16000, error=str(e)
                    )
                    done.set()
                pending.clear()
                cb._queue.clear()  # queued-not-yet-admitted rids were
                # answered above too — leaving them would decode orphans
                cb._slots = [type(cb._slots[0])() for _ in cb._slots]
                cb._carry = cb._fresh_carry()
                cb._active.clear()
                cb._pending = None
                continue
            for rid, toks in finished:
                req, done, box, globals_ = pending.pop(rid)
                try:
                    box["resp"] = self._finish(toks, globals_)
                except Exception as e:  # noqa: BLE001
                    box["resp"] = TTSResponse(
                        np.zeros(0, np.float32), 16000, error=str(e)
                    )
                done.set()


class _CosyVoiceNames:
    """SpeakerLibrary-shaped adapter over a CosyVoiceLibrary so the HTTP
    layer's GET /api/speakers lists the stored zero-shot voices."""

    def __init__(self, voices):
        self._voices = voices

    def speakers(self) -> List[str]:
        return self._voices.speakers() if self._voices is not None else []

    def register(self, name, tokens):  # Spark global-token registration
        raise NotImplementedError(
            "Cosy voices register from wav: CosyVoiceLibrary.register_from_wav"
        )


class CosyTTSService:
    """HTTP-layer service for the CosyVoice2 pipeline over a SHARED slot
    pool (serving/cosy_pool.CosyStreamHub): every request — streaming and
    non-streaming alike — decodes through one compiled LM chunk loop, so N
    concurrent requests cost ~one batched decode instead of the
    reference's one-engine-per-thread serialization (tts_service.py:14-120).

    Duck-compatible with BatchedTTSService for http_server.serve():
    synthesize(req) / stream(req, hop_tokens) / speakers / stats / pipeline.
    Sampling (RAS top_k/top_p) is pool-level (set at launch); per-request
    temperature/top_p fields are ignored — the Cosy reference samples with
    fixed RAS params too (cosy_llm.py:169-177).
    """

    def __init__(
        self,
        pipeline,  # infer.cosy_pipeline.CosyPipeline
        voices=None,  # infer.voices.CosyVoiceLibrary
        n_slots: int = 8,
        chunk: int = 16,
        prompt_cap: int = 128,
        max_new_tokens: int = 2048,
        top_k: int = 25,
        top_p: float = 0.8,
        warmup: bool = False,
        warmup_widths=None,
        overlap: bool = False,
        stream_cfg=None,
    ):
        from rwkvtts_tpu.serving.cosy_pool import CosyStreamHub

        self.pipeline = pipeline
        self.voices = voices
        self.speakers = _CosyVoiceNames(voices)
        self.max_new_tokens = max_new_tokens
        # stream_cfg: hub-wide vocoder/flow levers (SFM few-step flow,
        # flow ctx window, vocode_every); per-request hop still rides
        # stream(hop_tokens=...)
        self.hub = CosyStreamHub(
            pipeline, n_slots=n_slots, chunk=chunk, prompt_cap=prompt_cap,
            top_k=top_k, top_p=top_p, warmup=warmup,
            warmup_widths=warmup_widths, overlap=overlap,
            stream_cfg=stream_cfg,
        )

    def close(self):
        self.hub.close()

    def stats(self) -> Dict[str, Any]:
        b = self.hub.batcher
        return {
            "mode": "cosy_pool",
            "n_slots": b.n_slots,
            "chunk": b.chunk,
            "active": sum(1 for s in b._slots if s.req_id is not None),
            "queued": len(b._queue),
        }

    def _voice_kw(self, req: TTSRequest) -> Dict[str, Any]:
        if req.prompt_wav is not None:
            return {"prompt_wav": req.prompt_wav,
                    "prompt_text": req.prompt_text or ""}
        if req.speaker:
            if self.voices is None:
                raise ValueError("named speakers need a voice library")
            try:
                v = self.voices.get(req.speaker)
            except KeyError:
                raise ValueError(f"unknown speaker: {req.speaker!r}") from None
            return {
                "prompt_speech_tokens": v["tokens"], "prompt_mel": v["mel"],
                "spk_embedding": v["emb"],
                "prompt_text": req.prompt_text or v.get("text", ""),
            }
        if req.global_tokens or req.properties:
            raise ValueError(
                "the Cosy service takes prompt_wav or a stored speaker "
                "voice (global_tokens/properties are Spark-voice concepts)"
            )
        return {"prompt_text": req.prompt_text or ""}

    def stream(self, req: TTSRequest, hop_tokens: int = 50,
               timeout: Optional[float] = None):
        if self.pipeline.flow_cfg is None or self.pipeline.hift_cfg is None:
            raise RuntimeError(
                "cosy serving needs flow.pt + hift.pt for wav output "
                "(pass --cosy-dir with the CosyVoice2 model files)"
            )
        cap = min(req.max_new_tokens or self.max_new_tokens,
                  self.max_new_tokens)
        yield from self.hub.stream(
            req.text, hop_tokens=hop_tokens, seed=req.seed,
            max_new_tokens=cap, timeout=timeout, **self._voice_kw(req),
        )

    def synthesize(self, req: TTSRequest, timeout: float = 300.0) -> TTSResponse:
        sr = getattr(self.pipeline, "sample_rate", 24000)
        try:
            # the timeout bounds the whole request (the BatchedTTSService
            # contract); expiry cancels the slot and answers with an error
            chunks = list(self.stream(req, timeout=timeout))
            wav = (np.concatenate(chunks) if chunks
                   else np.zeros(0, np.float32))
            return TTSResponse(wav, sr)
        except Exception as e:  # noqa: BLE001 — service must answer
            return TTSResponse(np.zeros(0, np.float32), sr, error=str(e))


def stream_wav_header(sample_rate: int, channels: int = 1) -> bytes:
    """WAV header with an unknown (maximal) data length — the standard
    streaming-WAV trick: players start decoding immediately and read until
    the connection closes."""
    import struct

    bits = 16
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    return (
        b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                                byte_rate, block_align, bits)
        + b"data" + struct.pack("<I", 0xFFFFFFFF)
    )


def pcm16(wav) -> bytes:
    import numpy as _np

    x = _np.clip(_np.asarray(wav, _np.float32), -1.0, 1.0)
    return (x * 32767.0).astype("<i2").tobytes()


def properties_options() -> Dict[str, List[str]]:
    """Dropdown vocabularies for the voice-design UI — exactly the SPCT
    property sets the checkpoints were trained with (data/properties.py;
    reference utils/properties_util.py:1-64)."""
    from rwkvtts_tpu.data import properties as props

    return {
        "age": list(props.AGE_TOKENS),
        "gender": list(props.GENDER_TOKENS),
        "emotion": list(props.EMOTION_TOKENS),
        "pitch": list(props.PITCH_TOKENS),
        "speed": list(props.SPEED_TOKENS),
    }


def decode_audio_b64(b64: str, sample_rate: int = 16000) -> np.ndarray:
    """base64 wav payload -> float32 mono (the service's audio input format,
    rwkv_tts_service.py request contract)."""
    raw = base64.b64decode(b64)
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        f.write(raw)
        f.flush()
        return audio_io.load_wav(f.name, sample_rate)


def mp3_bytes(wav: np.ndarray, sample_rate: int, bitrate_kbps: int = 128) -> bytes:
    """MP3 response encoding (the reference serves wav AND mp3,
    rwkv_tts_service.py:72-99 audio_format field) via the ctypes LAME
    binding; raises RuntimeError with a clear wav-only message when
    libmp3lame is absent on the host."""
    from rwkvtts_tpu.utils import mp3

    return mp3.encode_mp3(wav, sample_rate, bitrate_kbps=bitrate_kbps)


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        audio_io.save_wav(f.name, wav, sample_rate)
        f.seek(0)
        return open(f.name, "rb").read()
