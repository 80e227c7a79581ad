"""Offline token-extraction pipelines: audio corpora -> training JSONL.

Reference parity (C18, /root/reference):
  * BiCodec (Spark) extraction: utils/extract_tar_tokens.py — rows
    {text, global_tokens, semantic_tokens [, age/gender/emotion/pitch/speed]}
  * XY extraction: utils/extract_xy_tokens.py — rows {text, audio_tokens}
  * Higgs extraction: utils/extract_higgs_tokens.py — same row format
  * multi-process, one worker per device/file (run_multiple_process.sh,
    mp.Queue) — here a process pool over shards; each worker owns its own
    jitted codec and, on a GPU host, its own card.

Extractors take an iterator of samples ({audio (float32 16k), text, ...})
— from data.webdataset, a directory of wavs, or jsonl rows with paths —
and append JSONL rows.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

log = logging.getLogger("rwkvtts_tpu")


def _batched(it: Iterable, n: int) -> Iterator[List]:
    buf: List = []
    for x in it:
        buf.append(x)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


def extract_spark_tokens(
    samples: Iterable[Dict[str, Any]],
    audio_tokenizer,  # codecs.spark_tokenizer.SparkAudioTokenizer
    out_path: str,
    properties_fn: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
) -> int:
    """BiCodec tokenization -> JSONL rows {text, global_tokens,
    semantic_tokens, <properties...>}."""
    n = 0
    with open(out_path, "a") as f:
        for s in samples:
            wav = np.asarray(s["audio"], np.float32)
            glob, sem = audio_tokenizer.tokenize(wav)
            row = {
                "text": s.get("text", ""),
                "global_tokens": glob.reshape(-1).tolist(),
                "semantic_tokens": sem.reshape(-1).tolist(),
            }
            if properties_fn is not None:
                row.update(properties_fn(s))
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
            n += 1
    return n


def extract_xy_tokens(
    samples: Iterable[Dict[str, Any]],
    codec_cfg,
    codec_params,
    out_path: str,
    batch_size: int = 8,
    max_seconds: float = 30.0,
    sample_rate: int = 16000,
) -> int:
    """XY_Tokenizer encode -> JSONL rows {text, audio_tokens (nq, T)}."""
    import jax.numpy as jnp

    from rwkvtts_tpu.codecs import xy_tokenizer as xt

    n = 0
    with open(out_path, "a") as f:
        for batch in _batched(samples, batch_size):
            T_max = int(max_seconds * sample_rate)
            wavs = np.zeros((len(batch), T_max), np.float32)
            lens = []
            for i, s in enumerate(batch):
                w = np.asarray(s["audio"], np.float32)[:T_max]
                wavs[i, : len(w)] = w
                lens.append(len(w))
            mel = xt.whisper_log_mel(jnp.asarray(wavs))
            mel_mask = (
                np.arange(mel.shape[1])[None, :]
                < (np.asarray(lens)[:, None] // 160)
            ).astype(np.float32)
            codes = np.asarray(xt.encode(codec_params, codec_cfg, mel, jnp.asarray(mel_mask)))
            for i, s in enumerate(batch):
                T_codes = max(lens[i] // (160 * 8), 1)  # 12.5 Hz
                f.write(
                    json.dumps(
                        {"text": s.get("text", ""), "audio_tokens": codes[:, i, :T_codes].tolist()},
                        ensure_ascii=False,
                    )
                    + "\n"
                )
                n += 1
    return n


def extract_cosy_tokens(
    samples: Iterable[Dict[str, Any]],
    speech_tokenizer_fn: Callable[[np.ndarray], Sequence[int]],
    out_path: str,
    instruction_fn: Optional[Callable[[str], str]] = None,
) -> int:
    """S3 speech-token extraction -> JSONL rows for the Cosy LM trainer:
    {text, tts_speech_tokens, prompt_text, llm_prompt_speech_token}
    (data/utils/llm_dataset.py row format). The S3 tokenizer is injected
    (ONNX in the reference; any wav->ids callable here).

    instruction_fn: optional text augmenter for instruct2 rows — the
    reference's `is_instructed` path (utilitie.py:546-547); use
    data.instructions.make_instruction_fn(lang)."""
    n = 0
    with open(out_path, "a") as f:
        for s in samples:
            tokens = list(map(int, speech_tokenizer_fn(np.asarray(s["audio"], np.float32))))
            text = s.get("text", "")
            if instruction_fn is not None:
                text = instruction_fn(text)
            row = {
                "text": text,
                "tts_speech_tokens": tokens,
                "prompt_text": s.get("prompt_text", ""),
                "llm_prompt_speech_token": s.get("llm_prompt_speech_token", []),
            }
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
            n += 1
    return n


def extract_higgs_tokens(
    samples: Iterable[Dict[str, Any]],
    codec_cfg,
    codec_params,
    hubert_fn: Callable[[np.ndarray], np.ndarray],
    out_path: str,
    batch_size: int = 4,
    max_seconds: float = 30.0,
    sample_rate: int = 16000,
) -> int:
    """Higgs tokenization (utils/extract_higgs_tokens.py parity) -> JSONL
    rows {text, audio_tokens (nq, T)}. hubert_fn: (B, T_wav) -> (B, T50, 768)
    semantic teacher (codecs.higgs.hubert_feature_fn for the torch teacher)."""
    import jax.numpy as jnp

    from rwkvtts_tpu.codecs import higgs

    n = 0
    hop = codec_cfg.hop_length
    with open(out_path, "a") as f:
        for batch in _batched(samples, batch_size):
            T_max = int(max_seconds * sample_rate)
            wavs = np.zeros((len(batch), T_max), np.float32)
            lens = []
            for i, s in enumerate(batch):
                w = np.asarray(s["audio"], np.float32)[:T_max]
                wavs[i, : len(w)] = w
                lens.append(len(w))
            feats = np.asarray(hubert_fn(wavs), np.float32)
            codes = np.asarray(
                higgs.encode(codec_params, codec_cfg, jnp.asarray(wavs), jnp.asarray(feats))
            )
            for i, s in enumerate(batch):
                T_codes = max(lens[i] // hop, 1)
                f.write(
                    json.dumps(
                        {"text": s.get("text", ""), "audio_tokens": codes[:, i, :T_codes].tolist()},
                        ensure_ascii=False,
                    )
                    + "\n"
                )
                n += 1
    return n


def visible_gpus() -> List[str]:
    """Ids of the GPUs that worker processes may use, found without
    starting a JAX backend in this process (a backend here would take most
    of a card's memory). Empty when JAX_PLATFORMS rules out CUDA or no
    NVIDIA driver answers."""
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and not any(p in platforms for p in ("cuda", "gpu")):
        return []
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [d.strip() for d in env.split(",") if d.strip()]
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return []
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def assign_workers(num_workers: int, gpus: Sequence[str]) -> List[Optional[str]]:
    """Card for each worker: one card each, and never more workers than
    cards on a GPU host (two JAX processes on one card run out of memory).
    Without GPUs every worker gets None (CPU) and the count stands."""
    if not gpus:
        return [None] * max(1, num_workers)
    return list(gpus[: max(1, min(num_workers, len(gpus)))])


def _pin_worker_card(queue) -> None:
    """Pool initializer: take one card id before JAX starts in the worker."""
    card = queue.get()
    if card is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = card


def run_sharded(
    shard_paths: Sequence[str],
    worker_fn: Callable[[str, str], int],
    out_dir: str,
    num_workers: int = 1,
) -> int:
    """One-worker-per-shard multiprocess driver (run_multiple_process.sh
    equivalent). worker_fn(shard_path, out_path) -> row count; workers are
    separate processes so each owns an independent runtime. On a GPU host
    each worker is pinned to its own card (assign_workers)."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = [
        (p, os.path.join(out_dir, os.path.basename(p) + ".jsonl"))
        for p in shard_paths
    ]
    cards = assign_workers(num_workers, visible_gpus())
    if len(cards) <= 1:
        # in-process: this process's JAX picks its own (first) device
        return sum(worker_fn(p, o) for p, o in jobs)
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    for card in cards:
        queue.put(card)
    with ctx.Pool(len(cards), initializer=_pin_worker_card,
                  initargs=(queue,)) as pool:
        counts = pool.starmap(worker_fn, jobs)
    return sum(counts)
