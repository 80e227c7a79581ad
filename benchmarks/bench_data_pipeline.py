"""Input-pipeline throughput: native C++ tar streamer vs stdlib tarfile.

The training input path streams webdataset tar shards (data/webdataset.py);
the reference reads them via HF `load_dataset("webdataset")` eagerly per
tar (data/spark/multiple_webdataset.py:17-110) or a Python webdataset
pipeline (utils/webdataset_utils.py:245-392). Our native streamer
(csrc/tar_stream.cpp) parses ustar headers on a background thread into a
bounded prefetch queue, overlapping IO with the training step.

This bench synthesizes shards shaped like Spark ASR training data
(json + 2 s of 16 kHz pcm16 wav per sample) and measures samples/s and
MB/s end-to-end through iter_webdataset with native on/off.

CPU-only — needs no accelerator.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tarfile
import tempfile
import time
import wave

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def make_shards(root: str, n_shards: int, per_shard: int, wav_seconds: float):
    sr = 16000
    n = int(sr * wav_seconds)
    rng = np.random.default_rng(0)
    paths = []
    for s in range(n_shards):
        p = os.path.join(root, f"shard-{s:04d}.tar")
        with tarfile.open(p, "w") as tf:
            for i in range(per_shard):
                key = f"{s:04d}_{i:06d}"
                pcm = (rng.standard_normal(n) * 3000).astype(np.int16)
                bio = io.BytesIO()
                with wave.open(bio, "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(sr)
                    w.writeframes(pcm.tobytes())
                wav = bio.getvalue()
                meta = json.dumps({"text": f"sample {key}"}).encode()
                for name, data in ((f"{key}.json", meta), (f"{key}.wav", wav)):
                    ti = tarfile.TarInfo(name)
                    ti.size = len(data)
                    tf.addfile(ti, io.BytesIO(data))
        paths.append(p)
    return paths


def run(paths, native: bool):
    from rwkvtts_tpu.data import webdataset as wds

    t0 = time.perf_counter()
    n = 0
    nbytes = 0
    for s in wds.stream_tars(paths, native=native):
        n += 1
        # count the on-disk pcm16 bytes (2/sample), not the decoded float32
        # buffer, so MB/s states file-ingest throughput
        nbytes += s["audio"].size * 2
    dt = time.perf_counter() - t0
    return {
        "native": native,
        "samples": n,
        "samples_per_s": round(n / dt, 1),
        "pcm16_MB_per_s": round(nbytes / dt / 1e6, 1),
        "wall_s": round(dt, 2),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--per-shard", type=int, default=256)
    ap.add_argument("--wav-seconds", type=float, default=2.0)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as root:
        paths = make_shards(root, args.shards, args.per_shard, args.wav_seconds)
        sz = sum(os.path.getsize(p) for p in paths) / 1e6
        print(f"shards: {args.shards} x {args.per_shard} samples, {sz:.0f} MB")
        for native in (False, True):
            r = run(paths, native)  # cold
            r = run(paths, native)  # warm (page cache)
            print(json.dumps(r))


if __name__ == "__main__":
    main()
