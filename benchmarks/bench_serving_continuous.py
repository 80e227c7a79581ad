"""Serving-path throughput: continuous slot-pool vs grouped dispatcher.

A measured sustained-throughput number for the ContinuousTTSService
serving /api/rwkv_tts-style traffic vs the grouped BatchedTTSService, on
the GPU, with MIXED voices and MIXED
requested lengths (the traffic shape the reference's thread-pool service,
service/tts_service.py:14-120, handles one engine at a time).

Usage: python benchmarks/bench_serving_continuous.py [--requests 48]
       [--hidden 1024 --layers 24]
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

# --cpu must take effect BEFORE jit_cache.enable(): enable() queries the
# default backend, which initializes it
if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from rwkvtts_tpu.utils import jit_cache

jit_cache.enable()


class BenchTok:
    def encode(self, text):
        return [ord(c) % 200 + 1 for c in text]


def make_requests(n, seed=0, n_voices=None):
    from rwkvtts_tpu.serving import service as svc

    rng = random.Random(seed)
    voices = [
        [rng.randint(0, 4000) for _ in range(32)]
        for _ in range(n_voices or n)
    ]
    reqs = []
    for i in range(n):
        text = "benchmark sentence " * rng.randint(1, 5) + str(i)
        reqs.append(
            svc.TTSRequest(
                text=text, global_tokens=voices[i % len(voices)],
                max_new_tokens=rng.choice([64, 128, 192, 256]),
            )
        )
    return reqs


def drive(tts, reqs, timeout=1200.0):
    import numpy as np

    results = [None] * len(reqs)

    def call(i):
        results[i] = tts.synthesize(reqs[i], timeout=timeout)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    errs = [r.error for r in results if r is not None and r.error]
    assert not errs, errs[:3]
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--skip-grouped", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="int8 decode weights in the pipeline")
    ap.add_argument("--int4", action="store_true",
                    help="int4 group-wise decode weights in the pipeline")
    ap.add_argument("--state-bf16", action="store_true",
                    help="bf16 decode-state carry")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffered chunk pipeline (token-identical)")
    ap.add_argument("--cpu", action="store_true", help="smoke-test on CPU")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from rwkvtts_tpu.infer.spark_pipeline import SparkPipeline
    from rwkvtts_tpu.models import spark
    from rwkvtts_tpu.serving import service as svc

    cfg = spark.default_config(
        hidden_size=args.hidden, num_layers=args.layers,
        decode_state_bf16=args.state_bf16,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, params
    )
    pipe = SparkPipeline(cfg, params, BenchTok(), quantize_int8=args.int8,
                         quantize_int4=args.int4)

    reqs = make_requests(args.requests)
    same_voice = make_requests(args.requests, seed=1, n_voices=1)
    # random weights rarely sample EOS inside the cap -> generated tokens
    # ~= the requested caps; count the caps as the generated-token total
    total_tokens = sum(r.max_new_tokens for r in reqs)
    total_tokens_sv = sum(r.max_new_tokens for r in same_voice)

    # -- continuous (mixed voices: its design point) ------------------------
    cont = svc.ContinuousTTSService(
        pipe, None, n_slots=args.slots, chunk=args.chunk, prompt_cap=128,
        max_new_tokens=256, top_k=50, top_p=0.95, warmup=True,
        overlap=args.overlap,
    )
    # warm the in-process programs with one full pass, then measure;
    # stats are snapshotted PER PASS so the reported buckets decompose the
    # reported wall time (the pass that set the min)
    drive(cont, make_requests(args.requests))  # warm: same shapes as measured
    passes = []
    for rq in (reqs, make_requests(args.requests)):
        cont.batcher.reset_stats()
        dt = drive(cont, rq)
        passes.append((dt, cont.batcher.snapshot_stats()))
    dt_c, st = min(passes, key=lambda p: p[0])
    out_c = {
        "mode": "continuous-mixed",
        "requests": args.requests,
        "wall_s": round(dt_c, 2),
        "sustained_tok_per_s": round(total_tokens / dt_c, 1),
        # where the wall time goes + how full the pool ran (both measured
        # passes): occupancy < 1 is padding waste, chunk_ms/step vs the
        # raw decode bench isolates dispatch/sync overhead
        "admit_s": round(st["admit_s"], 2),
        "chunk_s": round(st["chunk_s"], 2),
        "host_s": round(st["host_s"], 2),
        "chunk_ms_per_step": round(
            1e3 * st["chunk_s"] / max(1, st["chunks"]) / args.chunk, 3
        ),
        "occupancy": round(
            st["active_rows"] / max(1, st["chunks"] * args.slots), 3
        ),
    }
    print(json.dumps(out_c), flush=True)
    drive(cont, make_requests(args.requests, seed=1, n_voices=1))
    dt_csv = min(drive(cont, same_voice), drive(cont, make_requests(args.requests, seed=1, n_voices=1)))
    cont.close()
    print(json.dumps({
        "mode": "continuous-same-voice",
        "wall_s": round(dt_csv, 2),
        "sustained_tok_per_s": round(total_tokens_sv / dt_csv, 1),
    }), flush=True)

    if not args.skip_grouped:
        grouped = svc.BatchedTTSService(
            pipe, None, max_batch=args.slots, max_wait_ms=200.0,
            max_new_tokens=256,
        )
        drive(grouped, make_requests(args.requests))  # warm: same shapes
        dt_g = min(drive(grouped, reqs), drive(grouped, make_requests(args.requests)))
        out_g = {
            "mode": "grouped-mixed", "requests": args.requests,
            "wall_s": round(dt_g, 2),
            "sustained_tok_per_s": round(total_tokens / dt_g, 1),
        }
        print(json.dumps(out_g), flush=True)
        # grouped's BEST case: every request shares one voice
        drive(grouped, make_requests(args.requests, seed=1, n_voices=1))
        dt_gsv = min(drive(grouped, same_voice), drive(grouped, make_requests(args.requests, seed=1, n_voices=1)))
        grouped.close()
        print(json.dumps({
            "mode": "grouped-same-voice", "wall_s": round(dt_gsv, 2),
            "sustained_tok_per_s": round(total_tokens_sv / dt_gsv, 1),
        }), flush=True)
        print(
            json.dumps({
                "speedup_mixed": round(dt_g / dt_c, 2),
                "speedup_same_voice": round(dt_gsv / dt_csv, 2),
            }),
            flush=True,
        )


if __name__ == "__main__":
    main()
