"""Deployed-scale throughput for the non-Spark model families + decode
batch sweep, at >=0.4B.

  * ASR (whisper -> adapter -> LLM) with a 0.4B-class LLM — BASELINE #4
  * XY 8-channel generation (flush automaton) with a 0.4B-class backbone
  * Spark decode batch sweep at 0.4B (B = 128 / 256)

Usage: python benchmarks/bench_families_scale.py [--only asr|xy|sweep]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.utils import jit_cache

jit_cache.enable()


def bench_asr(hidden=1024, layers=24, adapter_layers=6, batch=8, seconds=30.0):
    import dataclasses

    from rwkvtts_tpu.models import asr, whisper

    cfg = asr.default_config(
        hidden_size=hidden, num_layers=layers, adapter_layers=adapter_layers
    )
    # the deployed composition: whisper-large-v3 encoder (1280x32, 128 mel)
    # bridged to the RWKV LLM by the projectors
    cfg = dataclasses.replace(cfg, whisper=whisper.WhisperEncoderConfig(
        n_mels=128, d_model=1280, layers=32, heads=20, ffn_dim=5120,
    ))
    params = asr.init_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if hasattr(x, "ndim") and x.ndim >= 2 else x,
        params,
    )
    B, T_mel = batch, int(seconds * 100)
    rng = np.random.default_rng(0)
    batch_d = {
        "mel": jnp.asarray(rng.standard_normal((B, T_mel, cfg.whisper.n_mels)).astype(np.float32)),
        "mel_mask": jnp.ones((B, T_mel), jnp.int32),
        "text_ids": jnp.ones((B, 16), jnp.int32),
        "text_mask": jnp.ones((B, 16), jnp.int32),
        "hints_ids": jnp.ones((B, 4), jnp.int32),
        "hints_mask": jnp.ones((B, 4), jnp.int32),
    }
    run = jax.jit(lambda p, b: asr.transcribe(p, cfg, b, max_new_tokens=32)[0])
    np.asarray(run(params, batch_d))
    t0 = time.perf_counter()
    iters = 3
    for _ in range(iters):
        out = run(params, batch_d)
    np.asarray(out)
    dt = (time.perf_counter() - t0) / iters
    audio_s = B * seconds
    print(json.dumps({
        "bench": f"asr_{hidden}x{layers}", "batch": B,
        "x_realtime_per_chip": round(audio_s / dt, 1),
        "rtf": round(dt / audio_s, 5),
    }), flush=True)


def bench_xy(hidden=1024, layers=24, batch=8, t_new=256):
    from rwkvtts_tpu.models import rwkv7, xy
    from rwkvtts_tpu.infer import generate as gen

    cfg = xy.default_config(hidden_size=hidden, num_layers=layers)
    params = xy.init_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if hasattr(x, "ndim") and x.ndim >= 2 else x,
        params,
    )
    B, Tp = batch, 32
    rng = np.random.default_rng(1)
    ids = np.full((B, Tp, 8), 0, np.int32)
    ids[:, :, 0] = rng.integers(100, 60000, (B, Tp))
    mask = np.ones((B, Tp), np.int32)

    def run(key):
        frames, lengths = gen.xy_generate(
            params, cfg, jnp.asarray(ids), jnp.asarray(mask), key,
            max_new_tokens=t_new, min_new_tokens=t_new, allow_eos=False,
        )
        return frames

    np.asarray(run(jax.random.PRNGKey(2)))
    t0 = time.perf_counter()
    iters = 3
    for i in range(iters):
        out = run(jax.random.PRNGKey(3 + i))
    np.asarray(out)
    dt = (time.perf_counter() - t0) / iters
    # 8 codebook tokens per frame @ 12.5 Hz
    fps = B * t_new / dt
    print(json.dumps({
        "bench": f"xy_{hidden}x{layers}",
        "batch": B,
        "frames_per_s_chip": round(fps, 1),
        "audio_x_realtime": round(fps / 12.5, 1),
        "tokens_per_s_chip": round(fps * 8, 1),
    }), flush=True)


def bench_spark_sweep(hidden=1024, layers=24):
    from rwkvtts_tpu.infer.generate import spark_generate
    from rwkvtts_tpu.models import rwkv7, spark

    cfg = spark.default_config(hidden_size=hidden, num_layers=layers)
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, params
    )
    params = rwkv7.pack_decode_params(params, cfg.backbone)
    for B in (128, 256):
        k = jax.random.PRNGKey(1)
        tokens = jax.random.randint(k, (B, 128), 0, 4000)
        modality = jnp.full((B, 128), spark.MOD_TEXT, jnp.int32)
        modality = modality.at[:, -1].set(spark.MOD_TAG)
        mask = jnp.ones((B, 128), jnp.int32)

        def run(key):
            toks, _ = spark_generate(
                params, cfg, tokens, modality, mask, key,
                max_new_tokens=256, top_k=50, top_p=0.95,
            )
            return toks

        np.asarray(run(jax.random.PRNGKey(2)))
        t0 = time.perf_counter()
        for i in range(3):
            np.asarray(run(jax.random.PRNGKey(3 + i)))
        dt = (time.perf_counter() - t0) / 3
        print(json.dumps({
            "bench": f"spark_decode_{hidden}x{layers}", "batch": B,
            "tok_per_s_chip": round(B * 256 / dt, 1),
        }), flush=True)


def bench_s2s(hidden=1024, layers=24, batch=32, t_new=256):
    """S2S single-FFN (C11): audio-head decode at the 0.4B class —
    shared backbone, head-switched sampling (models/s2s.py)."""
    from rwkvtts_tpu.models import s2s

    cfg = s2s.default_config(hidden_size=hidden, num_layers=layers)
    params = s2s.init_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if hasattr(x, "ndim") and x.ndim >= 2 else x,
        params,
    )
    B, Tp = batch, 64
    ids = jax.random.randint(jax.random.PRNGKey(1), (B, Tp), 100, 60000)

    # params as jit ARGUMENTS, not closure constants — closures embed the
    # whole tree as constants in the compiled program
    run = jax.jit(lambda p, key: s2s.generate(
        p, cfg, ids, key, is_text=False,
        max_new_tokens=t_new, top_k=50, top_p=0.95, eos_id=-1,
    )[0])

    np.asarray(run(params, jax.random.PRNGKey(2)))
    t0 = time.perf_counter()
    for i in range(3):
        out = run(params, jax.random.PRNGKey(3 + i))
    np.asarray(out)
    dt = (time.perf_counter() - t0) / 3
    print(json.dumps({
        "bench": f"s2s_{hidden}x{layers}", "batch": B,
        "tok_per_s_chip": round(B * t_new / dt, 1),
    }), flush=True)


def bench_two_tower(hidden=1024, layers=24, batch=16, t_new=256):
    """Two-tower text->audio (C10) at the 0.4B class per tower: text-tower
    prefill + projector + audio-tower AR decode (models/tts_two_tower.py)."""
    from rwkvtts_tpu.models import tts_two_tower as tt

    cfg = tt.default_config(
        text_hidden=hidden, text_layers=layers,
        audio_hidden=hidden, audio_layers=layers,
    )
    params = tt.init_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if hasattr(x, "ndim") and x.ndim >= 2 else x,
        params,
    )
    B, Tp = batch, 64
    ids = jax.random.randint(jax.random.PRNGKey(1), (B, Tp), 100, 60000)
    mask = jnp.ones((B, Tp), jnp.int32)
    run = jax.jit(lambda p, key: tt.generate(
        p, cfg, ids, mask, key, max_new_tokens=t_new,
    )[0])
    np.asarray(run(params, jax.random.PRNGKey(2)))
    t0 = time.perf_counter()
    for i in range(3):
        out = run(params, jax.random.PRNGKey(3 + i))
    np.asarray(out)
    dt = (time.perf_counter() - t0) / 3
    print(json.dumps({
        "bench": f"two_tower_{hidden}x{layers}", "batch": B,
        "tok_per_s_chip": round(B * t_new / dt, 1),
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--xy-batch", type=int, default=8, help="xy decode batch")
    args = ap.parse_args()
    if args.only in (None, "asr"):
        bench_asr()
    if args.only in (None, "xy"):
        bench_xy(batch=args.xy_batch)
    if args.only in (None, "sweep"):
        bench_spark_sweep()
    if args.only in (None, "s2s"):
        bench_s2s()
    if args.only in (None, "two_tower"):
        bench_two_tower()


if __name__ == "__main__":
    main()
