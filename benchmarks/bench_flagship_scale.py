"""Flagship-scale benchmarks on the GPU.

The reference deploys 0.19B-1.5B LMs (/root/reference/Inference.md:19-44,
README.md:140 trains from rwkv7-1.5B-world). This measures the deployed
sizes on the card:

  * decode tok/s at 0.4B-class (1024x24) and 1.4B-class (2048x24)
  * train step KT/s + MFU at 0.4B-class with the production fp32-Adam
    state, and at 1.4B-class (--only train14) with the low-memory
    factored-second-moment optimizer (the reference needed ZeRO-3
    CPU-offload for the same LM; multi-card fsdp is covered by
    chip_smoke.py --four)

MFU divides by the card's dense bf16 peak (chip_checks.PEAK_BF16_FLOPS,
keyed by device kind). Refuses to run without a GPU.

Usage: python benchmarks/bench_flagship_scale.py [--only decode04|decode14|train04]
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

from rwkvtts_tpu.utils import chip_checks, jit_cache


def n_params(params) -> int:
    return sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(params))


def bench_decode(hidden, layers, batch=64, t_prompt=128, t_new=256, iters=3,
                 int8=False, int4=False, state_bf16=False, proj_fuse=True):
    from rwkvtts_tpu.infer.generate import spark_generate
    from rwkvtts_tpu.models import rwkv7, spark

    cfg = spark.default_config(
        hidden_size=hidden, num_layers=layers, decode_state_bf16=state_bf16,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, params
    )
    if int4 and not proj_fuse:
        raise SystemExit("--no-proj-fuse does not compose with int4")
    params = rwkv7.pack_decode_params(
        params, cfg.backbone, quantize_int8=int8, quantize_int4=int4,
        fuse_projections=proj_fuse,
    )
    np_ = n_params(params)

    k = jax.random.PRNGKey(1)
    tokens = jax.random.randint(k, (batch, t_prompt), 0, 4000)
    modality = jnp.full((batch, t_prompt), spark.MOD_TEXT, jnp.int32)
    modality = modality.at[:, -1].set(spark.MOD_TAG)
    mask = jnp.ones((batch, t_prompt), jnp.int32)

    def run(key):
        toks, _ = spark_generate(
            params, cfg, tokens, modality, mask, key,
            max_new_tokens=t_new, top_k=50, top_p=0.95, temperature=1.0,
        )
        return toks

    t0 = time.perf_counter()
    jax.block_until_ready(run(jax.random.PRNGKey(2)))
    print(f"  compile+first: {time.perf_counter()-t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    for i in range(iters):
        jax.block_until_ready(run(jax.random.PRNGKey(3 + i)))
    dt = (time.perf_counter() - t0) / iters
    tps = batch * t_new / dt
    out = {
        "bench": f"decode_{hidden}x{layers}" + ("_int8" if int8 else "")
        + ("_int4" if int4 else "")
        + ("_sbf16" if state_bf16 else "")
        + ("" if proj_fuse else "_nofuse"),
        "params": np_,
        "batch": batch,
        "tok_per_s_chip": round(tps, 1),
        "ms_per_step": round(dt * 1e3 / t_new, 3),
        "vs_5k_target": round(tps / 5000.0, 2),
    }
    print(json.dumps(out), flush=True)
    return out


def bench_train(hidden, layers, batch=8, seqlen=2048, iters=5,
                low_memory=None, wkv_spans=1):
    from rwkvtts_tpu.models import spark
    from rwkvtts_tpu.parallel import train_step as ts
    from rwkvtts_tpu.train import optimizer as opt_lib

    # the train/cli.py defaults; wkv_spans>1 = the two-level hierarchical
    # chunk scan (shorter serial path)
    cfg = spark.default_config(
        hidden_size=hidden, num_layers=layers, wkv_spans=wkv_spans,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    np_ = n_params(params)
    tx = opt_lib.build_optimizer(params, low_memory=low_memory)
    state = ts.init_train_state(params, tx)
    step = ts.make_train_step(cfg, tx, donate=True)

    B, T = batch, seqlen
    k = jax.random.PRNGKey(1)
    batch_d = {
        "tokens": jax.random.randint(k, (B, T), 0, 4096),
        "modality": jnp.where(
            jnp.arange(T)[None, :] < T // 2, spark.MOD_TEXT, spark.MOD_SEMANTIC
        ) * jnp.ones((B, 1), jnp.int32),
        "labels": jnp.where(
            jnp.arange(T)[None, :] < T // 2, -100,
            jax.random.randint(k, (B, T), 0, 8192),
        ),
        "attention_mask": jnp.ones((B, T), jnp.int32),
    }
    rng = jax.random.PRNGKey(2)

    peak = chip_checks.peak_bf16_flops(jax.devices()[0].device_kind)
    t0 = time.perf_counter()
    state, metrics = step(state, batch_d, rng)
    loss0 = float(metrics["loss"])
    print(f"  compile+first: {time.perf_counter()-t0:.1f}s loss={loss0:.4f}",
          flush=True)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step(state, batch_d, rng)
    jax.block_until_ready(metrics["loss"])
    dt = (time.perf_counter() - t0) / iters
    kts = B * T / dt / 1e3
    mfu = 6 * np_ * B * T / dt / peak
    out = {
        "bench": f"train_{hidden}x{layers}"
        + (f"_{low_memory}" if low_memory else "")
        + (f"_spans{wkv_spans}" if wkv_spans > 1 else ""),
        "params": np_,
        "batch": B,
        "seqlen": T,
        "step_ms": round(dt * 1e3, 1),
        "kt_per_s_chip": round(kts, 1),
        "mfu": round(mfu, 4),
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int4", action="store_true")
    ap.add_argument("--state-bf16", action="store_true",
                    help="bf16 decode-state carry (cfg.decode_state_bf16)")
    ap.add_argument("--no-proj-fuse", action="store_true",
                    help="skip pack_decode_params: the fused a/b copies "
                         "store projection weights twice, so at the "
                         "weight-bandwidth-bound 1.4B point the ORIGINAL "
                         "7-matmul path may win (bf16 only)")
    ap.add_argument("--wkv-spans", type=int, default=1,
                    help="two-level hierarchical WKV chunking on the train "
                         "benches (1 = the plain chunked scan)")
    args = ap.parse_args()
    chip_checks.require_gpu()
    jit_cache.enable()
    results = []
    if args.only == "decode019":
        # the reference's smallest shipped LM class (0.19B, Inference.md)
        print("== decode 0.19B (768x24) ==", flush=True)
        results.append(
            bench_decode(768, 24, batch=args.batch or 64, int8=args.int8,
                         int4=args.int4,
                         state_bf16=args.state_bf16,
                         proj_fuse=not args.no_proj_fuse)
        )
    if args.only in (None, "decode04"):
        print("== decode 0.4B (1024x24) ==", flush=True)
        results.append(
            bench_decode(1024, 24, batch=args.batch or 64, int8=args.int8,
                         int4=args.int4,
                         state_bf16=args.state_bf16,
                         proj_fuse=not args.no_proj_fuse)
        )
    if args.only in (None, "decode14"):
        print("== decode 1.4B (2048x24) ==", flush=True)
        results.append(
            bench_decode(2048, 24, batch=args.batch or 64, int8=args.int8,
                         int4=args.int4,
                         state_bf16=args.state_bf16,
                         proj_fuse=not args.no_proj_fuse)
        )
    if args.only in (None, "train04"):
        print("== train 0.4B (1024x24) ==", flush=True)
        results.append(bench_train(1024, 24, batch=args.batch or 8,
                                   wkv_spans=args.wkv_spans))
    if args.only == "train14":
        # the reference needed ZeRO-3 CPU-offload for the same model
        # (train_..._properties.py:377-387); the one-card path here is the
        # factored-second-moment optimizer (train/optimizer.py low_memory)
        print("== train 1.4B (2048x24, adafactor state) ==", flush=True)
        results.append(
            bench_train(2048, 24, batch=args.batch or 2,
                        low_memory="adafactor")
        )
    print("ALL:", json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
