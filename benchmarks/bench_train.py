"""Training-step throughput benchmark (flagship Spark, on the GPU).

Usage: python benchmarks/bench_train.py [--batch 8] [--seqlen 2048]
Prints step time + KT/s per card.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.utils import jit_cache

jit_cache.enable()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    from rwkvtts_tpu.models import spark
    from rwkvtts_tpu.parallel import train_step as ts
    from rwkvtts_tpu.train import optimizer as opt_lib

    cfg = spark.default_config(hidden_size=args.hidden, num_layers=args.layers)
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    tx = opt_lib.build_optimizer(params)
    state = ts.init_train_state(params, tx)
    step = ts.make_train_step(cfg, tx, donate=False)

    B, T = args.batch, args.seqlen
    k = jax.random.PRNGKey(1)
    batch = {
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

    t0 = time.perf_counter()
    state, metrics = step(state, batch, rng)
    np.asarray(metrics["loss"])
    print(f"compile+first: {time.perf_counter()-t0:.1f}s loss={float(metrics['loss']):.4f}")

    t0 = time.perf_counter()
    for _ in range(args.iters):
        state, metrics = step(state, batch, rng)
    np.asarray(metrics["loss"])
    dt = (time.perf_counter() - t0) / args.iters
    kts = B * T / dt / 1e3
    print(f"step {dt*1e3:.1f} ms  |  {kts:.1f} KT/s/chip  |  loss {float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
