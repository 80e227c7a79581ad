"""What XLA makes of the two WKV paths on the GPU, as starting points for
kernel work: the decode step `ops/wkv7.wkv7_step` alone, and the Spark
train step.

    python scripts/profile_wkv_train.py

1. wkv7_step at B=64, H=16, N=64 (fp32 and bf16 state carry): the fusions
   in the compiled HLO, the step time (median over 200 calls, fenced by
   block_until_ready), the bytes the state forces (read once, written
   once) and the share of the 3.35 TB/s HBM roofline that time reaches.
2. The train step train/cli.py builds, Spark 1024x24, B=8 x T=2048 packed
   documents: step time and the top device ops of one traced step.

Traces land under chiprun_out/traces/ in the checkout.
"""
from __future__ import annotations

import os
import re
import statistics
import sys
import time

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rwkvtts_tpu.utils import chip_checks, jit_cache, profiling  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def wkv_step(B=64, H=16, N=64, iters=200):
    from rwkvtts_tpu.ops import wkv7

    ks = jax.random.split(jax.random.PRNGKey(0), 7)
    vec = lambda k: jax.random.normal(k, (B, H, N), jnp.bfloat16) * 0.3
    r, k, v, z, b = (vec(x) for x in ks[:5])
    w_raw = -0.5 - jax.nn.softplus(vec(ks[5]).astype(jnp.float32))
    for dt in (jnp.float32, jnp.bfloat16):
        state = (jax.random.normal(ks[6], (B, H, N, N)) * 0.1).astype(dt)
        fn = jax.jit(wkv7.wkv7_step, donate_argnums=(0,))
        lowered = fn.lower(state, r, w_raw, k, v, z, b)
        hlo = lowered.compile().as_text()
        fusions = re.findall(r"(\S+) = \S+ fusion\(.*kind=(k\w+)", hlo)
        y, state = fn(state, r, w_raw, k, v, z, b)
        jax.block_until_ready(state)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            y, state = fn(state, r, w_raw, k, v, z, b)
            jax.block_until_ready(state)
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        nbytes = 2 * state.size * state.dtype.itemsize
        print(f"wkv7_step B={B} H={H} N={N} state={jnp.dtype(dt).name}: "
              f"{med * 1e6:.1f} us/step (host-fenced), state bytes "
              f"{nbytes / 1e6:.1f} MB -> roofline {nbytes / HBM_BYTES_PER_S * 1e6:.1f} us", flush=True)
        print(f"  {len(fusions)} fusions: {fusions}")
        out_dir = os.path.join(_ROOT, "chiprun_out", "traces",
                               f"wkv7_step_{jnp.dtype(dt).name}")
        with profiling.trace(out_dir):
            for _ in range(20):
                y, state = fn(state, r, w_raw, k, v, z, b)
            jax.block_until_ready(state)
        profiling.print_device_ops(out_dir)
        with open(out_dir + ".hlo.txt", "w") as f:
            f.write(hlo)


def train_step(hidden=1024, layers=24, batch=8, seq=2048):
    from rwkvtts_tpu.models import spark
    from rwkvtts_tpu.parallel import train_step as ts
    from rwkvtts_tpu.train import optimizer as opt_lib

    cfg = spark.default_config(hidden_size=hidden, num_layers=layers)
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    params = chip_checks.fill_zero_init(params, jax.random.PRNGKey(100))
    tx = opt_lib.build_optimizer(params)
    state = ts.init_train_state(params, tx)
    step = ts.make_train_step(cfg, tx)
    b = chip_checks.spark_packed_batch(batch, seq)
    b = {k: jnp.asarray(v) for k, v in b.items()}
    times = []
    for i in range(4):
        t0 = time.perf_counter()
        state, m = step(state, b, jax.random.PRNGKey(i))
        jax.block_until_ready(m["loss"])
        times.append(time.perf_counter() - t0)
    med = statistics.median(times[1:])
    print(f"train step {hidden}x{layers} B={batch} T={seq}: {med * 1e3:.1f} "
          f"ms/step (steps {[round(t, 4) for t in times]})", flush=True)
    out_dir = os.path.join(_ROOT, "chiprun_out", "traces", "train_step")
    with profiling.trace(out_dir):
        state, m = step(state, b, jax.random.PRNGKey(9))
        jax.block_until_ready(m["loss"])
    profiling.print_device_ops(out_dir, top=25)


def main():
    chip_checks.require_gpu()
    jit_cache.enable()
    print(chip_checks.smi_line(), flush=True)
    wkv_step()
    train_step()


if __name__ == "__main__":
    main()
