"""Profile the batched Spark decode: step time and per-op device times
from a profiler trace (utils/profiling.device_op_times).

    python scripts/profile_decode_b128.py --batches 64 --state-bf16 --decode-only

--hidden/--layers/--batch/--int8/--state-bf16/--no-proj-fuse choose the
point; traces land under chiprun_out/traces/ in the checkout.
"""
from __future__ import annotations

import os
import sys
import time

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rwkvtts_tpu.utils import chip_checks, jit_cache, profiling  # noqa: E402


def main():
    import argparse

    from rwkvtts_tpu.infer import generate as gen
    from rwkvtts_tpu.models import rwkv7, spark

    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--batches", default="64,128")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--state-bf16", action="store_true")
    ap.add_argument("--no-proj-fuse", action="store_true")
    ap.add_argument("--decode-only", action="store_true",
                    help="trace a post-prefill spark_decode_chunk instead of "
                    "the whole generate: the full-generate trace includes the "
                    "remat-scoped prefill ops ('checkpoint'/'copy' bands), "
                    "which blur the decode attribution")
    args = ap.parse_args()
    chip_checks.require_gpu()
    jit_cache.enable()
    print(chip_checks.smi_line(), flush=True)

    cfg = spark.default_config(
        hidden_size=args.hidden, num_layers=args.layers,
        decode_state_bf16=args.state_bf16,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, params
    )
    params = rwkv7.pack_decode_params(
        params, cfg.backbone, quantize_int8=args.int8,
        fuse_projections=not args.no_proj_fuse,
    )

    for B in (int(b) for b in args.batches.split(",")):
        k = jax.random.PRNGKey(1)
        tokens = jax.random.randint(k, (B, 128), 0, 4000)
        modality = jnp.full((B, 128), spark.MOD_TEXT, jnp.int32)
        modality = modality.at[:, -1].set(spark.MOD_TAG)
        mask = jnp.ones((B, 128), jnp.int32)

        if args.decode_only:
            # steady-state chunk: prefill once outside the traced region,
            # then time/trace one donated 64-step decode chunk (the carry
            # from a prior chunk, so EOS masks/counters are warm too)
            def chunk(carry, key):
                carry, toks, _ = gen.spark_decode_chunk(
                    params, cfg, carry, key,
                    chunk_len=64, top_k=50, top_p=0.95,
                )
                return carry, toks

            carry = gen.spark_prefill_carry(params, cfg, tokens, modality, mask)
            carry, t0ks = chunk(carry, jax.random.PRNGKey(2))  # compile+warm
            jax.block_until_ready(t0ks)
            t0 = time.perf_counter()
            carry, t1ks = chunk(carry, jax.random.PRNGKey(3))
            jax.block_until_ready(t1ks)
            dt = time.perf_counter() - t0
        else:
            def run(key):
                toks, _ = gen.spark_generate(
                    params, cfg, tokens, modality, mask, key,
                    max_new_tokens=64, top_k=50, top_p=0.95,
                )
                return toks

            jax.block_until_ready(run(jax.random.PRNGKey(2)))
            t0 = time.perf_counter()
            jax.block_until_ready(run(jax.random.PRNGKey(3)))
            dt = time.perf_counter() - t0
        print(f"B={B}: {dt*1e3/64:.2f} ms/step", flush=True)
        out_dir = os.path.join(
            _ROOT, "chiprun_out", "traces", f"decode_h{args.hidden}_b{B}"
        ) + (
            ("_q8" if args.int8 else "")
            + ("_sb" if args.state_bf16 else "")
            + ("_nf" if args.no_proj_fuse else "")
            + ("_do" if args.decode_only else "")
        )
        with profiling.trace(out_dir):
            if args.decode_only:
                carry, tks = chunk(carry, jax.random.PRNGKey(4))
                jax.block_until_ready(tks)
            else:
                jax.block_until_ready(run(jax.random.PRNGKey(4)))
        profiling.print_device_ops(out_dir)


if __name__ == "__main__":
    main()
