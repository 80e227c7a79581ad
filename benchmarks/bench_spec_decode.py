"""B=1 greedy decode: plain vs self-speculative (int8/int4 draft + bf16
verify), at deployed LM sizes.

B=1 decode is weight-bandwidth-bound, which is exactly what speculative
decode amortizes — the verify pass reads
the bf16 weights once per K tokens. Reports:

  (a) component times: plain bf16 step, quantized draft step, verify ms
      per K-window — hardware truths independent of acceptance;
  (b) end-to-end spec tok/s at the acceptance rate measured on THESE
      weights (random init unless --ckpt);
  (c) projected spec tok/s at acceptance 1.0 — what a deployed checkpoint
      whose int8 and bf16 top-1 tokens agree gets.

Usage: python benchmarks/bench_spec_decode.py [--hidden 2048 --layers 24]
  [--k 8] [--int4] [--steps 256] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--int4", action="store_true", help="int4 draft (default int8)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from rwkvtts_tpu.utils import jit_cache

    jit_cache.enable()
    import jax.numpy as jnp
    import numpy as np

    from rwkvtts_tpu.infer import spec_decode
    from rwkvtts_tpu.models import rwkv7, spark

    cfg = spark.default_config(hidden_size=args.hidden, num_layers=args.layers)
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    n_params = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
    # bf16 weights (the decode bench convention) — the fp32 init tree at
    # 1.4B is 5.7 GB and OOMed HBM alongside the packed/draft copies
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, params
    )
    bb = cfg.backbone

    tokens = jax.random.randint(
        jax.random.PRNGKey(1), (1, args.prompt_len), 0, cfg.text_vocab_size
    ).astype(jnp.int32)
    modality = jnp.full_like(tokens, spark.MOD_TEXT)
    mask = jnp.ones_like(tokens)

    packed_fp = rwkv7.layer_decode_views(
        rwkv7.pack_decode_params(params, bb), bb
    )
    # pack the draft tree ONCE and reuse it everywhere below — each pack
    # materializes ~1.7 GB of quantized copies at 1.4B
    draft_tree = rwkv7.pack_decode_params(
        params, bb, quantize_int8=not args.int4, quantize_int4=args.int4
    )
    packed_q = rwkv7.layer_decode_views(draft_tree, bb)
    qname = "int4" if args.int4 else "int8"

    h0, state0 = spark.prefill(params, cfg, tokens, modality, mask)
    h0 = jax.block_until_ready(h0)

    def timed_loop(views, n, label):
        st = rwkv7.pack_decode_state(state0, bb)
        # warm
        toks = spec_decode.draft_greedy_k(views, cfg, h0, st, n)
        np.asarray(toks)
        t0 = time.perf_counter()
        toks = spec_decode.draft_greedy_k(views, cfg, h0, st, n)
        np.asarray(toks)
        dt = time.perf_counter() - t0
        ms = dt / n * 1e3
        print(f"  {label}: {ms:.3f} ms/step ({1e3/ms:.0f} tok/s)")
        return ms

    print(f"== spec decode bench {args.hidden}x{args.layers} "
          f"({n_params/1e9:.2f}B), B=1, K={args.k} ==")
    ms_plain = timed_loop(packed_fp, args.steps, "plain bf16 greedy")
    ms_draft = timed_loop(packed_q, args.steps, f"{qname} draft loop")
    # free the loop-bench copies BEFORE the e2e run: at 1.4B K=16 the
    # fused bf16 + quantized view trees keep ~4 GB live beside the e2e
    # spec program
    del packed_fp, packed_q

    # verify window cost: one collect_states chunk pass over K tokens
    d = jax.random.randint(jax.random.PRNGKey(2), (1, args.k), 0, 100).astype(
        jnp.int32
    )
    a, h, st_sel = spec_decode.verify_greedy_k(params, cfg, state0, d)
    np.asarray(a)
    t0 = time.perf_counter()
    reps = 8
    for _ in range(reps):
        a, h, st_sel = spec_decode.verify_greedy_k(params, cfg, state0, d)
    np.asarray(a)
    ms_verify = (time.perf_counter() - t0) / reps * 1e3
    print(f"  verify window (K={args.k}): {ms_verify:.3f} ms "
          f"({ms_verify/args.k:.3f} ms/tok)")

    # end-to-end at measured acceptance on these weights
    out, stats = spec_decode.spec_generate_greedy(
        params, cfg, tokens, modality, mask,
        draft_params=draft_tree,
        k=args.k, max_new_tokens=args.steps,
    )
    t0 = time.perf_counter()
    out, stats = spec_decode.spec_generate_greedy(
        params, cfg, tokens, modality, mask,
        draft_params=draft_tree,
        k=args.k, max_new_tokens=args.steps,
    )
    dt = time.perf_counter() - t0
    ms_e2e = dt / max(len(out), 1) * 1e3
    proj = (args.k * ms_draft + ms_verify) / args.k  # acceptance 1.0
    print(f"  e2e spec: {ms_e2e:.3f} ms/tok at accept_rate "
          f"{stats['accept_rate']:.3f} ({stats!r})")
    print(f"  projected at acceptance 1.0: {proj:.3f} ms/tok "
          f"({1e3/proj:.0f} tok/s; plain {1e3/ms_plain:.0f})")
    print(json.dumps({
        "bench": f"spec_decode_{args.hidden}x{args.layers}",
        "k": args.k, "draft": qname,
        "ms_plain_bf16": round(ms_plain, 3),
        "ms_draft": round(ms_draft, 3),
        "ms_verify_window": round(ms_verify, 3),
        "ms_e2e_measured": round(ms_e2e, 3),
        "accept_rate_randinit": round(stats["accept_rate"], 4),
        "ms_projected_accept1": round(proj, 3),
        "speedup_projected_vs_bf16": round(ms_plain / proj, 3),
    }))


if __name__ == "__main__":
    main()
