"""Profile the streaming hop's flow + HiFT stages at deployed Cosy2 sizes.

A vocoder hop that costs about as much for ~116 mel frames as the
non-streaming call does for 500 says the hop is fixed-cost-bound, not
size-bound. This script measures:
  1. hift ms/call vs frame count (fixed vs marginal cost)
  2. flow SFM window ms/call vs (n_timesteps, window tokens)
  3. a jax.profiler per-op table of the hift hop (what the fixed cost IS)

Usage: python scripts/profile_stream_hop.py [--trace]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.utils import jit_cache, profiling  # noqa: E402

jit_cache.enable()


def t_ms(fn, *a, iters=5, **k):
    out = fn(*a, **k)
    jax.block_until_ready(out)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        np.asarray(jax.tree_util.tree_leaves(out)[0])
        ts.append(time.perf_counter() - t0)
    return 1000 * float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        _ROOT, "chiprun_out", "traces", "hift_hop"))
    args = ap.parse_args()

    from rwkvtts_tpu.codecs import flow as flow_lib, hift as hift_lib
    from rwkvtts_tpu.infer import streaming

    hcfg = hift_lib.HiFTConfig()
    hparams = hift_lib.init_params(jax.random.PRNGKey(2), hcfg)
    key = jax.random.PRNGKey(3)

    # 1. hift cost vs frames (streaming hop = 8 cache + 108 new = 116)
    scl = 8 * hcfg.total_upsample
    cache = jnp.zeros((1, scl))
    for T in (116, 232, 466):
        mel = jnp.zeros((1, T, 80))
        ms = t_ms(streaming._hift_hop, hparams, hcfg, key, mel, cache)
        print(f"hift frames={T}: {ms:.1f} ms/call")

    # 2. flow SFM window cost vs timesteps / window
    fcfg = flow_lib.FlowConfig(sfm=True)
    fparams = flow_lib.init_params(jax.random.PRNGKey(1), fcfg)
    spk = jnp.zeros((1, fcfg.spk_embed_dim))
    prompt_feat = jnp.zeros((1, 0, fcfg.output_size))
    for W in (128, 153, 203):
        toks = jnp.zeros((1, W), jnp.int32)
        for nt in (3, 4, 5):
            ms = t_ms(
                streaming._flow_hop, fparams, fcfg, key, toks, np.int32(W),
                prompt_feat, 0, np.int32(0), np.int32(0), 53, spk, nt, True,
            )
            print(f"flow sfm window={W} timesteps={nt}: {ms:.1f} ms/call")

    if args.trace:
        os.makedirs(args.out, exist_ok=True)
        mel = jnp.zeros((1, 116, 80))
        streaming._hift_hop(hparams, hcfg, key, mel, cache)
        with jax.profiler.trace(args.out):
            for _ in range(5):
                wav, src = streaming._hift_hop(hparams, hcfg, key, mel, cache)
                np.asarray(wav)
        profiling.print_device_ops(args.out, top=25)
        # flow hop trace (the conformer/fixed band dominates, not the ODE)
        fout = args.out + "_flow"
        os.makedirs(fout, exist_ok=True)
        toks = jnp.zeros((1, 153), jnp.int32)
        a = (fparams, fcfg, key, toks, np.int32(153), prompt_feat, 0,
             np.int32(0), np.int32(0), 53, spk, 5, True)
        streaming._flow_hop(*a)
        with jax.profiler.trace(fout):
            for _ in range(5):
                np.asarray(streaming._flow_hop(*a))
        profiling.print_device_ops(fout, top=25)


if __name__ == "__main__":
    main()
