"""Decompose the streaming vocoder costs: per-call flow and HiFT cost
against their non-streaming equivalents.

This probe isolates, on the REAL production-size flow/HiFT configs:
  * flow hop cost vs n_timesteps (1/3/5), ctx (0/25/50), hop (50/100)
    -> fixed dispatch cost vs per-estimator-eval cost vs window-size cost
  * HiFT call cost vs mel length (1/2/4 hops of 100 frames, cached path)
    -> fixed-vs-linear split; explains the vocode_every=4 negative

Usage: python scripts/probe_stream_vocoder.py [--cpu] [--iters 5]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from rwkvtts_tpu.utils import jit_cache

jit_cache.enable()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny configs (CPU smoke)")
    args = ap.parse_args()

    from rwkvtts_tpu.codecs import conformer, flow as flow_lib, hift as hift_lib
    from rwkvtts_tpu.infer import streaming

    if args.tiny:
        fcfg = flow_lib.FlowConfig(
            input_size=24, output_size=16, spk_embed_dim=12, vocab_size=6562,
            encoder=conformer.UpsampleConformerConfig(
                input_size=24, output_size=24, attention_heads=2,
                linear_units=48, num_blocks=1, num_up_blocks=1,
            ),
            estimator=flow_lib.EstimatorConfig(
                in_channels=16 * 4, out_channels=16, channels=(16,),
                n_blocks=1, num_mid_blocks=1, num_heads=2,
                attention_head_dim=8, causal=True, static_chunk_size=2,
            ),
            sfm=True,
        )
        hcfg = hift_lib.HiFTConfig(
            in_channels=16, base_channels=32, nb_harmonics=2,
            upsample_rates=(4, 3), upsample_kernel_sizes=(8, 7),
            istft_n_fft=16, istft_hop_len=4,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
            source_resblock_kernel_sizes=(7, 7),
            source_resblock_dilation_sizes=((1, 2), (1, 2)),
            f0_cond_channels=16,
        )
    else:
        fcfg = flow_lib.FlowConfig(sfm=True)
        hcfg = hift_lib.HiFTConfig()
    fparams = flow_lib.init_params(jax.random.PRNGKey(1), fcfg)
    hparams = hift_lib.init_params(jax.random.PRNGKey(2), hcfg)
    pipe = SimpleNamespace(
        flow_cfg=fcfg, flow_params=fparams, hift_cfg=hcfg,
        hift_params=hparams,
    )

    def time_flow(ts, ctx, hop):
        sess = streaming.CosyStreamSession(
            pipe, streaming.StreamConfig(
                token_hop_len=hop, ctx_tokens=ctx, n_timesteps=ts, sfm=True,
            ),
        )
        rng = np.random.default_rng(0)
        toks = rng.integers(0, fcfg.vocab_size - 2, 8 * hop + ctx)
        off = ctx + hop  # past the warm-up region: full ctx window
        sess._window_mel(toks, off, hop)  # compile + warm
        best = float("inf")
        for _ in range(args.iters):
            t0 = time.perf_counter()
            sess._window_mel(toks, off, hop)
            best = min(best, time.perf_counter() - t0)
        print(json.dumps({
            "probe": "flow_hop", "timesteps": ts, "ctx": ctx, "hop": hop,
            "ms": round(best * 1e3, 1),
        }), flush=True)

    # n_timesteps sweep (fixed window): per-estimator-eval cost
    for ts in (1, 3, 5):
        time_flow(ts, 50, 50)
    # window sweep (fixed timesteps): conformer/window cost
    for ctx in (0, 25):
        time_flow(5, ctx, 50)
    # hop 100 (the vocode-batching alternative: 1 flow call per 4 s)
    for ts in (3, 5):
        time_flow(ts, 50, 100)

    def time_hift(k_hops, hop=50):
        sess = streaming.CosyStreamSession(
            pipe, streaming.StreamConfig(token_hop_len=hop, sfm=True),
        )
        frames = fcfg.token_mel_ratio * hop
        rng = np.random.default_rng(1)
        mel1 = rng.standard_normal((1, frames, fcfg.output_size)).astype(
            np.float32
        )
        sess._vocode(mel1, finalize=False)  # establish caches (+compile)
        melk = rng.standard_normal(
            (1, k_hops * frames, fcfg.output_size)
        ).astype(np.float32)
        sess._vocode(melk, finalize=False)  # compile the k-hop program
        best = float("inf")
        for _ in range(args.iters):
            t0 = time.perf_counter()
            sess._vocode(melk, finalize=False)
            best = min(best, time.perf_counter() - t0)
        print(json.dumps({
            "probe": "hift_call", "k_hops": k_hops, "hop": hop,
            "frames": k_hops * frames, "ms": round(best * 1e3, 1),
        }), flush=True)

    for k in (1, 2, 4):
        time_hift(k)


if __name__ == "__main__":
    main()
