"""Streaming TTS latency benchmark: time-to-first-audio + steady-state RTF.

Drives the incremental streaming session (infer/streaming.py) at deployed
Cosy2 sizes and reports:
  * TTFA — wall time until the first wav chunk is available (the metric the
    reference's hop/lookahead streaming exists for, cli/model.py:418-434)
  * steady-state RTF over the whole utterance
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from rwkvtts_tpu.utils import jit_cache

jit_cache.enable()


class _Tok:
    def encode(self, text):
        return [ord(c) % 6000 + 10 for c in text]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--text-len", type=int, default=60)
    ap.add_argument("--hop", type=int, default=50)
    ap.add_argument("--iters", type=int, default=3)
    # deployed pairing: --hidden 2048 --layers 24 [--int8] reproduces the
    # CosyVoice2-0.5B + RWKV-7-1.5B ship config (Inference.md:19-44)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--int8", action="store_true",
                    help="int8 LM decode weights "
                         "(quality probe: scripts/measure_int8_quality.py)")
    ap.add_argument("--int4", action="store_true",
                    help="int4 group-wise LM decode weights")
    ap.add_argument("--no-proj-fuse", action="store_true",
                    help="unfused per-projection decode weights (fewer HBM "
                         "bytes at B=1; see pack_decode_params)")
    ap.add_argument("--rank-bf16", action="store_true",
                    help="bf16 candidate ranking in the RAS sampler "
                         "(drops the per-step full-vocab fp32 TopK)")
    ap.add_argument("--sfm", action="store_true",
                    help="SFM fast decode in the flow hop (start at t_h)")
    ap.add_argument("--flow-timesteps", type=int, default=None,
                    help="ODE steps per flow hop (default: StreamConfig 10;"
                         " use ~5 with --sfm)")
    ap.add_argument("--ctx", type=int, default=None,
                    help="generated-token context kept in the flow window")
    ap.add_argument("--profile", action="store_true",
                    help="report per-hop stage times (lm chunk / flow / hift)")
    ap.add_argument("--vocode-every", type=int, default=1,
                    help="batch K hops per HiFT call after the first chunk")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable speculative LM chunk dispatch")
    ap.add_argument("--hop-max", type=int, default=None,
                    help="hop ramp cap: flow hop doubles per chunk up to "
                         "this (TTFA keeps the base hop)")
    ap.add_argument("--lm-chunk", type=int, default=None,
                    help="LM decode steps per dispatch (default = hop); "
                         "bigger chunks amortize per-dispatch host cost")
    ap.add_argument("--lm-chunk-max", type=int, default=None,
                    help="LM chunk ramp: decode this many steps per "
                         "dispatch after first audio (first chunk stays "
                         "--lm-chunk; cuts per-dispatch round trips)")
    args = ap.parse_args()

    from rwkvtts_tpu.codecs import flow as flow_lib, hift as hift_lib
    from rwkvtts_tpu.infer import streaming
    from rwkvtts_tpu.infer.cosy_pipeline import CosyPipeline
    from rwkvtts_tpu.models import cosy

    lm_cfg = cosy.default_config(hidden_size=args.hidden, num_layers=args.layers)
    lm_params = cosy.init_params(jax.random.PRNGKey(0), lm_cfg)
    fcfg = flow_lib.FlowConfig(sfm=args.sfm)
    fparams = flow_lib.init_params(jax.random.PRNGKey(1), fcfg)
    hcfg = hift_lib.HiFTConfig()
    hparams = hift_lib.init_params(jax.random.PRNGKey(2), hcfg)
    pipe = CosyPipeline(
        lm_cfg, lm_params, _Tok(), flow_cfg=fcfg, flow_params=fparams,
        hift_cfg=hcfg, hift_params=hparams, quantize_int8=args.int8,
        quantize_int4=args.int4, fuse_projections=not args.no_proj_fuse,
        sample_rank_bf16=args.rank_bf16,
    )
    skw = {"token_hop_len": args.hop, "sfm": args.sfm,
           "vocode_every": args.vocode_every, "hop_max": args.hop_max,
           "lm_prefetch": not args.no_prefetch,
           "lm_chunk": args.lm_chunk or args.hop,
           "lm_chunk_max": args.lm_chunk_max}
    if args.flow_timesteps is not None:
        skw["n_timesteps"] = args.flow_timesteps
    if args.ctx is not None:
        skw["ctx_tokens"] = args.ctx
    scfg = streaming.StreamConfig(**skw)
    text = "streaming latency benchmark " * (args.text_len // 28 + 1)
    text = text[: args.text_len]

    def run():
        t0 = time.perf_counter()
        ttfa = None
        total = 0
        for chunk in streaming.stream_synthesize(
            pipe, text, stream_cfg=scfg, max_new_tokens=400, seed=1,
        ):
            if ttfa is None:
                ttfa = time.perf_counter() - t0
            total += len(chunk)
        wall = time.perf_counter() - t0
        return ttfa, wall, total / pipe.sample_rate

    stage = {"lm": [], "flow": [], "hift": []}
    if args.profile:
        # per-stage wall times: every stage already ends in a host transfer
        # (np.asarray) so wall time == device time + dispatch
        from rwkvtts_tpu.infer.streaming import CosyStreamSession
        from rwkvtts_tpu.infer import generate as gen_mod

        wm, vc, dc = (CosyStreamSession._window_mel,
                      CosyStreamSession._vocode, gen_mod.cosy_decode_chunk)

        def timed(name, fn):
            def inner(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if name == "lm":  # force the sync the caller would do
                    np.asarray(out[1])
                stage[name].append(time.perf_counter() - t0)
                return out
            return inner

        CosyStreamSession._window_mel = timed("flow", wm)
        CosyStreamSession._vocode = timed("hift", vc)
        gen_mod.cosy_decode_chunk = timed("lm", dc)
        streaming.gen.cosy_decode_chunk = gen_mod.cosy_decode_chunk

    run()  # compile
    ttfas, rtfs = [], []
    for _ in range(args.iters):
        for v in stage.values():
            v.clear()
        ttfa, wall, audio_s = run()
        ttfas.append(ttfa)
        rtfs.append(wall / max(audio_s, 1e-9))
        if args.profile:
            parts = {
                k: (np.sum(v) * 1000, np.mean(v) * 1000, len(v))
                for k, v in stage.items() if v
            }
            acc = sum(p[0] for p in parts.values())
            print("  stages: " + " | ".join(
                f"{k} {p[0]:.0f}ms total ({p[1]:.1f}ms x{p[2]})"
                for k, p in parts.items()
            ) + f" | accounted {acc:.0f}ms of {wall*1000:.0f}ms wall")
    cfgs = f"hop {args.hop} tok | ctx {scfg.ctx_tokens} | flow " + (
        f"sfm-{scfg.n_timesteps}" if args.sfm else f"cfm-{scfg.n_timesteps}"
    ) + f" | vocode_every {scfg.vocode_every}" + (
        f" | hop_max {scfg.hop_max}" if scfg.hop_max else ""
    ) + (
        f" | lm-chunk-max {args.lm_chunk_max}" if args.lm_chunk_max else ""
    ) + (
        " | no-prefetch" if args.no_prefetch else ""
    ) + (
        " | no-proj-fuse" if args.no_proj_fuse else ""
    ) + (
        " | rank-bf16" if args.rank_bf16 else ""
    )
    print(
        f"TTFA {min(ttfas)*1000:.0f} ms | steady RTF {min(rtfs):.3f} "
        f"| audio {audio_s:.1f}s | {cfgs}"
    )


if __name__ == "__main__":
    main()
