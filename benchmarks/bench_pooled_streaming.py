"""Concurrent streaming benchmark: N streams sharing one slot pool.

The reference streams one utterance per engine thread (cli/model.py llm_job;
tts_service.py worker queue) — N concurrent streams cost ~N× one stream.
Here the LM stage is a slot pool (serving/cosy_pool.CosyStreamHub): one
compiled chunk loop decodes every active stream, vocoder hops run on the
consumer threads. Reports per-stream TTFA percentiles and the aggregate
realtime factor (total audio seconds produced per wall second).

Deployed pairing: --hidden 2048 --layers 24 [--int8] = CosyVoice2-0.5B +
RWKV-7-1.5B (Inference.md:19-44). Compare against bench_streaming_latency
(single stream) to read the concurrency win.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

# --cpu must take effect BEFORE jit_cache.enable(): enable() queries the
# default backend, which initializes it
if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from rwkvtts_tpu.utils import jit_cache

jit_cache.enable()


class _Tok:
    def encode(self, text):
        return [ord(c) % 6000 + 10 for c in text]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--hop", type=int, default=50)
    ap.add_argument("--text-len", type=int, default=60)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int4", action="store_true")
    ap.add_argument("--state-bf16", action="store_true",
                    help="bf16 WKV state carry (halves pool-state bytes)")
    ap.add_argument("--no-proj-fuse", action="store_true",
                    help="unfused per-projection decode weights (drops the "
                         "doubled fused copies — HBM headroom at 1.5B)")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffered chunks (token-identical; hides "
                         "the per-chunk host sync behind device compute)")
    ap.add_argument("--sfm", action="store_true",
                    help="SFM fast decode in the flow hop (use with "
                         "--flow-timesteps ~5)")
    ap.add_argument("--flow-timesteps", type=int, default=None,
                    help="ODE steps per flow hop (default: StreamConfig 10)")
    ap.add_argument("--ctx", type=int, default=None,
                    help="generated-token context kept in the flow window")
    ap.add_argument("--vocode-every", type=int, default=1,
                    help="batch K hops per HiFT call after the first chunk")
    ap.add_argument("--tiny", action="store_true",
                    help="toy LM/flow/HiFT dims for a CPU smoke run")
    ap.add_argument("--cpu", action="store_true",
                    help="handled at import time (before backend init)")
    args = ap.parse_args()

    from rwkvtts_tpu.codecs import conformer, flow as flow_lib, hift as hift_lib
    from rwkvtts_tpu.infer import streaming
    from rwkvtts_tpu.infer.cosy_pipeline import CosyPipeline
    from rwkvtts_tpu.models import cosy
    from rwkvtts_tpu.serving.cosy_pool import CosyStreamHub

    if args.tiny:
        args.hidden, args.layers = 32, 2
        lm_cfg = cosy.default_config(
            hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
            dtype=jax.numpy.float32, wkv_chunk=16, remat=False,
        )
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
            n_timesteps=2,
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
        lm_cfg = cosy.default_config(
            hidden_size=args.hidden, num_layers=args.layers,
            decode_state_bf16=args.state_bf16,
        )
        fcfg = flow_lib.FlowConfig(sfm=args.sfm)
        hcfg = hift_lib.HiFTConfig()
    lm_params = cosy.init_params(jax.random.PRNGKey(0), lm_cfg)
    fparams = flow_lib.init_params(jax.random.PRNGKey(1), fcfg)
    hparams = hift_lib.init_params(jax.random.PRNGKey(2), hcfg)
    pipe = CosyPipeline(
        lm_cfg, lm_params, _Tok(), flow_cfg=fcfg, flow_params=fparams,
        hift_cfg=hcfg, hift_params=hparams, quantize_int8=args.int8,
        quantize_int4=args.int4, fuse_projections=not args.no_proj_fuse,
    )
    text = "pooled streaming benchmark " * (args.text_len // 27 + 1)
    text = text[: args.text_len]

    skw = {"token_hop_len": args.hop, "sfm": args.sfm,
           "vocode_every": args.vocode_every}
    if args.flow_timesteps is not None:
        skw["n_timesteps"] = args.flow_timesteps
    if args.ctx is not None:
        skw["ctx_tokens"] = args.ctx
    hub = CosyStreamHub(
        pipe, n_slots=args.slots, chunk=args.chunk, warmup=True,
        overlap=args.overlap, stream_cfg=streaming.StreamConfig(**skw),
    )

    def drive(n_streams, record):
        t0 = time.perf_counter()
        audio = [0.0] * n_streams
        ttfa = [None] * n_streams

        def worker(i):
            for chunk in hub.stream(
                text, hop_tokens=args.hop, seed=i, max_new_tokens=400
            ):
                if ttfa[i] is None:
                    ttfa[i] = time.perf_counter() - t0
                audio[i] += len(chunk) / pipe.sample_rate

        ts = [
            threading.Thread(target=worker, args=(i,))
            for i in range(n_streams)
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t0
        if record:
            tt = sorted(1e3 * t for t in ttfa if t is not None)
            out = {
                "bench": f"pooled_streaming_{args.hidden}x{args.layers}"
                + ("_int8" if args.int8 else "")
                + ("_int4" if args.int4 else "")
                + ("_sbf16" if args.state_bf16 else "")
                + ("_nofuse" if args.no_proj_fuse else "")
                + ("_overlap" if args.overlap else "")
                + (f"_sfm{args.flow_timesteps or 10}" if args.sfm else "")
                + (f"_ctx{args.ctx}" if args.ctx is not None else "")
                + (f"_vocode{args.vocode_every}"
                   if args.vocode_every != 1 else ""),
                "streams": n_streams,
                "slots": args.slots,
                "ttfa_ms_p50": round(tt[len(tt) // 2], 0) if tt else None,
                "ttfa_ms_max": round(tt[-1], 0) if tt else None,
                "audio_s_total": round(sum(audio), 1),
                "wall_s": round(wall, 2),
                "aggregate_realtime_x": round(sum(audio) / wall, 2),
            }
            print(json.dumps(out), flush=True)

    drive(2, record=False)  # compile/warm every program shape
    drive(args.streams, record=True)
    hub.close()


if __name__ == "__main__":
    main()
