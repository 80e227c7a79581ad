"""Serving launcher: checkpoint -> pipeline -> ContinuousTTSService -> HTTP.

The production serving path (reference: service/rwkv_tts_service.py main +
uvicorn): loads an RWKV7ForSpeech checkpoint (HF safetensors / torch .pt /
BlinkDL .pth via convert.rwkv7_ckpt) and the BiCodec model dir, then serves
/api/rwkv_tts through the continuous batcher (mixed-voice slot pool) —
pass --grouped to fall back to the same-voice grouping dispatcher.

    python -m rwkvtts_tpu.serving.launch --ckpt model.safetensors \
        --codec-dir Spark-TTS-0.5B --demo-dir demos --port 8000
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional

log = logging.getLogger("rwkvtts_tpu")


def build_pipeline(ckpt: str, codec_dir: Optional[str] = None,
                   int8: bool = False, int4: bool = False,
                   state_bf16: bool = False):
    import jax.numpy as jnp

    from rwkvtts_tpu.convert import rwkv7_ckpt, speech_init
    from rwkvtts_tpu.infer.spark_pipeline import SparkPipeline
    from rwkvtts_tpu.models import spark
    from rwkvtts_tpu.utils.tokenizer import get_world_tokenizer

    sd = rwkv7_ckpt.load_torch_or_safetensors(ckpt)
    kw = rwkv7_ckpt.infer_config_kwargs(sd)
    cfg = spark.default_config(
        hidden_size=kw["hidden_size"], num_layers=kw["num_layers"],
        # head_size from the ckpt too: a 128-wide-head model would
        # otherwise silently mis-group (B,T,H,N) reshapes at serve time
        head_size=kw["head_size"],
        # bf16 decode-state carry: halves the pool's state bytes
        decode_state_bf16=state_bf16,
    )
    params = speech_init.spark_from_pretrained_sd(sd, cfg)
    import jax

    params = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.bfloat16)
        if getattr(x, "ndim", 0) >= 2 else jnp.asarray(x),
        params,
    )
    codec = None
    if codec_dir:
        from rwkvtts_tpu.codecs.spark_tokenizer import SparkAudioTokenizer

        codec = SparkAudioTokenizer.from_pretrained(codec_dir)
    tok = get_world_tokenizer(n_spct=48)
    return SparkPipeline(
        cfg, params, tok, audio_tokenizer=codec, quantize_int8=int8,
        quantize_int4=int4,
    )


def build_service(
    pipeline,
    demo_dir: Optional[str] = None,
    continuous: bool = True,
    n_slots: int = 96,
    chunk: int = 32,
    max_new_tokens: int = 1024,
    top_k: int = 50,
    top_p: float = 0.95,
    temperature: float = 1.0,
    warmup: bool = True,
    warmup_widths=None,
    dp: int = 1,
    overlap: bool = False,
):
    from rwkvtts_tpu.serving import service as svc

    speakers = svc.SpeakerLibrary(demo_dir, codec=pipeline.codec)
    if continuous:
        return svc.ContinuousTTSService(
            pipeline, speakers, n_slots=n_slots, chunk=chunk,
            max_new_tokens=max_new_tokens, top_k=top_k, top_p=top_p,
            temperature=temperature, warmup=warmup,
            warmup_widths=warmup_widths, dp=dp, overlap=overlap,
        )
    return svc.BatchedTTSService(
        pipeline, speakers, max_new_tokens=max_new_tokens
    )


def build_cosy_pipeline(ckpt: str, cosy_dir: Optional[str] = None,
                        int8: bool = False, int4: bool = False):
    """RWKV7CosyLM weights + a CosyVoice2 model dir (flow.pt / hift.pt /
    speech_tokenizer_v2.onnx / campplus.onnx — the reference's
    pretrained_models layout) -> CosyPipeline. Missing codec files degrade
    gracefully: the LM still serves, zero-shot-from-wav needs the onnx
    pair, wav output needs flow+hift."""
    import os

    import jax
    import jax.numpy as jnp

    from rwkvtts_tpu.codecs import campplus as cp
    from rwkvtts_tpu.codecs import cosy_import
    from rwkvtts_tpu.codecs import flow as flow_lib, hift as hift_lib
    from rwkvtts_tpu.codecs import s3_tokenizer as s3
    from rwkvtts_tpu.convert import rwkv7_ckpt, speech_init
    from rwkvtts_tpu.infer.cosy_pipeline import CosyPipeline
    from rwkvtts_tpu.models import cosy
    from rwkvtts_tpu.utils.tokenizer import get_world_tokenizer

    sd = rwkv7_ckpt.load_torch_or_safetensors(ckpt)
    kw = rwkv7_ckpt.infer_config_kwargs(sd)
    cfg = cosy.default_config(
        hidden_size=kw["hidden_size"], num_layers=kw["num_layers"],
        head_size=kw["head_size"],
    )
    params = speech_init.cosy_from_pretrained_sd(sd, cfg)
    params = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.bfloat16)
        if getattr(x, "ndim", 0) >= 2 else jnp.asarray(x),
        params,
    )
    pk = {}
    if cosy_dir:
        p = lambda n: os.path.join(cosy_dir, n)
        if os.path.exists(p("flow.pt")):
            fcfg = flow_lib.FlowConfig()
            pk.update(flow_cfg=fcfg, flow_params=cosy_import.flow_from_state_dict(
                rwkv7_ckpt.load_torch_or_safetensors(p("flow.pt")), fcfg))
        if os.path.exists(p("hift.pt")):
            hcfg = hift_lib.HiFTConfig()
            pk.update(hift_cfg=hcfg, hift_params=cosy_import.hift_from_state_dict(
                rwkv7_ckpt.load_torch_or_safetensors(p("hift.pt")), hcfg))
        if os.path.exists(p("speech_tokenizer_v2.onnx")):
            s3_cfg = s3.S3TokenizerConfig()
            pk.update(s3_cfg=s3_cfg,
                      s3_params=s3.s3_from_onnx(p("speech_tokenizer_v2.onnx"), s3_cfg))
        if os.path.exists(p("campplus.onnx")):
            cam_cfg = cp.CampplusConfig()
            pk.update(campplus_cfg=cam_cfg,
                      campplus_params=cp.load_campplus_onnx(p("campplus.onnx"), cam_cfg))
        missing = [n for n in ("flow.pt", "hift.pt", "speech_tokenizer_v2.onnx",
                               "campplus.onnx") if not os.path.exists(p(n))]
        if missing:
            log.warning("cosy dir %s missing %s — serving degrades "
                        "accordingly", cosy_dir, missing)
    return CosyPipeline(
        cfg, params, get_world_tokenizer(), quantize_int8=int8,
        quantize_int4=int4, **pk,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True, help="RWKV7ForSpeech weights")
    ap.add_argument("--family", default="spark", choices=["spark", "cosy"],
                    help="spark: BiCodec voice-in-prompt serving (default); "
                         "cosy: CosyVoice2 zero-shot serving, every request "
                         "through the shared streaming slot pool")
    ap.add_argument("--cosy-dir", default=None,
                    help="CosyVoice2 model dir (flow.pt/hift.pt/"
                         "speech_tokenizer_v2.onnx/campplus.onnx)")
    ap.add_argument("--voices-dir", default=None,
                    help="stored zero-shot voice library dir (cosy family)")
    ap.add_argument("--codec-dir", default=None, help="Spark-TTS model dir (BiCodec)")
    ap.add_argument("--demo-dir", default=None, help="demos/<speaker>/*.wav library")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--n-slots", type=int, default=96)
    # 16 halves worst-case admission latency at some throughput cost
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--int8", action="store_true",
                    help="int8 decode weights (quality probe: "
                         "scripts/measure_int8_quality.py)")
    ap.add_argument("--int4", action="store_true",
                    help="int4 group-wise decode weights (quality probe: "
                         "scripts/measure_int8_quality.py --int4)")
    ap.add_argument("--state-bf16", action="store_true",
                    help="bf16 decode-state carry (memorized-decode "
                         "CI-bounded)")
    ap.add_argument("--max-new-tokens", type=int, default=1024)
    # family-resolved defaults: spark 50/0.95 (simple_generate.py:46-56),
    # cosy RAS 25/0.8 (cosy_llm.py:169-177)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--grouped", action="store_true",
                    help="legacy same-voice grouping dispatcher")
    ap.add_argument("--dp", type=int, default=1,
                    help="shard the slot pool over a dp device mesh "
                         "(multi-card serving; n-slots must divide)")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffered chunks: dispatch N+1 before "
                         "syncing N (token-identical; hides host sync)")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--warmup-widths", default=None,
                    help="comma-separated prompt widths to precompile at "
                         "boot (e.g. 128,256) so a long prompt never "
                         "compiles at admission time; default: prompt cap")
    ap.add_argument("--sfm", action="store_true",
                    help="(cosy) SFM fast flow decode in streaming hops; "
                         "needs an sfm_head in the flow params")
    ap.add_argument("--flow-timesteps", type=int, default=None,
                    help="(cosy) ODE steps per streaming flow hop "
                         "(default 10; ~5 with --sfm)")
    ap.add_argument("--stream-ctx", type=int, default=None,
                    help="(cosy) generated-token context in the flow "
                         "window (smaller = cheaper hops)")
    ap.add_argument("--vocode-every", type=int, default=1,
                    help="(cosy) batch K hops per HiFT call after the "
                         "first chunk")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from rwkvtts_tpu.utils import jit_cache

    jit_cache.enable()
    if args.family == "cosy":
        from rwkvtts_tpu.serving import http_server, service as svc

        pipeline = build_cosy_pipeline(
            args.ckpt, args.cosy_dir, int8=args.int8, int4=args.int4
        )
        voices = None
        if args.voices_dir:
            from rwkvtts_tpu.infer.voices import CosyVoiceLibrary

            voices = CosyVoiceLibrary(args.voices_dir)
        stream_cfg = None
        if (args.sfm or args.flow_timesteps is not None
                or args.stream_ctx is not None or args.vocode_every != 1):
            from rwkvtts_tpu.infer import streaming

            skw = {"sfm": args.sfm, "vocode_every": args.vocode_every}
            if args.flow_timesteps is not None:
                skw["n_timesteps"] = args.flow_timesteps
            if args.stream_ctx is not None:
                skw["ctx_tokens"] = args.stream_ctx
            stream_cfg = streaming.StreamConfig(**skw)
        tts = svc.CosyTTSService(
            pipeline, voices=voices, n_slots=args.n_slots, chunk=args.chunk,
            max_new_tokens=args.max_new_tokens,
            top_k=args.top_k if args.top_k is not None else 25,
            top_p=args.top_p if args.top_p is not None else 0.8,
            warmup=not args.no_warmup,
            warmup_widths=(
                [int(w) for w in args.warmup_widths.split(",")]
                if args.warmup_widths else None
            ),
            overlap=args.overlap,
            stream_cfg=stream_cfg,
        )
        http_server.serve(tts, args.host, args.port)
        return
    pipeline = build_pipeline(
        args.ckpt, args.codec_dir, int8=args.int8, int4=args.int4,
        state_bf16=args.state_bf16,
    )
    tts = build_service(
        pipeline, args.demo_dir, continuous=not args.grouped,
        n_slots=args.n_slots, chunk=args.chunk,
        max_new_tokens=args.max_new_tokens,
        top_k=args.top_k if args.top_k is not None else 50,
        top_p=args.top_p if args.top_p is not None else 0.95,
        temperature=args.temperature,
        warmup=not args.no_warmup,
        warmup_widths=(
            [int(w) for w in args.warmup_widths.split(",")]
            if args.warmup_widths else None
        ),
        dp=args.dp, overlap=args.overlap,
    )
    from rwkvtts_tpu.serving import http_server

    http_server.serve(tts, args.host, args.port)


if __name__ == "__main__":
    main()
