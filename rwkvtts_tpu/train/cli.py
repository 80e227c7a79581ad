"""Unified training CLI — one entry point for every engine.

Replaces the reference's 21 DeepSpeed launch scripts (SURVEY.md §2.6) with
one GSPMD-sharded trainer:

    python -m rwkvtts_tpu.train.cli --task spark_properties \\
        --data '/data/*.jsonl' --hidden 768 --layers 12 \\
        --batch-size 8 --pad-to 2048 --run-dir runs/spark

Tasks: spark | spark_properties | spark_global | cosy | xy | asr | s2s |
tts_two_tower. Checkpoints rotate under <run-dir>/ckpt (numpy .npz); metrics in
<run-dir>/metrics.jsonl; --resume continues from the latest checkpoint
including the mid-epoch data position.
"""
from __future__ import annotations

import argparse
import functools
import logging
from typing import Callable

import jax
import jax.numpy as jnp

from rwkvtts_tpu.data import jsonl_dataset
from rwkvtts_tpu.train import metrics as metrics_lib
from rwkvtts_tpu.train import trainer as trainer_lib

log = logging.getLogger("rwkvtts_tpu")


def build_model(task: str, args):
    kw = dict(
        hidden_size=args.hidden, num_layers=args.layers,
        dtype=jnp.bfloat16 if args.bf16 else jnp.float32,
        head_size=args.head_size,
    )
    if getattr(args, "wkv_spans", None):
        # two-level / sequence-parallel WKV (the --mesh sp=N path sets
        # this to match the sharding)
        kw["wkv_spans"] = args.wkv_spans
    if getattr(args, "remat_policy", None):
        kw["remat_policy"] = args.remat_policy
    key = jax.random.PRNGKey(args.seed)
    if task.startswith("spark"):
        from rwkvtts_tpu.models import spark

        cfg = spark.default_config(**kw)
        return cfg, spark.init_params(key, cfg)
    if task == "cosy":
        from rwkvtts_tpu.models import cosy

        cfg = cosy.default_config(**kw)
        return cfg, cosy.init_params(key, cfg)
    if task == "xy":
        from rwkvtts_tpu.models import xy

        cfg = xy.default_config(**kw)
        return cfg, xy.init_params(key, cfg)
    if task == "asr":
        from rwkvtts_tpu.models import asr

        # the shared kw (head_size, wkv_spans, remat policy) flows
        # into BOTH towers — --mesh sp=N must reach every wkv call or the
        # T-sharded chunk scan silently gathers cross-device (review r3)
        akw = {k: v for k, v in kw.items()
               if k not in ("hidden_size", "num_layers", "dtype")}
        cfg = asr.default_config(
            hidden_size=args.hidden, num_layers=args.layers,
            dtype=jnp.bfloat16 if args.bf16 else jnp.float32, **akw,
        )
        return cfg, asr.init_params(key, cfg)
    if task == "s2s":
        from rwkvtts_tpu.models import s2s

        cfg = s2s.default_config(**kw)
        return cfg, s2s.init_params(key, cfg)
    if task == "sfm_flow":
        from rwkvtts_tpu.codecs import flow as flow_lib

        cfg = flow_lib.FlowConfig(sfm=True)
        return cfg, flow_lib.init_params(key, cfg)
    if task == "tts_two_tower":
        from rwkvtts_tpu.models import tts_two_tower as tt

        tkw = {k: v for k, v in kw.items()
               if k not in ("hidden_size", "num_layers", "dtype")}
        cfg = tt.default_config(
            text_hidden=args.hidden, text_layers=args.layers,
            audio_hidden=args.hidden, audio_layers=args.layers,
            dtype=jnp.bfloat16 if args.bf16 else jnp.float32, **tkw,
        )
        return cfg, tt.init_params(key, cfg)
    raise ValueError(f"unknown task {task}")


def build_collate(task: str, args, model_cfg) -> Callable:
    from rwkvtts_tpu.utils.tokenizer import get_world_tokenizer

    tok = get_world_tokenizer(n_spct=64 if "properties" in task or "global" in task else 0)
    if task.startswith("spark"):
        from rwkvtts_tpu.data import spark_collator as sc

        fn = {
            "spark": sc.collate_plain,
            "spark_properties": sc.collate_with_properties,
            "spark_global": sc.collate_global_tokens,
        }[task]
        kw2 = {}
        if task == "spark_properties" and args.mark_phonemes_prob > 0:
            kw2["mark_phonemes_prob"] = args.mark_phonemes_prob
        return functools.partial(
            fn, tokenizer=tok, eos_id=model_cfg.eos_token_id,
            pad_to=args.pad_to, packed=args.packed, **kw2,
        )
    if task == "cosy":
        from rwkvtts_tpu.data import cosy_collator as cc

        return functools.partial(
            cc.collate, tokenizer=tok, eos_id=model_cfg.eos_token_id,
            drop_prompt_audio_rate=args.drop_prompt_audio_rate,
            pad_to=args.pad_to, packed=args.packed,
        )
    if task == "xy":
        from rwkvtts_tpu.data import xy_collator as xc

        return functools.partial(xc.collate, tokenizer=tok, pad_to=args.pad_to)
    if task == "asr":
        from rwkvtts_tpu.data import asr_collator as ac

        return functools.partial(ac.collate, tokenizer=tok)
    if task == "sfm_flow":
        from rwkvtts_tpu.data import sfm_collator as sfc

        return functools.partial(sfc.collate, pad_tokens_to=args.pad_to)
    if task == "s2s":
        from rwkvtts_tpu.data import s2s_collator as s2c

        # text/audio batches alternate per call via a stateful toggle
        state = {"text": True}

        def alternating(rows):
            state["text"] = not state["text"]
            return s2c.collate_s2s(
                rows, tok, is_text=state["text"], pad_to=args.pad_to,
                text_vocab=model_cfg.text_vocab_size,
            )

        return alternating
    if task == "tts_two_tower":
        from rwkvtts_tpu.data import s2s_collator as s2c

        return functools.partial(
            s2c.collate_two_tower, tokenizer=tok, pad_audio_to=args.pad_to
        )
    raise ValueError(f"no jsonl collator for task {task} — use a custom driver")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", required=True, choices=sorted(trainer_lib.LOSS_FNS))
    p.add_argument("--data", nargs="+", required=True, help="jsonl glob(s) or tar paths")
    p.add_argument("--data-format", choices=["jsonl", "webdataset"], default="jsonl")
    p.add_argument("--codec-dir", default=None,
                   help="SparkTTS model dir for inline tokenization (webdataset format)")
    p.add_argument("--run-dir", default="runs/default")
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--head-size", type=int, default=64)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--pad-to", type=int, default=2048)
    p.add_argument("--packed", action="store_true")
    p.add_argument("--max-tokens-k", type=int, default=0, help="token budget (thousands)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-final", type=float, default=1e-5)
    p.add_argument("--warmup-steps", type=int, default=1000)
    p.add_argument("--total-steps", type=int, default=100_000)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument(
        "--low-memory-opt", choices=["mu_bf16", "adafactor"], default=None,
        help="shrink optimizer state for models whose fp32 Adam slots "
             "exceed one card's memory; LR groups/schedule/"
             "wd mask unchanged — see train/optimizer.py",
    )
    p.add_argument("--save-steps", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--remat-policy", default=None,
                   choices=["dots", "dots_no_batch"],
                   help="selective rematerialization (default: full replay)")
    p.add_argument("--mesh", default=None,
                   help="device-mesh shape, e.g. dp=2,fsdp=2 or dp=2,sp=4 "
                        "(default: all devices on dp). sp shards the TIME "
                        "axis — long-audio sequence parallelism; it also "
                        "sets wkv_spans to match")
    p.add_argument("--wkv-spans", type=int, default=None,
                   help="two-level hierarchical WKV chunking factor "
                        "(default 1; set automatically by --mesh sp=N)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--warm-start", default=None, help="ckpt file to init params from")
    p.add_argument("--drop-prompt-audio-rate", type=float, default=0.5)
    p.add_argument("--wandb-project", default=None)
    p.add_argument("--run-name", default=None)
    p.add_argument("--max-rows", type=int, default=None)
    p.add_argument("--multihost", action="store_true",
                   help="call jax.distributed.initialize() for multi-host jobs")
    p.add_argument("--mark-phonemes-prob", type=float, default=0.0,
                   help="IPA-annotate text with this probability (spark_properties ipa-ft variant)")
    p.add_argument(
        "--dry-run", action="store_true",
        help="load model+data, run one collated batch through the train "
        "step, then exit (the reference's test_training_setup.py)",
    )
    args = p.parse_args(argv)

    metrics_lib.setup_logging()
    if args.multihost:
        jax.distributed.initialize()
    # after distributed init: enable() starts the backend
    from rwkvtts_tpu.utils import jit_cache

    jit_cache.enable()
    mesh_shape = None
    if args.mesh:
        mesh_shape = {
            k: int(v)
            for k, v in (kv.split("=") for kv in args.mesh.split(","))
        }
        bad = set(mesh_shape) - {"dp", "fsdp", "tp", "sp"}
        if bad:
            p.error(f"--mesh: unknown axes {sorted(bad)}")
        sp = mesh_shape.get("sp", 1)
        if sp > 1:
            if args.wkv_spans is None:
                # the time axis shards over sp in wkv_spans pieces
                args.wkv_spans = sp
            elif args.wkv_spans % sp != 0:
                # spans that don't tile the sp shards would silently
                # reshard every heavy tensor instead of staying local
                p.error(
                    f"--wkv-spans {args.wkv_spans} must be a multiple of "
                    f"the mesh sp={sp}"
                )
    cfg, params = build_model(args.task, args)
    if mesh_shape and mesh_shape.get("sp", 1) > 1:
        bb = getattr(cfg, "backbone", None) or getattr(cfg, "llm", cfg)
        unit = bb.wkv_chunk * bb.wkv_spans
        if args.pad_to and args.pad_to % unit != 0:
            log.warning(
                "--pad-to %d is not a multiple of wkv_chunk*wkv_spans=%d: "
                "the padded tail breaks span/shard alignment and the sp "
                "path degenerates to cross-device gathers (still correct, "
                "just slow) — pick a multiple", args.pad_to, unit,
            )

    if args.warm_start:
        from rwkvtts_tpu.convert import rwkv7_ckpt, speech_init

        sd = rwkv7_ckpt.load_torch_or_safetensors(args.warm_start)
        if args.task.startswith("spark"):
            params = speech_init.spark_from_text(sd, params, cfg)
        else:
            log.warning("warm-start surgery only wired for spark tasks here")
        params = jax.tree.map(jnp.asarray, params)

    collate = build_collate(args.task, args, cfg)
    if args.data_format == "webdataset":
        import glob as _glob

        from rwkvtts_tpu.data import webdataset as wds

        tars: list = []
        for pat in args.data:
            tars.extend(sorted(_glob.glob(pat)))
        ds_w = wds.MultipleWebDataset(tars, seed=args.seed)
        rows = ds_w.samples[: args.max_rows] if args.max_rows else ds_w.samples
        if args.task.startswith("spark") and args.codec_dir:
            from rwkvtts_tpu.codecs.spark_tokenizer import SparkAudioTokenizer
            from rwkvtts_tpu.data.inline_spark import make_inline_spark_collate
            from rwkvtts_tpu.utils.tokenizer import get_world_tokenizer

            codec = SparkAudioTokenizer.from_pretrained(args.codec_dir)
            collate = make_inline_spark_collate(
                codec, get_world_tokenizer(), cfg.eos_token_id,
                pad_to=args.pad_to, packed=args.packed,
            )
    else:
        rows = jsonl_dataset.load_jsonl_rows(
            args.data, jax.process_index(), jax.process_count(), max_rows=args.max_rows
        )
    log.info("loaded %d rows", len(rows))
    ds = jsonl_dataset.JsonlDataset(
        rows, collate, args.batch_size, seed=args.seed,
        max_tokens=args.max_tokens_k * 1000 if args.max_tokens_k else None,
    )

    tcfg = trainer_lib.TrainerConfig(
        run_dir=args.run_dir, epochs=args.epochs, save_steps=args.save_steps,
        log_every=args.log_every, peak_lr=args.lr, final_lr=args.lr_final,
        warmup_steps=args.warmup_steps, total_steps=args.total_steps,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        low_memory_opt=args.low_memory_opt, mesh_shape=mesh_shape,
        seed=args.seed, wandb_project=args.wandb_project, run_name=args.run_name,
    )
    tr = trainer_lib.Trainer(cfg, params, trainer_lib.LOSS_FNS[args.task], tcfg)
    if args.dry_run:
        import numpy as np

        batch = next(ds.epoch(0))
        jb = {k: jnp.asarray(v) for k, v in batch.items() if not k.startswith("_")}
        tr.state, m = tr.step_fn(tr.state, jb, jax.random.PRNGKey(0))
        log.info("dry run ok: loss=%.4f tokens=%d", float(m["loss"]), int(m["tokens"]))
        assert np.isfinite(float(m["loss"]))
        return
    if args.resume:
        tr.maybe_resume()
    # preemption safety: SIGTERM/SIGINT checkpoint mid-epoch position
    # and exit cleanly; relaunch with --resume to continue
    tr.install_preemption_handler()
    tr.fit(ds)


if __name__ == "__main__":
    main()
