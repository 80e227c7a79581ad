"""End-to-end fit() loop throughput: host collation overlapped with device
compute.

The trainer defers metric materialization by one step (Trainer._drain_metrics)
so JAX async dispatch lets the host collate batch N+1 while the device runs
step N; `--sync-every-step` restores the old fence-every-step behavior for
the A/B. Unlike bench_train.py (raw step fn on a pre-staged device batch),
this drives the PRODUCTION path: JsonlDataset epoch -> spark collator
(world-tokenizer encode + layout build per batch) -> Trainer.fit.

Usage: python benchmarks/bench_fit_loop.py [--steps 30] [--hidden 1024
--layers 24] [--sync-every-step] [--cpu]
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
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--sem-len", type=int, default=1600, help="semantic tokens per row")
    ap.add_argument("--pad-to", type=int, default=2048)
    ap.add_argument("--sync-every-step", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from rwkvtts_tpu.utils import jit_cache

    jit_cache.enable()
    import numpy as np

    from rwkvtts_tpu.data import jsonl_dataset, spark_collator
    from rwkvtts_tpu.models import spark
    from rwkvtts_tpu.train import trainer as trainer_lib
    from rwkvtts_tpu.utils.tokenizer import get_world_tokenizer

    cfg = spark.default_config(hidden_size=args.hidden, num_layers=args.layers)
    params = spark.init_params(jax.random.PRNGKey(0), cfg)

    rng = np.random.default_rng(0)
    texts = [
        " ".join(
            rng.choice(["hello", "world", "speech", "token", "audio"], size=40)
        )
        for _ in range(64)
    ]
    n_rows = (args.steps + args.warmup) * args.batch
    rows = [
        {
            "text": texts[i % len(texts)],
            "global_tokens": rng.integers(0, 4096, 32).tolist(),
            "semantic_tokens": rng.integers(0, 8192, args.sem_len).tolist(),
        }
        for i in range(n_rows)
    ]
    tok = get_world_tokenizer()
    collate = lambda rs: spark_collator.collate_plain(
        rs, tok, cfg.eos_token_id, pad_to=args.pad_to
    )
    ds = jsonl_dataset.JsonlDataset(rows, collate, args.batch, drop_last=True)

    run_dir = f"/tmp/bench_fit_loop_{os.getpid()}"
    tcfg = trainer_lib.TrainerConfig(
        run_dir=run_dir, epochs=1, save_steps=0, log_every=10,
        total_steps=args.steps + args.warmup,
    )
    tr = trainer_lib.Trainer(cfg, params, trainer_lib.LOSS_FNS["spark"], tcfg)
    tr.save = lambda *a, **k: None  # keep orbax IO out of the timed loop
    if args.sync_every_step:
        inner = tr._drain_metrics
        tr._drain_metrics = lambda pending, all_of_them=False: inner(
            pending, all_of_them=True
        )

    # warmup epoch slice compiles the step; time the remainder by wrapping
    # the dataset so the clock starts after `warmup` batches
    t_start = [None]
    real_epoch = ds.epoch

    def timed_epoch(epoch_idx, start_batch=0):
        for i, b in enumerate(real_epoch(epoch_idx, start_batch)):
            if i == args.warmup:
                # fence everything dispatched so far, then start the clock
                np.asarray(tr.state.step)
                t_start[0] = time.perf_counter()
            yield b

    ds.epoch = timed_epoch
    state = tr.fit(ds)
    jax.block_until_ready(state.step)
    dt = time.perf_counter() - t_start[0]
    steps = args.steps
    tok_per_step = args.batch * args.pad_to
    out = {
        "bench": "fit_loop",
        "mode": "sync_every_step" if args.sync_every_step else "overlapped",
        "hidden": args.hidden,
        "layers": args.layers,
        "batch": args.batch,
        "steps": steps,
        "s_per_step": round(dt / steps, 4),
        "kt_per_s_chip": round(steps * tok_per_step / dt / 1e3, 1),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
