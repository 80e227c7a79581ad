"""Generic training orchestration: jitted GSPMD step + data + checkpoints.

The replacement for the reference's 21 per-engine DeepSpeed scripts
(SURVEY.md §2.6): one Trainer, per-task loss adapters, checkpoint rotation,
metrics, warm-start and (new) mid-epoch resume.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.parallel import mesh as mesh_lib
from rwkvtts_tpu.parallel import train_step as ts
from rwkvtts_tpu.train import checkpoint as ckpt_lib
from rwkvtts_tpu.train import metrics as metrics_lib
from rwkvtts_tpu.train import optimizer as opt_lib

log = logging.getLogger("rwkvtts_tpu")


# ---------------------------------------------------------------------------
# Per-task loss adapters: loss_fn(params, cfg, batch, rng) -> (loss, n_valid)


def spark_loss(params, cfg, batch, rng, l2_wrap=0.0):
    from rwkvtts_tpu.models import spark

    return spark.forward(
        params, cfg, batch["tokens"], batch["modality"], labels=batch["labels"],
        attention_mask=batch.get("attention_mask"), resets=batch.get("resets"),
        dropout_rng=rng, l2_wrap=l2_wrap,
    )


def cosy_loss(params, cfg, batch, rng, l2_wrap=0.0):
    from rwkvtts_tpu.models import cosy

    return cosy.forward(
        params, cfg, batch["tokens"], batch["modality"], labels=batch["labels"],
        attention_mask=batch.get("attention_mask"), resets=batch.get("resets"),
        dropout_rng=rng,
    )


def xy_loss(params, cfg, batch, rng, l2_wrap=0.0):
    from rwkvtts_tpu.models import xy

    return xy.forward(
        params, cfg, batch["input_ids"], labels=batch["labels"],
        attention_mask=batch.get("attention_mask"), resets=batch.get("resets"),
        dropout_rng=rng,
    )


def asr_loss(params, cfg, batch, rng, l2_wrap=1e-4):
    from rwkvtts_tpu.models import asr

    return asr.forward(params, cfg, batch, l2_wrap=l2_wrap)


def two_tower_loss(params, cfg, batch, rng, l2_wrap=0.0):
    from rwkvtts_tpu.models import tts_two_tower as tt

    return tt.forward(
        params, cfg, batch["text_ids"], batch["text_mask"],
        batch["audio_ids"], batch["audio_mask"], batch["labels"],
    )


def s2s_loss(params, cfg, batch, rng, l2_wrap=1e-4):
    from rwkvtts_tpu.models import s2s

    # `_is_text` is static per-batch metadata (a python bool, not a traced
    # array): Trainer.fit strips '_'-keys from the traced batch and re-merges
    # them into the dict the loss sees via a per-metadata step_fn cache, so
    # text and audio batches get separate traces (reference T10 alternates
    # text/audio head batches).
    return s2s.forward(
        params, cfg, batch["input_ids"], attention_mask=batch.get("attention_mask"),
        is_text=bool(batch.get("_is_text", True)), labels=batch["labels"],
        l2_wrap=l2_wrap,
    )


def sfm_loss(params, cfg, batch, rng, l2_wrap=0.0):
    from rwkvtts_tpu.codecs import flow as flow_lib

    total, _ = flow_lib.sfm_loss(
        params, cfg, rng, batch["tokens"], batch["token_mask"],
        batch["feat"], batch["feat_mask"], batch["embedding"],
    )
    n = batch["feat_mask"].sum().astype("int32")
    return total, n


LOSS_FNS: Dict[str, Callable] = {
    "spark": spark_loss,
    "spark_properties": spark_loss,
    "spark_global": spark_loss,
    "cosy": cosy_loss,
    "xy": xy_loss,
    "asr": asr_loss,
    "tts_two_tower": two_tower_loss,
    "s2s": s2s_loss,
    "sfm_flow": sfm_loss,
}


@dataclasses.dataclass
class TrainerConfig:
    run_dir: str = "runs/default"
    epochs: int = 1
    save_steps: int = 1000
    keep_checkpoints: int = 2
    log_every: int = 10
    peak_lr: float = 1e-4
    final_lr: float = 1e-5
    warmup_steps: int = 1000
    total_steps: int = 100_000
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # None | "mu_bf16" | "adafactor" — low-memory optimizer state for
    # models whose fp32 Adam state exceeds one card (see train/optimizer.py)
    low_memory_opt: Optional[str] = None
    seed: int = 0
    wandb_project: Optional[str] = None
    run_name: Optional[str] = None
    mesh_shape: Optional[Dict[str, int]] = None  # e.g. {"dp": 8}


class Trainer:
    def __init__(
        self,
        model_cfg,
        params,
        loss_fn: Callable,
        tcfg: TrainerConfig,
    ):
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.tx = opt_lib.build_optimizer(
            params,
            peak_lr=tcfg.peak_lr,
            final_lr=tcfg.final_lr,
            warmup_steps=tcfg.warmup_steps,
            total_steps=tcfg.total_steps,
            weight_decay=tcfg.weight_decay,
            grad_clip=tcfg.grad_clip,
            low_memory=tcfg.low_memory_opt,
        )
        n_dev = jax.device_count()
        self.mesh = None
        if n_dev > 1:
            shape = tcfg.mesh_shape or {"dp": n_dev}
            self.mesh = mesh_lib.make_mesh(**shape)
            params = mesh_lib.shard_params(self.mesh, params)
        self.state = ts.init_train_state(params, self.tx)
        self.loss_fn = loss_fn
        # step_fns are cached per static-batch-metadata key ('_'-prefixed
        # collator fields like s2s's _is_text). The metadata can't ride the
        # traced batch (bool(tracer) fails; and values must specialize the
        # trace), so each distinct metadata tuple gets its own jitted step.
        self._step_cache: Dict[tuple, Callable] = {}
        self.step_fn = self._step_for(())
        self.logger = metrics_lib.MetricLogger(
            tcfg.run_dir, tcfg.wandb_project, tcfg.run_name
        )
        self.throughput = metrics_lib.Throughput()
        self.start_epoch = 0
        self.start_batch = 0

    def _step_for(self, static_meta: tuple) -> Callable:
        """Jitted step specialized to a batch's static '_'-metadata."""
        fn = self._step_cache.get(static_meta)
        if fn is None:
            meta = dict(static_meta)
            base = self.loss_fn

            def loss_with_meta(params, cfg, batch, rng):
                merged = dict(batch)
                merged.update(meta)
                return base(params, cfg, merged, rng)

            fn = ts.make_train_step(
                self.model_cfg, self.tx, loss_fn=loss_with_meta, mesh=self.mesh
            )
            self._step_cache[static_meta] = fn
        return fn

    @property
    def ckpt_dir(self):
        return os.path.join(self.tcfg.run_dir, "ckpt")

    def maybe_resume(self) -> bool:
        step = ckpt_lib.latest_step(self.ckpt_dir)
        if step is None:
            return False
        self.state, meta = ckpt_lib.restore(self.ckpt_dir, self.state, step)
        self.start_epoch = int(meta.get("epoch", 0))
        self.start_batch = int(meta.get("batch", 0))
        log.info("resumed at step %d (epoch %d batch %d)", step, self.start_epoch, self.start_batch)
        return True

    def save(self, epoch: int, batch: int):
        step = int(self.state.step)
        ckpt_lib.save(
            self.ckpt_dir, step, self.state,
            meta={"epoch": epoch, "batch": batch},
            keep=self.tcfg.keep_checkpoints,
        )
        log.info("saved checkpoint at step %d", step)

    def install_preemption_handler(self, signals=None):
        """Preemption-safe training: SIGTERM/SIGINT (the signals spot
        reclaims and schedulers deliver) request a checkpoint at the next
        step boundary, then fit() returns cleanly — resume with --resume.
        The reference has no preemption story at all (SURVEY §5: its fault
        tolerance ends at NaN prints and dataset read retries)."""
        import signal as _signal

        self._preempted = False

        def handler(signum, frame):
            log.warning("signal %d: checkpointing at next step boundary", signum)
            self._preempted = True

        for s in signals or (_signal.SIGTERM, _signal.SIGINT):
            _signal.signal(s, handler)

    def _drain_metrics(self, pending, all_of_them: bool = False):
        """Materialize queued step metrics (forces a device sync on THAT
        step). fit() keeps one step pending so the host prepares batch N+1
        while the device still runs step N — `int(metrics[...])` every
        step would fence the input pipeline on the step instead (JAX async
        dispatch gives the overlap for free once the sync is deferred)."""
        while pending and (all_of_them or len(pending) > 1):
            pstep, metrics = pending.pop(0)
            n_tok = int(metrics["tokens"])
            kts = self.throughput.update(n_tok)
            if pstep % self.tcfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                if kts is not None:
                    m["kt_per_s"] = kts
                self.logger.log(pstep, m, tokens=n_tok)
                loss = m["loss"]
                if not np.isfinite(loss):
                    log.warning("non-finite loss %s at step %d", loss, pstep)
                log.info("step %d loss %.4f", pstep, loss)

    def fit(self, dataset, demo_fn: Optional[Callable] = None, demo_every: int = 0):
        rng = jax.random.PRNGKey(self.tcfg.seed)
        step = int(self.state.step)
        pending: list = []
        for epoch in range(self.start_epoch, self.tcfg.epochs):
            start_batch = self.start_batch if epoch == self.start_epoch else 0
            for bi, batch in enumerate(dataset.epoch(epoch, start_batch), start=start_batch):
                rng, sub = jax.random.split(rng)
                jb = {
                    k: jnp.asarray(v)
                    for k, v in batch.items()
                    if not k.startswith("_")
                }
                static_meta = tuple(
                    sorted(
                        (k, batch[k])
                        for k in batch
                        if k.startswith("_")
                    )
                )
                step_fn = self._step_for(static_meta)
                self.state, metrics = step_fn(self.state, jb, sub)
                step += 1
                pending.append((step, metrics))
                self._drain_metrics(pending)
                if self.tcfg.save_steps and step % self.tcfg.save_steps == 0:
                    self.save(epoch, bi + 1)
                if getattr(self, "_preempted", False):
                    # mid-epoch position saved: --resume continues from the
                    # NEXT batch of this epoch
                    self._drain_metrics(pending, all_of_them=True)
                    self.save(epoch, bi + 1)
                    log.warning("preemption checkpoint saved; exiting fit()")
                    self.logger.close()
                    return self.state
                if demo_fn is not None and demo_every and step % demo_every == 0:
                    try:
                        demo_fn(self.state.params, step)
                    except Exception as e:  # demos must never kill training
                        log.warning("demo generation failed: %s", e)
            self._drain_metrics(pending, all_of_them=True)
            self.save(epoch + 1, 0)
        self.logger.close()
        return self.state
