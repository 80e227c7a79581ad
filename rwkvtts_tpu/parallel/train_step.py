"""pjit train-step factory — the replacement for the reference's
DeepSpeed engine loop (train_..._properties.py:270-284,555-556).

One jitted function: forward (fused CE) → grad → optax update. Gradient
all-reduce, ZeRO-style param gathering, and any tensor-parallel collectives
are all GSPMD-inserted from the shardings in parallel/mesh.py — no explicit
communication code.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from rwkvtts_tpu.models import spark as spark_model
from rwkvtts_tpu.parallel import mesh as mesh_lib


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array


def init_train_state(params, tx) -> TrainState:
    return TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))


def spark_loss_fn(params, cfg, batch, rng, l2_wrap=0.0):
    loss, n_valid = spark_model.forward(
        params,
        cfg,
        batch["tokens"],
        batch["modality"],
        labels=batch["labels"],
        attention_mask=batch.get("attention_mask"),
        resets=batch.get("resets"),
        dropout_rng=rng,
        l2_wrap=l2_wrap,
    )
    return loss, n_valid


def _infer_compute_dtype(cfg) -> Any:
    for attr in ("backbone", "llm"):
        inner = getattr(cfg, attr, None)
        if inner is not None and hasattr(inner, "dtype"):
            return inner.dtype
    return getattr(cfg, "dtype", None)


def cast_weights(params, dtype):
    """One whole-tree weight cast, applied OUTSIDE the remat regions.

    The model bodies cast per-leaf (`p.astype(cfg.dtype)`); under
    jax.checkpoint those casts replay in the backward pass, re-reading the
    fp32 master weights from HBM. Pre-casting makes every in-body cast an
    identity, so forward + remat replay read bf16 — half the weight
    bandwidth on the weight reads of the train step.

    Norm parameters (ln0/ln1/ln2/ln_x/ln_out scales+biases — stacked (L,C)
    so ndim>=2) are exempt: the model consumes them in fp32 inside
    ops/norm.py with no in-body bf16 cast, so precasting them would NOT be
    an identity — it would silently round the norm affine terms to bf16."""

    def one(path, x):
        if not (hasattr(x, "dtype") and x.dtype == jnp.float32 and x.ndim >= 2):
            return x
        key = str(getattr(path[-1], "key", path[-1])) if path else ""
        if key.startswith("ln"):
            return x
        return x.astype(dtype)

    return jax.tree_util.tree_map_with_path(one, params)


def make_train_step(
    cfg,
    tx: optax.GradientTransformation,
    loss_fn: Callable = spark_loss_fn,
    mesh=None,
    donate: bool = True,
):
    """Returns step(state, batch, rng) -> (state, metrics), jitted with
    sharded in/out when a mesh is given."""
    compute_dtype = _infer_compute_dtype(cfg)
    precast = compute_dtype == jnp.bfloat16

    def step(state: TrainState, batch, rng):
        def wrapped_loss(params, cfg, batch, rng):
            if precast:
                params = cast_weights(params, jnp.bfloat16)
            return loss_fn(params, cfg, batch, rng)

        (loss, n_valid), grads = jax.value_and_grad(wrapped_loss, has_aux=True)(
            state.params, cfg, batch, rng
        )
        gnorm = optax.global_norm(grads)
        # failure containment (SURVEY.md §5 — the reference only prints on
        # NaN/Inf loss): a non-finite loss or grad norm skips the update
        # entirely, keeping params/opt state intact. The step still counts
        # so LR schedules stay aligned with the data position.
        finite = jnp.isfinite(loss) & jnp.isfinite(gnorm)
        safe_grads = jax.tree.map(
            lambda g: jnp.where(finite, g, jnp.zeros_like(g)), grads
        )
        updates, opt_state = tx.update(
            safe_grads, state.opt_state, state.params
        )
        updates = jax.tree.map(
            lambda u: jnp.where(finite, u, jnp.zeros_like(u)), updates
        )
        opt_state = jax.tree.map(
            lambda new, old: jnp.where(finite, new, old)
            if hasattr(new, "dtype") else new,
            opt_state, state.opt_state,
        )
        params = optax.apply_updates(state.params, updates)
        metrics = {
            "loss": loss,
            "tokens": n_valid,
            "grad_norm": gnorm,
            "skipped": (~finite).astype(jnp.int32),
        }
        return TrainState(params, opt_state, state.step + 1), metrics

    if mesh is None:
        return jax.jit(step, donate_argnums=(0,) if donate else ())

    bsh = mesh_lib.batch_sharding(mesh)
    # rank-1 leaves can't take the (batch, time) spec of an sp mesh
    bsh1 = jax.sharding.NamedSharding(mesh, mesh_lib.batch_spec(sp=False))

    # Sharding constraints are applied inside the jitted fn (params arrive
    # already sharded via shard_params; GSPMD propagates the rest).
    def sharded_step(state, batch, rng):
        batch = {
            k: jax.lax.with_sharding_constraint(
                v, bsh if getattr(v, "ndim", 0) >= 2 else bsh1
            )
            for k, v in batch.items()
        }
        return step(state, batch, rng)

    return jax.jit(sharded_step, donate_argnums=(0,) if donate else ())
