"""int8 decode-path quality bound at flagship scale.

Protocol: greedy-rollout the bf16 0.4B model, then teacher-force the SAME
token stream through the int8-packed model and count per-step top-1
sampling-decision flips (no compounding). Together with the memorization
test (tests/test_convergence.py::test_memorized_decode_survives_int8 —
exact reproduction on a trained model), this bounds what the quantized
decode costs in quality.

Usage: python scripts/measure_int8_quality.py
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.utils import jit_cache

jit_cache.enable()


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--int4", action="store_true",
                    help="measure the int4 group-wise path instead of int8")
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--int8", action="store_true",
                    help="with --state-bf16: measure the COMBINED int8 "
                         "weights + bf16 state carry against the fp "
                         "comparator (the bench.py production candidate)")
    ap.add_argument("--state-bf16", action="store_true",
                    help="measure the bf16 decode-state carry instead of "
                         "weight quantization (same weights, state cast "
                         "at the carry boundary)")
    args = ap.parse_args()

    from rwkvtts_tpu.models import rwkv7, spark

    cfg = spark.default_config(hidden_size=args.hidden, num_layers=args.layers)
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, params
    )
    B, T_prompt, T_new = 8, 64, args.steps
    k = jax.random.PRNGKey(1)
    tokens = jax.random.randint(k, (B, T_prompt), 0, 4000)
    modality = jnp.full((B, T_prompt), spark.MOD_TEXT, jnp.int32)
    modality = modality.at[:, -1].set(spark.MOD_TAG)
    mask = jnp.ones((B, T_prompt), jnp.int32)

    from rwkvtts_tpu.infer.generate import spark_generate

    def rollout(p, c):
        toks, _ = spark_generate(
            p, c, tokens, modality, mask, jax.random.PRNGKey(2),
            max_new_tokens=T_new, top_k=1, top_p=1.0, temperature=1.0,
        )
        return np.asarray(toks)

    import dataclasses

    p_fp = rwkv7.pack_decode_params(params, cfg.backbone)
    if args.state_bf16:
        cfg_q = dataclasses.replace(
            cfg, backbone=dataclasses.replace(
                cfg.backbone, decode_state_bf16=True
            ),
        )
        if args.int8:
            # the composed production candidate: int8 weights AND the
            # bf16 state carry vs the full-precision comparator
            p_q8 = rwkv7.pack_decode_params(
                params, cfg.backbone, quantize_int8=True
            )
        else:
            # same weights; only the state carry dtype differs
            p_q8 = p_fp
    else:
        p_q8 = rwkv7.pack_decode_params(
            params, cfg.backbone,
            quantize_int8=not args.int4, quantize_int4=args.int4,
        )
        cfg_q = cfg

    ref = rollout(p_fp, cfg)
    q8_roll = rollout(p_q8, cfg_q)

    # teacher-forced decision agreement: one jitted scan walks the bf16
    # greedy stream through the model and records the greedy choice at
    # every position (params ride as ARGUMENTS — a closure would embed
    # 0.4B weights as constants in the compiled program)
    import functools

    from rwkvtts_tpu.models import spark as sp

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def forced_choices(p, cfg, tokens, modality, mask, forced):
        hk, state = sp.prefill(p, cfg, tokens, modality, mask)
        state = rwkv7.pack_decode_state(state, cfg.backbone)
        pl = rwkv7.layer_decode_views(p, cfg.backbone)

        def step(carry, tok):
            h, st = carry
            lg = (h @ p["head"].astype(cfg.backbone.dtype)).astype(jnp.float32)
            choice = jnp.argmax(lg, axis=-1)
            x = sp.decode_embed(p, cfg, tok)
            h2, st2 = rwkv7.decode_step(pl, cfg.backbone, x, st)
            return (h2, st2), choice

        _, choices = jax.lax.scan(step, (hk, state), jnp.moveaxis(forced, 1, 0))
        return jnp.moveaxis(choices, 0, 1)  # (B, T_new)

    def forced_decode(p, c):
        return np.asarray(
            forced_choices(p, c, tokens, modality, mask, jnp.asarray(ref))
        )

    t0 = time.perf_counter()
    fp_choices = forced_decode(p_fp, cfg)
    q8_choices = forced_decode(p_q8, cfg_q)
    agree = float((fp_choices == q8_choices).mean())
    roll_agree = float((ref == q8_roll).mean())
    # first divergence position per sequence in free-running greedy
    div = []
    for i in range(B):
        d = np.flatnonzero(ref[i] != q8_roll[i])
        div.append(int(d[0]) if d.size else T_new)
    print(json.dumps({
        "teacher_forced_top1_agreement": round(agree, 4),
        "free_running_token_agreement": round(roll_agree, 4),
        "median_first_divergence_step": int(np.median(div)),
        "quant": ("int8+state-bf16" if args.int8 else "state-bf16")
        if args.state_bf16 else ("int4-g64" if args.int4 else "int8"),
        "config": f"{args.hidden}x{args.layers} random-init, B=8, "
                  f"greedy, {T_new} steps",
        "wall_s": round(time.perf_counter() - t0, 1),
    }))


if __name__ == "__main__":
    main()
