"""Checks shared by `chip_smoke.py`, `bench.py` and their CPU tests.

Device facts (backend, card name, power limit), the result line, a
relative-error comparison that states its tolerance and reason, and three
comparisons of the system against a plain reference:

  * `decode_parity`: prefill then decode through the carried state against
    a float32 full-sequence forward at `precision="highest"` (a float32
    matmul on the GPU may otherwise run in TF32);
  * `train_step_once`: one step of the train step `train/cli.py` builds,
    on one device or on a mesh, for comparing the two;
  * `pool_first_step`: the first decode step of the continuous slot pool,
    on one device or dp-sharded, for comparing the two.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")


# ---------------------------------------------------------------------------
# Device facts and the result line
# ---------------------------------------------------------------------------


def require_gpu(backend: Optional[str] = None) -> None:
    """Raise unless JAX's default backend is a GPU: the measurements and
    checks here mean nothing on the CPU or in an interpreter."""
    if backend is None:
        import jax

        backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"needs a GPU, but JAX's default backend is {backend!r}"
        )


def smi_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    one line per card, as the tool prints it."""
    out = subprocess.run(
        list(SMI_QUERY), capture_output=True, text=True, timeout=60,
        check=True,
    ).stdout.strip()
    if not parse_smi(out):
        raise RuntimeError(f"unreadable nvidia-smi output: {out!r}")
    return out


def parse_smi(text: str) -> List[Tuple[str, float]]:
    """[(card name, power limit in W)] from `smi_line()` output."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        limit = limit.strip()
        if not sep or not limit.endswith("W"):
            raise ValueError(f"not a name,power.limit line: {line!r}")
        cards.append((name.strip(), float(limit[:-1])))
    return cards


# Dense bf16 tensor-core peak by `device_kind` (NVIDIA H100 SXM data sheet,
# without sparsity, at the 700 W power limit). A kind missing here is an
# error, never a default.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_bf16_flops(kind: str) -> float:
    if kind not in PEAK_BF16_FLOPS:
        raise KeyError(
            f"no bf16 peak known for device kind {kind!r}; add it to "
            "chip_checks.PEAK_BF16_FLOPS with its source"
        )
    return PEAK_BF16_FLOPS[kind]


def device_info() -> Dict[str, Any]:
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def result_line(device: Dict[str, Any]) -> str:
    """The one-object last line of `chip_smoke.py`."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": device["platform"],
            "kind": device["kind"],
            "count": int(device["count"]),
        },
    })


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Tolerance:
    rel: float  # bound on ||got - want|| / ||want|| (global L2)
    reason: str


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"shape {got.shape} vs {want.shape}")
    den = max(float(np.linalg.norm(want)), 1e-30)
    return float(np.linalg.norm(got - want)) / den


def check_close(name: str, got, want, tol: Tolerance) -> float:
    """Relative L2 error of `got` against `want`; raises AssertionError
    when it is not finite or exceeds `tol.rel`."""
    if not np.all(np.isfinite(np.asarray(got, np.float64))):
        raise AssertionError(f"{name}: non-finite values")
    err = rel_err(got, want)
    if not err <= tol.rel:
        raise AssertionError(
            f"{name}: relative error {err:.3e} > {tol.rel:g} ({tol.reason})"
        )
    return err


def tree_rel_err(got, want) -> float:
    """Global relative L2 error over every leaf of two like pytrees."""
    import jax

    num = den = 0.0
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        num += float(np.sum((g - w) ** 2))
        den += float(np.sum(w ** 2))
    return (num / max(den, 1e-60)) ** 0.5


# ---------------------------------------------------------------------------
# Decode: prefill + carried-state steps vs a float32 full forward
# ---------------------------------------------------------------------------


def spark_params(cfg, seed: int = 0, bf16_tables: bool = True):
    """Seeded random Spark weights with the zero-initialized matrices filled
    (fill_zero_init); tables of rank >= 2 cast to bf16 for decode."""
    import jax
    import jax.numpy as jnp

    from rwkvtts_tpu.models import spark

    params = spark.init_params(jax.random.PRNGKey(seed), cfg)
    params = fill_zero_init(params, jax.random.PRNGKey(seed + 100))
    if bf16_tables:
        params = jax.tree.map(
            lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, params
        )
    return params


def spark_prompts(batch: int, length: int, seed: int = 1):
    """(tokens, modality, mask) of `batch` random text prompts ending in
    the TTS tag."""
    import jax
    import jax.numpy as jnp

    from rwkvtts_tpu.models import spark

    tokens = jax.random.randint(
        jax.random.PRNGKey(seed), (batch, length), 0, 4000
    )
    modality = jnp.full((batch, length), spark.MOD_TEXT, jnp.int32)
    modality = modality.at[:, -1].set(spark.MOD_TAG)
    mask = jnp.ones((batch, length), jnp.int32)
    return tokens, modality, mask


_ZERO_INIT = re.compile(r"blocks/(att/(w1|a1|v1|g1|output)|ffn/value)$")


def fill_zero_init(params, key, gain: float = 0.5):
    """Seeded random values for the matrices RWKV-7 initializes to zero
    (the lora-in factors, the time-mix output and the FFN value). At init
    those zeros make every block an identity on the residual stream, so no
    check could see the recurrence; random weights must fill them."""
    import jax
    import jax.numpy as jnp

    leaves = jax.tree_util.tree_leaves_with_path(params)
    keys = iter(jax.random.split(key, len(leaves)))

    def one(path, x):
        k = next(keys)
        name = "/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in path)
        if not _ZERO_INIT.search(name):
            return x
        std = gain / np.sqrt(x.shape[-2])
        return (jax.random.normal(k, x.shape, jnp.float32) * std).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(one, params)


def reference_config(cfg):
    """The plain reference of a backbone config: float32 everywhere, the
    per-step scan recurrence, no remat."""
    import jax.numpy as jnp

    return dataclasses.replace(
        cfg, dtype=jnp.float32, wkv_impl="scan", wkv_spans=1, remat=False,
        decode_state_bf16=False, layer_unroll=False,
    )


def decode_parity(
    params,
    cfg,
    head,
    prompt_embeds,
    step_embeds,
    attention_mask=None,
    decode_params=None,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Last-position logits and final WKV state two ways, for one RWKV-7
    backbone.

    System: `rwkv7.forward` prefill over `prompt_embeds` (B, T, C), then one
    `rwkv7.decode_step` per row of `step_embeds` (K, B, C) through the
    carried state (`pack_decode_state`; bf16 when cfg.decode_state_bf16),
    with `decode_params` (default: `pack_decode_params(params)`), all in
    cfg.dtype. Reference: one float32 forward over the T + K positions at
    `precision="highest"`, with the same weight values upcast to float32.
    Returns {"logits": (system, reference) (B, V) float32, "wkv": (system,
    reference) (L, B, H, N, N) float32}; the state comparison sees the
    recurrence and the carry precision directly.
    """
    import jax
    import jax.numpy as jnp

    from rwkvtts_tpu.models import rwkv7

    if decode_params is None:
        decode_params = rwkv7.pack_decode_params(params, cfg)
    B = prompt_embeds.shape[0]
    if attention_mask is None:
        attention_mask = jnp.ones(prompt_embeds.shape[:2], jnp.int32)

    def system(params, dparams, head, x, steps, mask):
        h, st = rwkv7.forward(
            params, cfg, inputs_embeds=x.astype(cfg.dtype),
            attention_mask=mask, return_state=True,
        )
        st = rwkv7.pack_decode_state(st, cfg)
        dl = rwkv7.layer_decode_views(dparams, cfg)

        def body(carry, e):
            _, st = carry
            return rwkv7.decode_step(dl, cfg, e.astype(cfg.dtype), st), None

        (h_last, st), _ = jax.lax.scan(body, (h[:, -1], st), steps)
        wkv = rwkv7.unpack_decode_state(st, cfg)["wkv"].astype(jnp.float32)
        return (h_last @ head.astype(cfg.dtype)).astype(jnp.float32), wkv

    rcfg = reference_config(cfg)

    def reference(params, head, x, steps, mask):
        with jax.default_matmul_precision("highest"):
            full = jnp.concatenate([x, jnp.moveaxis(steps, 0, 1)], axis=1)
            m = jnp.concatenate(
                [mask, jnp.ones((B, steps.shape[0]), mask.dtype)], axis=1
            )
            h, st = rwkv7.forward(
                params, rcfg, inputs_embeds=full, attention_mask=m,
                return_state=True,
            )
            return h[:, -1] @ head, st["wkv"]

    f32 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), t)
    got = jax.jit(system)(
        params, decode_params, head, prompt_embeds, step_embeds, attention_mask
    )
    want = jax.jit(reference)(
        f32(params), f32(head), f32(prompt_embeds), f32(step_embeds),
        attention_mask,
    )
    return {
        k: (np.asarray(g, np.float32), np.asarray(w, np.float32))
        for k, g, w in zip(("logits", "wkv"), got, want)
    }


# ---------------------------------------------------------------------------
# Training: one step of the CLI's train step, on one device or a mesh
# ---------------------------------------------------------------------------


def spark_packed_batch(
    batch: int, seq_len: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    """A Spark training batch of packed documents (segment resets at each
    document start; semantic lengths drawn from [seq_len/16, seq_len/3)),
    built with the trainer's own collator from seeded synthetic rows."""
    from rwkvtts_tpu.data import spark_collator
    from rwkvtts_tpu.utils.tokenizer import get_world_tokenizer

    rng = np.random.default_rng(seed)
    tok = get_world_tokenizer()
    eos = 8192
    rows = []
    for _ in range(batch):
        docs, used = [], 0
        while True:
            n_sem = int(rng.integers(seq_len // 16, seq_len // 3))
            text = "".join(chr(int(c)) for c in rng.integers(97, 123, 24))
            # text + 32 globals + 3 tags + semantics + eos
            need = len(tok.encode(text)) + 32 + 3 + n_sem + 1
            if used + need > seq_len:
                break
            docs.append({
                "text": text,
                "global_tokens": rng.integers(0, 4096, 32).tolist(),
                "semantic_tokens": rng.integers(0, 8192, n_sem).tolist(),
            })
            used += need
        if not docs:
            raise ValueError(f"seq_len {seq_len} holds no document")
        rows.append(spark_collator.collate_plain(
            docs, tok, eos, pad_to=seq_len, packed=True
        ))
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


def train_step_once(cfg, params, batch, key, mesh=None):
    """One optimizer step as `train/cli.py` builds it (make_train_step +
    build_optimizer; warmup 0 so the first step moves the weights).
    Returns (loss, grad_norm, new params as host arrays)."""
    import jax

    from rwkvtts_tpu.parallel import mesh as mesh_lib
    from rwkvtts_tpu.parallel import train_step as ts
    from rwkvtts_tpu.train import optimizer as opt_lib

    def run():
        p = params
        b = {k: jax.numpy.asarray(v) for k, v in batch.items()}
        if mesh is not None:
            p = mesh_lib.shard_params(mesh, p)
            b = jax.device_put(b, mesh_lib.batch_sharding(mesh))
        tx = opt_lib.build_optimizer(p, warmup_steps=0, total_steps=100)
        state = ts.init_train_state(p, tx)
        # no donation: the caller's params feed several runs
        step = ts.make_train_step(cfg, tx, mesh=mesh, donate=False)
        state, m = step(state, b, key)
        return (
            float(m["loss"]), float(m["grad_norm"]),
            jax.tree.map(np.asarray, state.params),
        )

    if mesh is None:
        return run()
    with mesh:
        return run()


# ---------------------------------------------------------------------------
# Serving: the slot pool's first decode step, on one device or dp-sharded
# ---------------------------------------------------------------------------


def pool_first_step(
    params, cfg, prompts: Sequence[Dict[str, np.ndarray]], n_slots: int,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Admit `prompts` into a `ContinuousBatcher` (greedy, chunk 1) and run
    one step. Returns (logits of the step after it (n_slots, V) float32,
    the tokens it emitted (n_slots,))."""
    import jax.numpy as jnp

    from rwkvtts_tpu.serving.continuous import ContinuousBatcher

    cb = ContinuousBatcher(
        params, cfg, n_slots=n_slots, chunk=1, top_k=1, mesh=mesh,
        prompt_cap=max(p["tokens"].shape[1] for p in prompts),
    )
    for pb in prompts:
        cb.add_request(pb, max_new_tokens=8)
    cb._admit()
    cb._carry, toks, _ = cb._chunk()
    h = cb._carry[0]
    logits = (h @ cb.params["head"].astype(cfg.backbone.dtype)).astype(
        jnp.float32
    )
    return np.asarray(logits), np.asarray(toks)[:, 0]
