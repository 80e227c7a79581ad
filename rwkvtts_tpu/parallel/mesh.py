"""Device mesh + sharding rules.

The reference scales with DeepSpeed ZeRO-2/3 over NCCL (SURVEY.md §2.7).
Replacement: a ("dp", "fsdp", "tp") mesh; GSPMD inserts all collectives,
which XLA hands to NCCL over NVLink (grad psum over dp/fsdp; tp shards the
matmuls). The cards of one host are joined all to all, so the mesh shape
follows the algorithm alone.

  dp    pure data parallel (batch axis)
  fsdp  param/optimizer sharding axis (ZeRO-equivalent); batch is also
        split over it, params are sharded along one matrix dimension
  tp    tensor parallel (column/row-parallel projections, sharded vocab)
  sp    sequence parallel (optional 4th axis, make_mesh(sp=...)): the TIME
        axis of every batch leaf shards over it; set
        cfg.wkv_spans = sp so the WKV recurrence composes per-span affine
        transfer operators across devices (ops/wkv7.wkv7_chunked_sp) —
        long-audio context parallelism the reference cannot express.
        Everything else (projections, FFN, norms, CE, token-shift halo)
        is per-position and GSPMD handles it from the batch sharding.

At reference model sizes (0.1–1.5 B) dp×fsdp covers training; tp exists for
serving-time latency scaling and larger models.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    dp: int = 1,
    fsdp: int = 1,
    tp: int = 1,
    sp: int = 1,
    devices: Optional[Sequence[Any]] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = dp * fsdp * tp * sp
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    if sp > 1:  # 4-axis mesh only when sequence parallelism is on
        arr = np.array(devices[:n]).reshape(dp, fsdp, tp, sp)
        return Mesh(arr, ("dp", "fsdp", "tp", "sp"))
    arr = np.array(devices[:n]).reshape(dp, fsdp, tp)
    return Mesh(arr, ("dp", "fsdp", "tp"))


# Param-path → PartitionSpec rules. Paths are "/"-joined pytree keys; block
# leaves carry a leading stacked-layer axis (replicated). First match wins.
_RULES: Tuple[Tuple[str, P], ...] = (
    # block matrices (L, in, out) — column-parallel on tp, fsdp on input dim
    (r"blocks/att/(receptance|key|value)$", P(None, "fsdp", "tp")),
    (r"blocks/att/output$", P(None, "tp", "fsdp")),
    (r"blocks/ffn/key$", P(None, "fsdp", "tp")),
    (r"blocks/ffn/value$", P(None, "tp", "fsdp")),
    # LoRA factors: small; shard the wide side on tp only
    (r"blocks/att/(w1|a1|v1|g1)$", P(None, None, "tp")),
    (r"blocks/att/(w2|a2|v2|g2)$", P(None, "tp", None)),
    # embeddings / heads: vocab dim on (fsdp, tp)
    (r"(embedding|text_embedder|global_embedder)$", P(("fsdp", "tp"), None)),
    (r"head$", P(None, ("fsdp", "tp"))),
    (r"heads/.*$", P(None, ("fsdp", "tp"))),
    (r"embeddings/.*$", P(("fsdp", "tp"), None)),
    # everything else (vectors, norms, tags) replicated
    (r".*", P()),
)


def spec_for_path(path: str) -> P:
    for pat, spec in _RULES:
        if re.search(pat, path):
            return spec
    return P()


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def _fit_spec(spec: P, shape, axis_sizes: Dict[str, int]) -> P:
    """Drop sharding on dimensions the mesh doesn't divide evenly (e.g. the
    odd 8193 Spark vocab) — those leaves fall back to replication on that
    axis rather than failing."""
    fitted = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            fitted.append(entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= axis_sizes.get(a, 1)
        fitted.append(entry if shape[i] % size == 0 else None)
    return P(*fitted)


def param_specs(params, axis_sizes: Optional[Dict[str, int]] = None) -> Any:
    """Pytree of PartitionSpecs matching `params`."""

    def one(path, leaf):
        spec = spec_for_path(_path_str(path))
        if axis_sizes is not None and hasattr(leaf, "shape"):
            spec = _fit_spec(spec, leaf.shape, axis_sizes)
        return spec

    return jax.tree_util.tree_map_with_path(one, params)


def param_shardings(mesh: Mesh, params) -> Any:
    axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return jax.tree.map(
        lambda spec: NamedSharding(mesh, spec),
        param_specs(params, axis_sizes),
    )


def shard_params(mesh: Mesh, params):
    return jax.device_put(params, param_shardings(mesh, params))


def batch_spec(sp: bool = False) -> P:
    """Batches shard over (dp, fsdp) on the leading axis; on an sp mesh
    the time axis additionally shards over 'sp'."""
    return P(("dp", "fsdp"), "sp") if sp else P(("dp", "fsdp"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, batch_spec(sp="sp" in mesh.axis_names))
