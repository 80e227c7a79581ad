"""Flatten/unflatten param pytrees for committed golden fixtures (npz).

Golden fixtures (tests/goldens/*.npz) carry torch-derived weights, inputs,
and reference outputs captured once by scripts/capture_goldens_torch.py so
CI can replay reference-pipeline parity with NO torch import at test time.

A tree is any nesting of dict / list / tuple with array leaves. Paths join
keys with '/'; list indices are decimal strings. On load, a dict whose keys
are all decimal strings is rebuilt as a list — the only ambiguity would be
a dict keyed by decimal strings, which no param tree here uses.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
        return out
    for k, v in items:
        assert "/" not in str(k), f"key {k!r} contains the path separator"
        out.update(flatten_tree(v, f"{prefix}{k}/"))
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def _listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: _listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return _listify(root)


def save_fixture(path: str, *, params: Any = None, **arrays: Any) -> None:
    """npz with `params/<path>` entries for the tree + named io arrays."""
    flat: Dict[str, np.ndarray] = {}
    if params is not None:
        flat.update(flatten_tree(params, "params/"))
    for k, v in arrays.items():
        flat[f"io/{k}"] = np.asarray(v)
    np.savez_compressed(path, **flat)


def load_fixture(path: str):
    """Returns (params_tree_or_None, {io_name: array})."""
    z = np.load(path)
    pf = {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")}
    io = {k[len("io/"):]: z[k] for k in z.files if k.startswith("io/")}
    return (unflatten_tree(pf) if pf else None), io


# ---------------------------------------------------------------------------
# Synthetic torch-layout state dicts (golden fixtures without stored weights)


def synth_state_dict(shapes: Dict[str, tuple], seed: int) -> Dict[str, np.ndarray]:
    """Deterministic synthetic state dict in torch key layout.

    The golden-fixture protocol stores only the state-dict SHAPE TABLE and a
    seed: the capture script loads these values into the reference torch
    module, and the replay test feeds the identical values to our importer —
    so fixtures stay a few KB (no random-weight megabytes to commit).

    Values are chosen to keep deep stacks numerically sane: norm scales and
    weight-norm magnitudes (1-D `.weight`, `weight_g`, snake `alpha`) sit
    near 1; BatchNorm running_var stays positive; everything else is small
    gaussian. Iteration is over sorted(keys) with one generator, so both
    sides produce identical bytes for the same (shapes, seed).
    """
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for k in sorted(shapes):
        shp = tuple(int(x) for x in shapes[k])
        if k.endswith("num_batches_tracked"):
            out[k] = np.zeros(shp, np.int64)
        elif k.endswith("running_var"):
            out[k] = np.clip(
                1.0 + 0.1 * rng.standard_normal(shp), 0.5, None
            ).astype(np.float32)
        elif k.endswith("running_mean"):
            out[k] = (0.1 * rng.standard_normal(shp)).astype(np.float32)
        elif (
            k.endswith("weight_g")
            or k.endswith("alpha")
            or (k.endswith(".weight") and len(shp) == 1)
        ):
            out[k] = (1.0 + 0.1 * rng.standard_normal(shp)).astype(np.float32)
        else:
            out[k] = (0.1 * rng.standard_normal(shp)).astype(np.float32)
    return out


def save_golden(path: str, shapes: Dict[str, tuple], seed: int, **io) -> None:
    """Golden fixture: state-dict shape table + synth seed + io arrays."""
    flat: Dict[str, np.ndarray] = {
        f"shape/{k}": np.asarray(v, np.int64) for k, v in shapes.items()
    }
    flat["meta/seed"] = np.asarray(seed, np.int64)
    for k, v in io.items():
        flat[f"io/{k}"] = np.asarray(v)
    np.savez_compressed(path, **flat)


def load_golden(path: str):
    """Returns (synth_state_dict, {io_name: array}) for a golden fixture."""
    z = np.load(path)
    shapes = {
        k[len("shape/"):]: tuple(z[k].tolist())
        for k in z.files
        if k.startswith("shape/")
    }
    seed = int(z["meta/seed"])
    io = {k[len("io/"):]: z[k] for k in z.files if k.startswith("io/")}
    return synth_state_dict(shapes, seed), io
