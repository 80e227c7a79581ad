"""Training-state checkpoints with rotation + resume, written with numpy.

Replaces DeepSpeed save_checkpoint/epoch_{e}_step_{s} rotation keeping the
newest 2 (reference train_..._properties.py:202-220) and the training_state
dict of the ASR script (train_rwkv7_asr_jsonl.py:197-241). Adds mid-epoch
data-position resume, which the reference lacks (SURVEY.md §5).

Layout: <root>/step_<n>/state.npz holds every leaf of the state pytree,
keyed by its path (`jax.tree_util.keystr`), plus `__dtypes__`, the leaves'
dtype names (bfloat16 has no numpy type of its own, so such leaves are
stored as their uint16 bit pattern); <root>/step_<n>/meta.json holds the
caller's metadata. Only numpy is needed to write or read it.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_DTYPES_KEY = "__dtypes__"


def _ckpt_dirs(root: str):
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and os.path.isdir(os.path.join(root, name)):
            try:
                out.append((int(name.split("_")[1]), os.path.join(root, name)))
            except ValueError:
                pass
    return sorted(out)


def _to_storable(x) -> Tuple[np.ndarray, str]:
    a = np.asarray(x)
    name = str(a.dtype)
    if a.dtype == jnp.bfloat16:
        a = a.view(np.uint16)
    return a, name


def save(
    root: str,
    step: int,
    state: Any,
    meta: Optional[Dict[str, Any]] = None,
    keep: int = 2,
) -> str:
    """Save a TrainState (params/opt_state/step pytree) + meta json."""
    path = os.path.abspath(os.path.join(root, f"step_{step}"))
    os.makedirs(root, exist_ok=True)
    if os.path.exists(path):
        shutil.rmtree(path)
    # write into a sibling directory and rename: a kill mid-write never
    # leaves a step_<n> that latest_step() would pick up half-written
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for p, leaf in jax.tree_util.tree_leaves_with_path(state):
        key = jax.tree_util.keystr(p)
        arrays[key], dtypes[key] = _to_storable(leaf)
    arrays[_DTYPES_KEY] = np.asarray(json.dumps(dtypes))
    with open(os.path.join(tmp, "state.npz"), "wb") as f:
        np.savez(f, **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta or {}, f)
    os.rename(tmp, path)
    for _, old in _ckpt_dirs(root)[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return path


def latest_step(root: str) -> Optional[int]:
    dirs = _ckpt_dirs(root)
    return dirs[-1][0] if dirs else None


def restore(root: str, abstract_state: Any, step: Optional[int] = None) -> Tuple[Any, Dict[str, Any]]:
    """Restore (state, meta). abstract_state: a pytree of like-shaped arrays
    (e.g. a freshly initialized TrainState); each restored leaf takes its
    shape, dtype and, for a jax.Array, its sharding."""
    if step is None:
        step = latest_step(root)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {root}")
    path = os.path.abspath(os.path.join(root, f"step_{step}"))
    with np.load(os.path.join(path, "state.npz")) as z:
        dtypes = json.loads(str(z[_DTYPES_KEY]))
        leaves, treedef = jax.tree_util.tree_flatten_with_path(abstract_state)
        out = []
        for p, like in leaves:
            key = jax.tree_util.keystr(p)
            if key not in z.files:
                raise KeyError(f"checkpoint {path} has no leaf {key}")
            a = z[key]
            if dtypes[key] == "bfloat16":
                a = a.view(jnp.bfloat16)
            if tuple(a.shape) != tuple(np.shape(like)):
                raise ValueError(
                    f"checkpoint leaf {key}: shape {a.shape}, "
                    f"expected {np.shape(like)}"
                )
            a = a.astype(like.dtype)
            sharding = getattr(like, "sharding", None)
            out.append(
                jax.device_put(a, sharding) if sharding is not None
                else jnp.asarray(a)
            )
    state = jax.tree_util.tree_unflatten(treedef, out)
    meta_path = os.path.join(path, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


def export_params_npz(path: str, params: Any) -> None:
    """Flat .npz export of params (host interchange / quick inspection)."""
    flat = jax.tree_util.tree_leaves_with_path(params)
    arrs = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
    np.savez(path, **arrs)
