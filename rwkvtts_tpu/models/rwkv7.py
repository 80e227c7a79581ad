"""RWKV-7 core model.

Functional (config → params pytree → pure apply), with all layers stored
stacked along a leading axis so the depth dimension runs as a single
`lax.scan` — one compiled block body regardless of depth, scan-carried
`v_first`, and clean GSPMD sharding of every parameter leaf.

Math parity sources (reference, /root/reference):
  * time-mix parameterization + init:  model/llm/rwkv_asr_cuda_whisper.py:84-172
  * time-mix forward:                  model/llm/rwkv_asr_cuda_whisper.py:217-250
  * channel-mix:                       model/llm/rwkv_asr_cuda_whisper.py:252-294
  * block assembly / ln0:              model/llm/rwkv_asr_cuda_whisper.py:296-336
  * decode-step math:                  model/llm/rwkv_s2s_single_ffn.py:482-556

Differences by design (not a line-by-line translation):
  * ln0 (the layer-0 pre-norm) is folded into the embedding path, so every
    block is identical and scannable (the reference's own eval runtime does
    the same fold, rwkv_s2s_single_ffn.py:395).
  * Layer 0 carries (ignored) v0/v1/v2 so the stacked pytree is uniform;
    selection happens with `jnp.where(layer_idx == 0, ...)` inside the scan.
  * The WKV recurrence runs through ops/wkv7.py (chunked matmul form that
    XLA compiles) instead of a per-step CUDA kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.ops import wkv7 as wkv7_ops
from rwkvtts_tpu.ops.norm import group_norm, l2_normalize, layer_norm

Params = Dict[str, Any]


def _round32(x: float) -> int:
    return max(32, int(round(x / 32)) * 32)


@dataclasses.dataclass(frozen=True)
class RWKV7Config:
    vocab_size: int
    hidden_size: int
    num_layers: int
    head_size: int = 64
    gate_lora: int = 128
    norm_eps: float = 1e-5
    # GroupNorm eps = 1e-5 * head_size_divisor**2 with divisor 8
    ln_x_eps: float = 64e-5
    dtype: Any = jnp.bfloat16
    # 'chunked' (matmul form, training/prefill) or 'scan' (per-step
    # reference); ops/wkv7.resolve_impl validates it
    wkv_impl: str = "chunked"
    wkv_chunk: int = 32
    remat: bool = True
    # Selective rematerialization: None = full replay (lowest memory);
    # 'dots' = save matmul outputs, recompute elementwise
    remat_policy: Optional[str] = None
    # Decode: carry the WKV state bf16 between steps (math stays fp32
    # inside the step; the state is cast at the carry boundary). Halves
    # the state's share of the decode step's memory traffic — the
    # reference's own batched decode kernel carries fp16 state
    # (rwkv7_state_fwd_fp16.cu). Opt-in: quality-affecting in principle
    # (memorized-decode reproduction is CI-tested).
    decode_state_bf16: bool = False
    # Python-unrolled layer loop for the full-sequence forward (instead of
    # lax.scan over stacked layers): per-layer buffers, no stacked
    # save/slice copies. Compile time grows with depth.
    layer_unroll: bool = False
    # Two-level hierarchical WKV chunking (ops/wkv7.wkv7_chunked_sp):
    # spans run in parallel (the serial chunk scan shrinks by this factor)
    # and compose via exact per-span affine transfer operators. >1 forces
    # the XLA path. Doubles as the SEQUENCE-PARALLEL unit: shard T over a
    # mesh 'sp' axis in wkv_spans pieces (parallel/mesh.make_mesh(sp=...))
    # and only the tiny (B,H,N,N) compose scan crosses devices — context
    # parallelism for long-audio training, which the reference's
    # single-GPU-per-sequence CUDA kernel cannot express.
    wkv_spans: int = 1
    # When True the lm head is present in params (core-only submodels skip it)
    with_head: bool = True
    with_embedding: bool = True

    @property
    def num_heads(self) -> int:
        assert self.hidden_size % self.head_size == 0
        return self.hidden_size // self.head_size

    @property
    def decay_lora(self) -> int:
        return _round32(1.8 * math.sqrt(self.hidden_size))

    @property
    def a_lora(self) -> int:
        return _round32(1.8 * math.sqrt(self.hidden_size))

    @property
    def v_lora(self) -> int:
        return _round32(1.3 * math.sqrt(self.hidden_size))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _orthogonal(key, shape, gain):
    return jax.nn.initializers.orthogonal(scale=gain)(key, shape, jnp.float32)


def _ortho_gain(rows, cols):
    return math.sqrt(rows / cols) if rows > cols else 1.0


def init_block_params(key, cfg: RWKV7Config, layer_id: int) -> Params:
    """Init one block, reference formulas (rwkv_asr_cuda_whisper.py:97-179)."""
    C = cfg.hidden_size
    H = cfg.num_heads
    N = cfg.head_size
    L = cfg.num_layers
    r01 = layer_id / max(L - 1, 1)
    r10 = 1.0 - layer_id / L

    ddd = jnp.arange(C, dtype=jnp.float32) / C
    n = jnp.arange(C, dtype=jnp.float32)
    linear = n / (C - 1) - 0.5
    zig = ((n % N) - (N - 1) / 2) / ((N - 1) / 2)
    zigzag = zig * jnp.abs(zig)
    www = -6.0 + 6.0 * (n / (C - 1)) ** (1.0 + 1.0 * r01**0.3)

    keys = iter(jax.random.split(key, 16))
    Dw, Da, Dv, Dg = cfg.decay_lora, cfg.a_lora, cfg.v_lora, cfg.gate_lora

    def uniform(k, shape, scale):
        return jax.random.uniform(k, shape, jnp.float32, -scale, scale)

    s = 1.0 / math.sqrt(C)
    att = {
        "x_r": 1.0 - ddd ** (0.2 * r10),
        "x_w": 1.0 - ddd ** (0.9 * r10),
        "x_k": 1.0 - ddd ** (0.7 * r10),
        "x_v": 1.0 - ddd ** (0.7 * r10),
        "x_a": 1.0 - ddd ** (0.9 * r10),
        "x_g": 1.0 - ddd ** (0.2 * r10),
        "w0": www + 0.5 + zigzag * 2.5,
        "w1": jnp.zeros((C, Dw), jnp.float32),
        "w2": _orthogonal(next(keys), (Dw, C), 0.1 * _ortho_gain(Dw, C)),
        "a0": jnp.zeros((C,)) - 0.19 + zigzag * 0.3 + linear * 0.4,
        "a1": jnp.zeros((C, Da), jnp.float32),
        "a2": _orthogonal(next(keys), (Da, C), 0.1 * _ortho_gain(Da, C)),
        # v-lora exists on every layer for pytree uniformity; ignored on 0.
        "v0": jnp.zeros((C,)) + 0.73 - linear * 0.4,
        "v1": jnp.zeros((C, Dv), jnp.float32),
        "v2": _orthogonal(next(keys), (Dv, C), 0.1 * _ortho_gain(Dv, C)),
        "g1": jnp.zeros((C, Dg), jnp.float32),
        "g2": _orthogonal(next(keys), (Dg, C), 0.1 * _ortho_gain(Dg, C)),
        "k_k": jnp.zeros((C,)) + 0.71 - linear * 0.1,
        "k_a": jnp.zeros((C,)) + 1.02,
        "r_k": jnp.zeros((H, N)) - 0.04,
        "receptance": uniform(next(keys), (C, C), 0.5 * s),
        "key": uniform(next(keys), (C, C), 0.05 * s),
        "value": uniform(next(keys), (C, C), 0.5 * s),
        "output": jnp.zeros((C, C), jnp.float32),
        "ln_x_scale": jnp.ones((C,), jnp.float32),
        "ln_x_bias": jnp.zeros((C,), jnp.float32),
    }
    ffn = {
        "x_k": 1.0 - ddd ** (r10**4),
        "key": uniform(next(keys), (C, 4 * C), 0.5 * s),
        "value": jnp.zeros((4 * C, C), jnp.float32),
    }
    return {
        "ln1_scale": jnp.ones((C,)),
        "ln1_bias": jnp.zeros((C,)),
        "ln2_scale": jnp.ones((C,)),
        "ln2_bias": jnp.zeros((C,)),
        "att": att,
        "ffn": ffn,
    }


def init_params(key, cfg: RWKV7Config) -> Params:
    C = cfg.hidden_size
    keys = jax.random.split(key, cfg.num_layers + 2)
    blocks = [init_block_params(keys[i], cfg, i) for i in range(cfg.num_layers)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *blocks)
    params: Params = {
        "blocks": stacked,
        "ln0_scale": jnp.ones((C,)),
        "ln0_bias": jnp.zeros((C,)),
        "ln_out_scale": jnp.ones((C,)),
        "ln_out_bias": jnp.zeros((C,)),
    }
    if cfg.with_embedding:
        params["embedding"] = jax.random.uniform(
            keys[-2], (cfg.vocab_size, C), jnp.float32, -1e-4, 1e-4
        )
    if cfg.with_head:
        scale = 0.5 * math.sqrt(cfg.vocab_size / C) if cfg.vocab_size > C else 0.5
        params["head"] = _orthogonal(keys[-1], (C, cfg.vocab_size), scale)
    return params


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def init_model_state(cfg: RWKV7Config, batch: int, dtype=None) -> Params:
    """Per-layer decode state: token-shift prevs + WKV state.

    Layout mirrors the reference decode state (rwkv_asr_cuda_whisper.py:443-447):
    att x_prev (L,B,C), wkv (L,B,H,N,N) fp32, ffn x_prev (L,B,C).
    """
    L, B, C = cfg.num_layers, batch, cfg.hidden_size
    H, N = cfg.num_heads, cfg.head_size
    dt = dtype or cfg.dtype
    return {
        "att_x": jnp.zeros((L, B, C), dt),
        "wkv": jnp.zeros((L, B, H, N, N), jnp.float32),
        "ffn_x": jnp.zeros((L, B, C), dt),
    }


# ---------------------------------------------------------------------------
# Block forward (full sequence)
# ---------------------------------------------------------------------------


def _lora(x, w1, w2, act=None):
    h = x @ w1
    if act is not None:
        h = act(h)
    return h @ w2


def _time_shift(x, x_prev):
    """(B,T,C): prepend x_prev (or zeros) and drop the last position."""
    if x_prev is None:
        x_prev = jnp.zeros_like(x[:, :1])
    else:
        x_prev = x_prev[:, None]
    return jnp.concatenate([x_prev, x[:, :-1]], axis=1)


def block_forward(
    bp: Params,
    cfg: RWKV7Config,
    x: jax.Array,
    mask: Optional[jax.Array],
    resets: Optional[jax.Array],
    layer_idx: jax.Array,
    v_first: jax.Array,
    st: Optional[Params] = None,
    collect_states: bool = False,
):
    """One block over a full (B, T, C) sequence.

    st, when given, is this layer's slice of the model state:
    {'att_x': (B,C), 'wkv': (B,H,N,N), 'ffn_x': (B,C)}; the updated slice is
    returned (for prefill-then-decode).

    collect_states=True (speculative-decode verification,
    infer/spec_decode.py) returns the state AFTER EVERY position instead of
    only the last: new_st keys gain a T axis ('att_x'/'ffn_x' (B,T,C),
    'wkv' (B,T,H,N,N)); position j's slice is a valid decode state for
    resuming after token j. Uses the exact per-step scan WKV (fp32 state,
    same math as wkv7_step) — inference-only, T is small (the draft window).
    """
    B, T, C = x.shape
    H, N = cfg.num_heads, cfg.head_size
    att = bp["att"]
    dt = cfg.dtype
    cast = lambda p: p.astype(dt)

    def masked(h):
        return h if mask is None else h * mask[..., None].astype(h.dtype)

    # --- time mix ---
    xn = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.norm_eps)
    xn = masked(xn)
    xx = _time_shift(xn, None if st is None else st["att_x"]) - xn
    if resets is not None:
        # a reset position starts a fresh segment: its token-shift prev is 0
        xx = jnp.where(resets[..., None], -xn, xx)
    xr = xn + xx * cast(att["x_r"])
    xw = xn + xx * cast(att["x_w"])
    xk = xn + xx * cast(att["x_k"])
    xv = xn + xx * cast(att["x_v"])
    xa = xn + xx * cast(att["x_a"])
    xg = xn + xx * cast(att["x_g"])

    r = xr @ cast(att["receptance"])
    w_raw = -jax.nn.softplus(
        -(
            cast(att["w0"])
            + _lora(xw, cast(att["w1"]), cast(att["w2"]), jnp.tanh)
        )
    ) - 0.5
    k = xk @ cast(att["key"])
    v = xv @ cast(att["value"])

    v_resid = v + (v_first - v) * jax.nn.sigmoid(
        cast(att["v0"]) + _lora(xv, cast(att["v1"]), cast(att["v2"]))
    )
    is_first = layer_idx == 0
    v = jnp.where(is_first, v, v_resid)
    v_first = jnp.where(is_first, v, v_first)

    a = jax.nn.sigmoid(cast(att["a0"]) + _lora(xa, cast(att["a1"]), cast(att["a2"])))
    g = _lora(xg, cast(att["g1"]), cast(att["g2"]), jax.nn.sigmoid)

    v = masked(v)
    shp = lambda u: u.reshape(B, T, H, N)
    if collect_states:
        kk = l2_normalize(
            (k * cast(att["k_k"])).reshape(B, T, H, N)
        ).reshape(B, T, C)
        k = k * (1 + (a - 1) * cast(att["k_a"]))
        y, all_wkv = wkv7_ops.wkv7_scan(
            shp(r), shp(w_raw), shp(k), shp(v), shp(-kk), shp(kk * a),
            state=None if st is None else st["wkv"],
            resets=resets,
            return_states=True,
        )
        y = y.reshape(B, T, C)
        y = group_norm(
            y, att["ln_x_scale"], att["ln_x_bias"], H, cfg.ln_x_eps
        )
        bonus = (
            (r.reshape(B, T, H, N) * k.reshape(B, T, H, N) * cast(att["r_k"]))
            .sum(-1, keepdims=True)
            * v.reshape(B, T, H, N)
        ).reshape(B, T, C)
        y = y + bonus
        att_out = (y * g) @ cast(att["output"])
        x = x + att_out
        ffn = bp["ffn"]
        xn2 = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], cfg.norm_eps)
        xn2 = masked(xn2)
        xx2 = _time_shift(xn2, None if st is None else st["ffn_x"]) - xn2
        if resets is not None:
            xx2 = jnp.where(resets[..., None], -xn2, xx2)
        kf = xn2 + xx2 * cast(ffn["x_k"])
        kf = jnp.square(jax.nn.relu(kf @ cast(ffn["key"])))
        x = x + kf @ cast(ffn["value"])
        new_st = {"att_x": xn, "wkv": all_wkv, "ffn_x": xn2}
        return x, v_first, new_st
    else:
        kk = l2_normalize(
            (k * cast(att["k_k"])).reshape(B, T, H, N)
        ).reshape(B, T, C)
        k = k * (1 + (a - 1) * cast(att["k_a"]))
        y, wkv_state = wkv7_ops.wkv7(
            shp(r), shp(w_raw), shp(k), shp(v), shp(-kk), shp(kk * a),
            state=None if st is None else st["wkv"],
            resets=resets,
            impl=cfg.wkv_impl,
            chunk=cfg.wkv_chunk,
            spans=cfg.wkv_spans,
        )
        y = y.reshape(B, T, C)
        y = group_norm(
            y, att["ln_x_scale"], att["ln_x_bias"], H, cfg.ln_x_eps
        )
        bonus = (
            (r.reshape(B, T, H, N) * k.reshape(B, T, H, N) * cast(att["r_k"]))
            .sum(-1, keepdims=True)
            * v.reshape(B, T, H, N)
        ).reshape(B, T, C)
        y = y + bonus
    att_out = (y * g) @ cast(att["output"])
    x = x + att_out

    # --- channel mix ---
    ffn = bp["ffn"]
    xn2 = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], cfg.norm_eps)
    xn2 = masked(xn2)
    xx2 = _time_shift(xn2, None if st is None else st["ffn_x"]) - xn2
    if resets is not None:
        xx2 = jnp.where(resets[..., None], -xn2, xx2)
    kf = xn2 + xx2 * cast(ffn["x_k"])
    kf = jnp.square(jax.nn.relu(kf @ cast(ffn["key"])))
    x = x + kf @ cast(ffn["value"])

    new_st = {
        "att_x": xn[:, -1, :],
        "wkv": wkv_state,
        "ffn_x": xn2[:, -1, :],
    }
    return x, v_first, new_st


# ---------------------------------------------------------------------------
# Model forward
# ---------------------------------------------------------------------------


def embed(params: Params, cfg: RWKV7Config, input_ids: jax.Array) -> jax.Array:
    return params["embedding"][input_ids].astype(cfg.dtype)


def forward(
    params: Params,
    cfg: RWKV7Config,
    input_ids: Optional[jax.Array] = None,
    inputs_embeds: Optional[jax.Array] = None,
    attention_mask: Optional[jax.Array] = None,
    resets: Optional[jax.Array] = None,
    state: Optional[Params] = None,
    return_state: bool = False,
    collect_states: bool = False,
):
    """Full-sequence forward. Returns hidden (B,T,C) [+ state].

    Layers run as a lax.scan over the stacked block params; the block body is
    rematerialized when cfg.remat (gradient checkpointing,
    reference train_..._properties.py:405-406 equivalent).

    collect_states=True implies return_state and returns per-POSITION states:
    every leaf of the returned state gains a T axis after the batch axis
    (e.g. wkv (L,B,T,H,N,N)) — slice position j across the tree to resume
    decoding after token j (speculative-decode verify, infer/spec_decode.py).
    """
    if inputs_embeds is None:
        inputs_embeds = embed(params, cfg, input_ids)
    x = inputs_embeds.astype(cfg.dtype)
    x = layer_norm(x, params["ln0_scale"], params["ln0_bias"], cfg.norm_eps)

    L = cfg.num_layers
    layer_ids = jnp.arange(L)

    def body(carry, xs):
        x, v_first = carry
        bp, lid, st = xs
        x, v_first, new_st = block_forward(
            bp, cfg, x, attention_mask, resets, lid, v_first, st,
            collect_states=collect_states,
        )
        return (x, v_first), new_st

    if cfg.remat:
        policy = {
            None: None,
            "dots": jax.checkpoint_policies.checkpoint_dots,
            "dots_no_batch": jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims,
        }[cfg.remat_policy]
        fn = jax.checkpoint(body, policy=policy) if policy else jax.checkpoint(body)
    else:
        fn = body
    v0 = jnp.zeros_like(x)
    if state is None:
        B = x.shape[0]
        state = init_model_state(cfg, B)
    if cfg.layer_unroll:
        carry = (x, v0)
        sts = []
        for l in range(L):
            bp = jax.tree.map(lambda a: a[l], params["blocks"])
            st_l = jax.tree.map(lambda a: a[l], state)
            carry, new_st = fn(carry, (bp, jnp.int32(l), st_l))
            sts.append(new_st)
        x, _ = carry
        new_state = jax.tree.map(lambda *xs: jnp.stack(xs), *sts)
    else:
        (x, _), new_state = jax.lax.scan(
            fn, (x, v0), (params["blocks"], layer_ids, state)
        )
    x = layer_norm(x, params["ln_out_scale"], params["ln_out_bias"], cfg.norm_eps)
    if return_state or collect_states:
        return x, new_state
    return x


def logits(params: Params, cfg: RWKV7Config, hidden: jax.Array) -> jax.Array:
    return hidden @ params["head"].astype(cfg.dtype)


# ---------------------------------------------------------------------------
# Decode step (T == 1, state-carrying)
# ---------------------------------------------------------------------------


def _quantize_int8(w: jax.Array) -> Dict[str, jax.Array]:
    """Per-output-channel symmetric int8. w: (..., in, out)."""
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=-2, keepdims=True)
    scale = jnp.maximum(amax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(wf / scale), -127, 127).astype(jnp.int8)
    return {"q": q, "s": scale.astype(jnp.bfloat16)}


def _quantize_int4(w: jax.Array, group: int = 64) -> Dict[str, jax.Array]:
    """Group-wise symmetric int4 along the INPUT dim, two nibbles packed
    per int8 byte (first half of the input dim in the low nibble, second
    half in the high nibble). w: (..., in, out) with in % (2*group) == 0.

    Per-GROUP scales (not per-channel): 4-bit symmetric per-channel is too
    coarse for LM weights; a 64-row group bounds each scale's dynamic
    range. Weight bytes = in*out/2 + bf16 scales (in/group)*out."""
    wf = w.astype(jnp.float32)
    I = wf.shape[-2]
    # adapt the group to small/odd input dims (finer groups only raise
    # quality; the deployed configs use the requested 64)
    while group > 1 and I % (2 * group) != 0:
        group //= 2
    assert I % (2 * group) == 0, (I, group)
    g = wf.reshape(*wf.shape[:-2], I // group, group, wf.shape[-1])
    amax = jnp.max(jnp.abs(g), axis=-2, keepdims=True)
    scale = jnp.maximum(amax, 1e-8) / 7.0
    q = jnp.clip(jnp.round(g / scale), -7, 7).astype(jnp.int8)
    q = q.reshape(wf.shape)
    lo, hi = q[..., : I // 2, :], q[..., I // 2:, :]
    packed = ((lo & 0x0F) | (hi << 4)).astype(jnp.int8)
    return {
        "q4": packed,
        "s": scale.squeeze(-2).astype(jnp.bfloat16),  # (..., I/group, out)
    }


def _deq_int4(p: Dict[str, jax.Array], dt):
    packed = p["q4"]
    lo = jnp.right_shift(jnp.left_shift(packed, 4), 4)  # sign-extend nibble
    hi = jnp.right_shift(packed, 4)
    q = jnp.concatenate([lo, hi], axis=-2)
    I = q.shape[-2]
    scale = p["s"]
    n_groups = scale.shape[-2]
    g = q.reshape(*q.shape[:-2], n_groups, I // n_groups, q.shape[-1])
    w = g.astype(jnp.float32) * scale[..., :, None, :].astype(jnp.float32)
    return w.reshape(q.shape).astype(dt)


def _qmat(att: Params, name: str, dt):
    """Effective weight for `name`: int8/int4 storage is dequantized on the
    fly (XLA fuses the convert into the dot's operand load, so HBM traffic
    is the quantized bytes)."""
    q4 = f"{name}_q4"
    if q4 in att:
        return _deq_int4(att[q4], dt)
    qk = f"{name}_q8"
    if qk in att:
        p = att[qk]
        return p["q"].astype(dt) * p["s"].astype(dt)
    return att[name].astype(dt)


_STATE_KEYS = ("att_x", "wkv", "ffn_x")


def pack_decode_state(state: Params, cfg: RWKV7Config):
    """Convert the stacked decode state (leaves (L, ...)) into a tuple of
    per-layer dicts for the python-unrolled decode loop.

    Why: with stacked state, the unrolled layer scan stacks each layer's
    new state back into the (L,...) buffer with a dynamic-update-slice
    copy every step. With one leaf per layer the loop carries each state
    buffer independently and XLA updates it in place.

    With cfg.decode_state_bf16 each layer's wkv leaf is carried bf16
    (wkv7_step steps it in fp32 and casts back)."""

    def _cast(st_l):
        if cfg.decode_state_bf16 and st_l["wkv"].dtype != jnp.bfloat16:
            return {**st_l, "wkv": st_l["wkv"].astype(jnp.bfloat16)}
        return st_l

    if isinstance(state, tuple):
        if not cfg.decode_state_bf16 or all(
            st_l["wkv"].dtype == jnp.bfloat16 for st_l in state
        ):
            return state
        return tuple(_cast(st_l) for st_l in state)
    L = state["att_x"].shape[0]
    return tuple(_cast({k: state[k][l] for k in _STATE_KEYS}) for l in range(L))


def unpack_decode_state(state, cfg: RWKV7Config) -> Params:
    """Inverse of pack_decode_state: tuple-of-layers -> stacked dict (the
    wkv leaf keeps its carry dtype)."""
    if isinstance(state, tuple):
        return {
            k: jnp.stack([st[k] for st in state]) for k in _STATE_KEYS
        }
    return state


def layer_decode_views(params: Params, cfg: RWKV7Config) -> Params:
    """Pre-slice stacked block params into per-layer views, OUTSIDE the
    autoregressive scan (so the slicing is not re-emitted per step)."""
    if isinstance(params.get("blocks"), tuple):
        return params
    blocks = params["blocks"]
    return {
        **params,
        "blocks": tuple(
            jax.tree.map(lambda a: a[l], blocks) for l in range(cfg.num_layers)
        ),
    }


def pack_decode_params(
    params: Params, cfg: RWKV7Config, quantize_int8: bool = False,
    quantize_int4: bool = False, int4_group: int = 64,
    fuse_projections: bool = True,
) -> Params:
    """Precompute fused decode projections (done once, host/amortized).

    Each block's seven input projections consume (xn + xx * x_s) @ W_s for
    per-projection token-shift deltas x_s. Since
        (xn + xx*x_s) @ W = xn @ W + xx @ (diag(x_s) W),
    all of r/k/v and the four lora-in matmuls collapse into TWO matmuls
    against concatenated weights — the decode step is dispatch/latency
    bound at small batch, so fewer, larger matmuls win.
    Returns params + blocks.att.{fused_a, fused_b} of shape
    (L, C, 3C+Dw+Da+Dv+Dg), both stored in cfg.dtype.

    fuse_projections=False trades the other way: the fused pair stores the
    projection weights TWICE (fused_b = diag(x_s)·W), so where decode is
    weight-bandwidth-bound rather than dispatch-bound — B=1 streaming at
    1.5B (the reference's own B=1 latency path, cosy_llm.py:238-272) — the
    unfused seven-matmul step reads ~35% fewer HBM bytes. With
    quantize_int8 the seven projections quantize individually (same
    per-output-channel scheme); int4 stays fused-only.
    """
    if quantize_int8 and quantize_int4:
        raise ValueError("quantize_int8 and quantize_int4 are exclusive")
    if quantize_int4 and not fuse_projections:
        raise ValueError("quantize_int4 requires fused projections")
    att = params["blocks"]["att"]
    dt = cfg.dtype

    if not fuse_projections:
        if not quantize_int8:
            return params  # decode_step's unfused branch reads the originals
        out = dict(params)
        out["blocks"] = dict(params["blocks"])
        new_att = dict(att)
        for name in ("receptance", "key", "value", "output"):
            new_att[f"{name}_q8"] = _quantize_int8(att[name])
        new_ffn = dict(params["blocks"]["ffn"])
        new_ffn["key_q8"] = _quantize_int8(params["blocks"]["ffn"]["key"])
        new_ffn["value_q8"] = _quantize_int8(params["blocks"]["ffn"]["value"])
        out["blocks"]["att"] = new_att
        out["blocks"]["ffn"] = new_ffn
        return out

    def scale(xs, w):  # (L,C) deltas, (L,C,D) weights
        return xs[:, :, None] * w

    ws = [
        ("x_r", "receptance"),
        ("x_k", "key"),
        ("x_v", "value"),
        ("x_w", "w1"),
        ("x_a", "a1"),
        ("x_v", "v1"),
        ("x_g", "g1"),
    ]
    fused_a = jnp.concatenate([att[w] for _, w in ws], axis=-1).astype(dt)
    fused_b = jnp.concatenate(
        [scale(att[x], att[w]) for x, w in ws], axis=-1
    ).astype(dt)
    out = dict(params)
    out["blocks"] = dict(params["blocks"])
    new_att = dict(att)
    new_ffn = dict(params["blocks"]["ffn"])
    if quantize_int4:
        # int4 group-wise storage (two nibbles per byte, per-64-row-group
        # scales): ~4x fewer weight bytes than bf16 where decode is
        # weight-bandwidth-bound (B=1 Cosy, 1.4B batch decode). Coarser
        # than int8 — opt-in and quality-measured separately.
        new_att["fused_a_q4"] = _quantize_int4(fused_a, int4_group)
        new_att["fused_b_q4"] = _quantize_int4(fused_b, int4_group)
        new_att["output_q4"] = _quantize_int4(att["output"], int4_group)
        new_ffn["key_q4"] = _quantize_int4(
            params["blocks"]["ffn"]["key"], int4_group
        )
        new_ffn["value_q4"] = _quantize_int4(
            params["blocks"]["ffn"]["value"], int4_group
        )
    elif quantize_int8:
        # int8 storage for the bandwidth-dominant decode weights (fused
        # projections, output, FFN); per-output-channel scales, dequantized
        # in the matmul operand load. ~2x fewer weight bytes per step.
        new_att["fused_a_q8"] = _quantize_int8(fused_a)
        new_att["fused_b_q8"] = _quantize_int8(fused_b)
        new_att["output_q8"] = _quantize_int8(att["output"])
        new_ffn["key_q8"] = _quantize_int8(params["blocks"]["ffn"]["key"])
        new_ffn["value_q8"] = _quantize_int8(params["blocks"]["ffn"]["value"])
    else:
        new_att["fused_a"] = fused_a
        new_att["fused_b"] = fused_b
    out["blocks"]["att"] = new_att
    out["blocks"]["ffn"] = new_ffn
    return out


def decode_step(
    params: Params,
    cfg: RWKV7Config,
    x: jax.Array,
    state: Params,
) -> Tuple[jax.Array, Params]:
    """One autoregressive step. x: (B, C) token embeddings (pre-ln0).

    The whole depth is one scanned program; with jit + donated state this is
    the replacement for the reference's persistent-state decode kernels
    (cuda/rwkv7_state_fwd_fp16.cu) — state lives in HBM across steps, every
    step is a single executable.
    """
    B, C = x.shape
    H, N = cfg.num_heads, cfg.head_size
    dt = cfg.dtype
    x = layer_norm(x.astype(dt), params["ln0_scale"], params["ln0_bias"], cfg.norm_eps)

    def body(carry, xs):
        x, v_first = carry
        bp, lid, st = xs
        att = bp["att"]
        cast = lambda p: p.astype(dt)

        xn = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.norm_eps)
        xx = st["att_x"].astype(dt) - xn
        if "fused_a" in att or "fused_a_q8" in att or "fused_a_q4" in att:
            # two fused matmuls replace the seven per-projection ones
            # (see pack_decode_params); weights may be int8/int4-quantized
            fused = xn @ _qmat(att, "fused_a", dt) + xx @ _qmat(att, "fused_b", dt)
            Dw, Da, Dv, Dg = (
                cfg.decay_lora, cfg.a_lora, cfg.v_lora, cfg.gate_lora,
            )
            r, k, v, w_h, a_h, v_h, g_h = (
                jnp.split(fused, np.cumsum([C, C, C, Dw, Da, Dv])[
                    :6
                ].tolist(), axis=-1)
            )
            w_raw = -jax.nn.softplus(
                -(cast(att["w0"]) + jnp.tanh(w_h) @ cast(att["w2"]))
            ) - 0.5
            v_resid = v + (v_first - v) * jax.nn.sigmoid(
                cast(att["v0"]) + v_h @ cast(att["v2"])
            )
            a = jax.nn.sigmoid(cast(att["a0"]) + a_h @ cast(att["a2"]))
            g = jax.nn.sigmoid(g_h) @ cast(att["g2"])
        else:
            xr, xw, xk, xv, xa, xg = (
                xn + xx * cast(att[f"x_{s}"]) for s in "rwkvag"
            )
            # projections may carry unfused int8 storage (pack_decode_params
            # with fuse_projections=False — the B=1 bandwidth-bound regime)
            r = xr @ _qmat(att, "receptance", dt)
            w_raw = -jax.nn.softplus(
                -(cast(att["w0"]) + _lora(xw, cast(att["w1"]), cast(att["w2"]), jnp.tanh))
            ) - 0.5
            k = xk @ _qmat(att, "key", dt)
            v = xv @ _qmat(att, "value", dt)
            v_resid = v + (v_first - v) * jax.nn.sigmoid(
                cast(att["v0"]) + _lora(xv, cast(att["v1"]), cast(att["v2"]))
            )
            a = jax.nn.sigmoid(cast(att["a0"]) + _lora(xa, cast(att["a1"]), cast(att["a2"])))
            g = _lora(xg, cast(att["g1"]), cast(att["g2"]), jax.nn.sigmoid)
        is_first = lid == 0
        v = jnp.where(is_first, v, v_resid)
        v_first = jnp.where(is_first, v, v_first)
        kk = l2_normalize((k * cast(att["k_k"])).reshape(B, H, N)).reshape(B, C)
        k = k * (1 + (a - 1) * cast(att["k_a"]))

        shp = lambda u: u.reshape(B, H, N)
        y, wkv_state = wkv7_ops.wkv7_step(
            st["wkv"], shp(r), shp(w_raw), shp(k), shp(v), shp(-kk), shp(kk * a)
        )
        y = y.reshape(B, C)
        y = group_norm(y, att["ln_x_scale"], att["ln_x_bias"], H, cfg.ln_x_eps)
        bonus = (
            (r.reshape(B, H, N) * k.reshape(B, H, N) * cast(att["r_k"]))
            .sum(-1, keepdims=True)
            * v.reshape(B, H, N)
        ).reshape(B, C)
        y = y + bonus
        x = x + (y * g) @ _qmat(att, "output", dt)

        ffn = bp["ffn"]
        xn2 = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], cfg.norm_eps)
        xx2 = st["ffn_x"].astype(dt) - xn2
        kf = xn2 + xx2 * cast(ffn["x_k"])
        kf = jnp.square(jax.nn.relu(kf @ _qmat(ffn, "key", dt)))
        x = x + kf @ _qmat(ffn, "value", dt)

        new_st = {"att_x": xn, "wkv": wkv_state, "ffn_x": xn2}
        return (x, v_first), new_st

    L = cfg.num_layers
    if isinstance(params["blocks"], tuple):
        # layered fast path: per-layer state leaves, python-unrolled — no
        # scan stacking copies (see pack_decode_state). Callers pre-slice
        # params with layer_decode_views and state with pack_decode_state.
        assert isinstance(state, tuple)
        carry = (x, jnp.zeros_like(x))
        new_states = []
        for l in range(L):
            carry, new_st = body(carry, (params["blocks"][l], l, state[l]))
            new_states.append(new_st)
        x, _ = carry
        new_state = tuple(new_states)
    else:
        # fully unrolled over layers: decode is latency-bound, and unrolling
        # lets XLA schedule/fuse across the whole depth
        (x, _), new_state = jax.lax.scan(
            body,
            (x, jnp.zeros_like(x)),
            (params["blocks"], jnp.arange(L), state),
            unroll=True,
        )
    x = layer_norm(x, params["ln_out_scale"], params["ln_out_bias"], cfg.norm_eps)
    return x, new_state
