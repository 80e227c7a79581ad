"""WKV7 — the RWKV-7 time-mix recurrence.

The recurrence (per 64-dim head, per step; reference semantics:
/root/reference/model/llm/cuda/wkv7_cuda.cu:10-52 and the pure-Python spec at
/root/reference/model/llm/rwkv_s2s_single_ffn.py:499-506):

    decay    w_t  = exp(-exp(w_raw_t))            elementwise, w_raw <= -0.5
    sa_t     = S_{t-1} @ z_t                       (N,) per row of state
    S_t      = S_{t-1} * w_t[None, :] + sa_t[:, None] * b_t[None, :] + v_t[:, None] * k_t[None, :]
    y_t      = S_t @ r_t

State S is (N_v x N_k) fp32 per head; rows index the value dim, columns the
key dim. Inputs/outputs are bf16; state math is fp32. z = -kk, b = kk*a in
the model (see models/rwkv7.py).

Three implementations, one contract:

  * ``wkv7_scan``    — per-step `lax.scan`. Ground truth + tiny-T fallback.
  * ``wkv7_chunked`` — chunk-parallel matmul formulation (the XLA
    equivalent of the reference's CHUNK_LEN=16 "wind_backstepping" CUDA
    kernel). All within-chunk work is batched matmuls that XLA hands to the
    tensor cores; the sequential dependency is only across chunks (a short
    `lax.scan` carrying the (B,H,N,N) state). Differentiable; the chunk
    body is `jax.checkpoint`-ed so the backward replays each chunk from its
    entry state — the same checkpoint-and-recompute strategy as the CUDA
    backward (wkv7_cuda.cu:54-130), expressed through XLA AD.
  * ``wkv7_step``    — single decode step carrying persistent state (the
    equivalent of wkv7s.cu / rwkv7_state_fwd_fp16.cu, but batched and
    jit-fusable into a whole-model decode step).

Variable-length packing: the reference relies on rwkv-fla's `cu_seqlens`
varlen kernels (SURVEY.md §2.7). Here packing is expressed as a per-position
``resets`` flag (True where a new packed segment begins); the kernels zero
the state carried into such positions so packed samples never leak context.

Chunked math (derivation):
  With per-chunk entry state S0, cumulative log-decay g_t = sum_{s<=t} log w_s
  (inclusive) and gp_t = g_t - log w_t (exclusive), define
      q~_t = r_t * exp(g_t)     z~_t = z_t * exp(gp_t)
      k~_s = k_s * exp(-g_s)    b~_s = b_s * exp(-g_s)
  Then with A[t,s] = (z~_t . b~_s) [s<t], Kz[t,s] = (z~_t . k~_s) [s<t]:
      SA  = (I - A)^{-1} (Z~ S0^T + Kz V)            rows are sa_t
      Y   = Q~ S0^T + tril(Q~ B~^T) SA + tril(Q~ K~^T) V
      S_L = S0 * exp(g_L) + SA^T (B~ * exp(g_L)) + V^T (K~ * exp(g_L))
  (I - A) is unit-lower-triangular and A is nilpotent, so the inverse is the
  exact Neumann-doubling product (I+A)(I+A^2)(I+A^4)... — log2(L) small
  matmuls, no triangular solve needed.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

STATE_DTYPE = jnp.float32
DEFAULT_CHUNK = 32
# w_raw used for padding positions: exp(-exp(-30)) ~= 1.0 (identity decay).
_PAD_W_RAW = -30.0


def decay_from_raw(w_raw: jax.Array) -> jax.Array:
    """w = exp(-exp(w_raw)); w_raw is the soft-clamped log-log decay."""
    return jnp.exp(-jnp.exp(w_raw.astype(jnp.float32)))


def log_decay_from_raw(w_raw: jax.Array) -> jax.Array:
    """log w = -exp(w_raw)."""
    return -jnp.exp(w_raw.astype(jnp.float32))


def init_state(batch: int, n_head: int, head_size: int) -> jax.Array:
    return jnp.zeros((batch, n_head, head_size, head_size), dtype=STATE_DTYPE)


# ---------------------------------------------------------------------------
# Reference scan implementation
# ---------------------------------------------------------------------------


def wkv7_scan(
    r: jax.Array,
    w_raw: jax.Array,
    k: jax.Array,
    v: jax.Array,
    z: jax.Array,
    b: jax.Array,
    state: Optional[jax.Array] = None,
    resets: Optional[jax.Array] = None,
    return_states: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Per-step scan. Inputs (B, T, H, N); state (B, H, N, N) fp32.

    Returns (y, final_state); y has the dtype of v. With
    `return_states=True`, returns (y, all_states (B, T, H, N, N)) — the
    state AFTER each position, used by speculative-decode verification
    (infer/spec_decode.py) to roll back to the last accepted token.
    """
    B, T, H, N = r.shape
    if state is None:
        state = init_state(B, H, N)
    w = decay_from_raw(w_raw)
    f32 = lambda x: x.astype(jnp.float32)
    xs = tuple(jnp.moveaxis(f32(x), 1, 0) for x in (r, w, k, v, z, b))
    if resets is None:
        resets_t = jnp.zeros((T, B), dtype=bool)
    else:
        resets_t = jnp.moveaxis(resets, 1, 0)

    def step(s, inp):
        rt, wt, kt, vt, zt, bt, reset = inp
        s = jnp.where(reset[:, None, None, None], 0.0, s)
        sa = jnp.einsum("bhij,bhj->bhi", s, zt)
        s = (
            s * wt[:, :, None, :]
            + sa[..., None] * bt[:, :, None, :]
            + vt[..., None] * kt[:, :, None, :]
        )
        y = jnp.einsum("bhij,bhj->bhi", s, rt)
        return s, (y, s) if return_states else y

    final_state, ys = jax.lax.scan(step, state, xs + (resets_t,))
    if return_states:
        ys, all_states = ys
    y = jnp.moveaxis(ys, 0, 1).reshape(B, T, H * N).astype(v.dtype)
    y = y.reshape(B, T, H, N)
    if return_states:
        return y, jnp.moveaxis(all_states, 0, 1)
    return y, final_state


# ---------------------------------------------------------------------------
# Chunked (matmul) implementation
# ---------------------------------------------------------------------------


def _neumann_inverse(a: jax.Array, chunk: int) -> jax.Array:
    """(I - A)^{-1} for strictly-lower-triangular A via Neumann doubling.

    A is (..., L, L), nilpotent with A^L = 0, so
    (I-A)^{-1} = prod_{i} (I + A^{2^i}) exactly, in ceil(log2(L)) matmuls.
    """
    eye = jnp.eye(chunk, dtype=a.dtype)
    out = eye + a
    power = a
    steps = max(0, (chunk - 1).bit_length() - 1)
    for _ in range(steps):
        power = power @ power
        out = out @ (eye + power)
    return out


def _chunk_body(s0, seg0, chunk_inputs, *, chunk: int):
    """Process one chunk. s0: (B,H,N,N) fp32 entry state; seg0: (B,) int32
    segment counter of the entry state. chunk_inputs are (B,L,H,N) fp32
    (r, logw, k, v, z, b) plus resets (B,L) int32."""
    r, logw, k, v, z, b, resets = chunk_inputs
    # inputs may arrive in their model dtype (bf16): the scan slices then
    # move half the bytes; the up-cast here is exact and fuses into the
    # first consumer
    f32 = lambda t: t.astype(jnp.float32)
    r, logw, k, v, z, b = map(f32, (r, logw, k, v, z, b))
    L = chunk
    # Segment bookkeeping (all int32; c counts resets inclusively per chunk).
    c = jnp.cumsum(resets, axis=1)  # (B, L)
    # Zero decay at reset positions: their w multiplies state that is masked
    # away anyway; keeping logw finite keeps all ratios NaN-free.
    logw = jnp.where(resets[:, :, None, None] > 0, 0.0, logw)
    g = jnp.cumsum(logw, axis=1)  # inclusive (B,L,H,N)

    # 2 exps + 1 reciprocal instead of 3 exps:
    # exp(gp) = exp(g - logw) = e_g * exp(-logw);  exp(-g) = 1 / e_g
    e_g = jnp.exp(g)
    e_ginv = jnp.reciprocal(e_g)
    qt = r * e_g
    zt = z * e_g * jnp.exp(-logw)
    kt = k * e_ginv
    bt = b * e_ginv

    # (B, H, L, L) pairwise mats; contract over N.
    def pair(x, y):
        return jnp.einsum("blhn,bmhn->bhlm", x, y)

    same_seg = (c[:, :, None] == c[:, None, :])[:, None, :, :]  # (B,1,L,L)
    strict = jnp.tril(jnp.ones((L, L), dtype=bool), k=-1)
    incl = jnp.tril(jnp.ones((L, L), dtype=bool))
    m_strict = jnp.where(jnp.logical_and(same_seg, strict), 1.0, 0.0)
    m_incl = jnp.where(jnp.logical_and(same_seg, incl), 1.0, 0.0)

    A = pair(zt, bt) * m_strict
    Kz = pair(zt, kt) * m_strict
    inv = _neumann_inverse(A, L)  # (B,H,L,L)

    # S0 contribution is valid only for positions still in the entry segment.
    mask0 = (c == 0)[:, :, None, None]  # (B,L,1,1)
    z0 = jnp.where(mask0, zt, 0.0)
    q0 = jnp.where(mask0, qt, 0.0)

    # rows of sa: (B, L, H, Nv)
    sa_in = jnp.einsum("blhn,bhin->blhi", z0, s0) + jnp.einsum(
        "bhlm,bmhi->blhi", Kz, v
    )
    sa = jnp.einsum("bhlm,bmhi->blhi", inv, sa_in)

    y = (
        jnp.einsum("blhn,bhin->blhi", q0, s0)
        + jnp.einsum("bhlm,bmhi->blhi", pair(qt, bt) * m_incl, sa)
        + jnp.einsum("bhlm,bmhi->blhi", pair(qt, kt) * m_incl, v)
    )

    # Final state: sources with c_s == c_L survive; S0 survives iff c_L == 0.
    c_last = c[:, -1]  # (B,)
    live = (c == c_last[:, None])[:, :, None, None]  # (B,L,1,1)
    wfin = jnp.exp(g[:, -1])[:, None]  # (B,1,H,N) broadcast over sources
    k_fin = jnp.where(live, kt, 0.0) * wfin
    b_fin = jnp.where(live, bt, 0.0) * wfin
    s0_live = jnp.where((c_last == 0)[:, None, None, None], 1.0, 0.0)
    s_out = (
        s0 * s0_live * jnp.exp(g[:, -1])[:, :, None, :]
        + jnp.einsum("blhi,blhn->bhin", sa, b_fin)
        + jnp.einsum("blhi,blhn->bhin", v, k_fin)
    )
    seg_out = seg0 + c_last
    return s_out, seg_out, y


def wkv7_chunked(
    r: jax.Array,
    w_raw: jax.Array,
    k: jax.Array,
    v: jax.Array,
    z: jax.Array,
    b: jax.Array,
    state: Optional[jax.Array] = None,
    resets: Optional[jax.Array] = None,
    *,
    chunk: int = DEFAULT_CHUNK,
    checkpoint: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Chunk-parallel WKV7. Inputs (B, T, H, N). T is padded internally to a
    multiple of `chunk` with identity-decay/zero-update steps."""
    B, T, H, N = r.shape
    out_dtype = v.dtype
    if state is None:
        state = init_state(B, H, N)
    pad = (-T) % chunk
    # keep inputs in their native (bf16) dtype until inside the chunk body —
    # halves the per-chunk slice traffic; logw must be fp32 (cumsum range)
    logw = log_decay_from_raw(w_raw)
    if pad:
        zpad = lambda x: jnp.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
        r, k, v, z, b = (zpad(x) for x in (r, k, v, z, b))
        logw = jnp.pad(logw, ((0, 0), (0, pad), (0, 0), (0, 0)))  # logw=0 → w=1
    Tp = T + pad
    n_chunks = Tp // chunk
    if resets is None:
        resets_i = jnp.zeros((B, Tp), dtype=jnp.int32)
    else:
        resets_i = resets.astype(jnp.int32)
        if pad:
            resets_i = jnp.pad(resets_i, ((0, 0), (0, pad)))

    def to_chunks(x):
        return jnp.moveaxis(
            x.reshape((B, n_chunks, chunk) + x.shape[2:]), 1, 0
        )

    xs = tuple(to_chunks(x) for x in (r, logw, k, v, z, b, resets_i))

    body = functools.partial(_chunk_body, chunk=chunk)
    if checkpoint:
        body = jax.checkpoint(body, static_argnums=())

    def scan_fn(carry, chunk_inputs):
        s, seg = carry
        s_out, seg_out, y = body(s, seg, chunk_inputs)
        return (s_out, seg_out), y

    seg0 = jnp.zeros((B,), dtype=jnp.int32)
    (s_fin, _), ys = jax.lax.scan(scan_fn, (state, seg0), xs)
    # ys: (n_chunks, B, L, H, N) → (B, T, H, N)
    y = jnp.moveaxis(ys, 0, 1).reshape(B, Tp, H, N)[:, :T]
    return y.astype(out_dtype), s_fin


# ---------------------------------------------------------------------------
# State-independent chunk prep (the building block of the span path below)
# ---------------------------------------------------------------------------


def _chunk_prep(r, logw, k, v, z, b, resets, *, chunk: int):
    """All state-independent per-chunk work, batched over every chunk at
    once (vmapped caller). Returns the minimal tensors the sequential scan
    needs; the scan body is then only the four state-coupled matmuls.

    Derivation: with sa = inv @ (z0 s0ᵀ + Kz v) = sa_kv + inv (z0 s0ᵀ),
        y    = y_pre + q0 s0ᵀ + M (z0 s0ᵀ)          M    = QB_incl @ inv
        s_out= s_pre + live0·s0·exp(g_L) + (z0 s0ᵀ)ᵀ-contraction with C
                                                      C_mn = Σ_l inv_lm b_fin_ln
    where y_pre = QB sa_kv + QK v and s_pre = sa_kvᵀ b_fin + vᵀ k_fin are
    state-free. Everything here lowers to large batched matmuls with
    (n_chunks·B·H) batch — the serial critical path shrinks ~4x.
    """
    L = chunk
    c = jnp.cumsum(resets, axis=1)
    logw = jnp.where(resets[:, :, None, None] > 0, 0.0, logw)
    g = jnp.cumsum(logw, axis=1)
    gp = g - logw

    qt = r * jnp.exp(g)
    zt = z * jnp.exp(gp)
    kt = k * jnp.exp(-g)
    bt = b * jnp.exp(-g)

    def pair(x, y):
        return jnp.einsum("blhn,bmhn->bhlm", x, y)

    same_seg = (c[:, :, None] == c[:, None, :])[:, None, :, :]
    strict = jnp.tril(jnp.ones((L, L), dtype=bool), k=-1)
    incl = jnp.tril(jnp.ones((L, L), dtype=bool))
    m_strict = jnp.where(jnp.logical_and(same_seg, strict), 1.0, 0.0)
    m_incl = jnp.where(jnp.logical_and(same_seg, incl), 1.0, 0.0)

    A = pair(zt, bt) * m_strict
    Kz = pair(zt, kt) * m_strict
    inv = _neumann_inverse(A, L)

    mask0 = (c == 0)[:, :, None, None]
    z0 = jnp.where(mask0, zt, 0.0)
    q0 = jnp.where(mask0, qt, 0.0)

    sa_kv = jnp.einsum("bhlm,bmhi->blhi", inv, jnp.einsum("bhlm,bmhi->blhi", Kz, v))
    QB = pair(qt, bt) * m_incl
    QK = pair(qt, kt) * m_incl
    y_pre = jnp.einsum("bhlm,bmhi->blhi", QB, sa_kv) + jnp.einsum(
        "bhlm,bmhi->blhi", QK, v
    )
    M = jnp.einsum("bhlm,bhmn->bhln", QB, inv)

    c_last = c[:, -1]
    live = (c == c_last[:, None])[:, :, None, None]
    wfin = jnp.exp(g[:, -1])[:, None]
    k_fin = jnp.where(live, kt, 0.0) * wfin
    b_fin = jnp.where(live, bt, 0.0) * wfin
    s_pre = jnp.einsum("blhi,blhn->bhin", sa_kv, b_fin) + jnp.einsum(
        "blhi,blhn->bhin", v, k_fin
    )
    C = jnp.einsum("bhlm,blhn->bhmn", inv, b_fin)
    wlast = jnp.exp(g[:, -1])  # (B, H, N)
    return dict(
        z0=z0, q0=q0, M=M, C=C, y_pre=y_pre, s_pre=s_pre,
        wlast=wlast, c_last=c_last,
    )


def _chunk_step(s0, seg0, p):
    """State-coupled part of one chunk: four matmuls + elementwise."""
    u = jnp.einsum("blhn,bhin->blhi", p["z0"], s0)  # z0 · S0ᵀ rows
    y = (
        p["y_pre"]
        + jnp.einsum("blhn,bhin->blhi", p["q0"], s0)
        + jnp.einsum("bhlm,bmhi->blhi", p["M"], u)
    )
    live0 = (p["c_last"] == 0)[:, None, None, None].astype(s0.dtype)
    s_out = (
        p["s_pre"]
        + s0 * live0 * p["wlast"][:, :, None, :]
        + jnp.einsum("bmhi,bhmn->bhin", u, p["C"])
    )
    return s_out, seg0 + p["c_last"], y


# ---------------------------------------------------------------------------
# Hierarchical / sequence-parallel chunking (two-level state pass)
# ---------------------------------------------------------------------------
#
# The per-chunk state update is AFFINE in the entry state (see _chunk_step:
# s_out = s_pre + s0·live0·wlast + (z0 s0ᵀ)-contraction), so every chunk has
# an exact (N,N) transfer operator
#     Mx = diag(live0 · wlast) + Z0ᵀ C            (S_out = S0 @ Mx + const)
# and an exact output-correction operator
#     Cy[l] = q0[l] + (M @ z0)[l]                 (Δy_l  = S0 @ Cy[l])
# both computable from tensors _chunk_prep already builds. Composing the
# affine maps turns the O(T/chunk) serial state scan into
#     per-span local scans (parallel over spans)  +  an O(spans) compose.
# Two uses, one code path:
#   * wkv_spans>1 on ONE device: the serial critical path of the chunk scan
#     shrinks by `spans`;
#   * T sharded over a mesh axis: each device computes its local span's
#     (y0, Cyp, Q, P) independently; only the tiny (B,H,N,N) compose scan
#     crosses devices (GSPMD inserts the collective-permutes) — the
#     linear-RNN analogue of ring-attention context parallelism, which the
#     reference cannot express at all (its CUDA kernel is single-GPU over
#     the full T, wkv7_cuda.cu grid=(H,B)).
# Resets compose exactly: z0/q0/live0/b_fin masking inside _chunk_prep
# makes each chunk's affine map already reset-aware, and products of
# reset-aware maps stay exact (a reset zeroes the linear part downstream).


def _chunk_prep_affine(r, logw, k, v, z, b, resets, *, chunk: int):
    """_chunk_prep plus the chunk's affine operators (Mx, Cy)."""
    p = _chunk_prep(r, logw, k, v, z, b, resets, chunk=chunk)
    N = r.shape[-1]
    live0 = (p["c_last"] == 0).astype(jnp.float32)[:, None, None, None]
    # S0 pass-through: columns decay by wlast; killed if the chunk reset
    diag = jnp.eye(N, dtype=jnp.float32) * p["wlast"][:, :, None, :] * live0
    # rank-L correction: S0 @ (Σ_m z0_m ⊗ C[m,:])
    mx = diag + jnp.einsum("bmhk,bhmn->bhkn", p["z0"], p["C"])
    cy = p["q0"] + jnp.einsum("bhlm,bmhn->blhn", p["M"], p["z0"])
    return p, mx, cy


def _span_affine(r, logw, k, v, z, b, resets, *, chunk: int):
    """One span's local pass, entry state unknown. Inputs (B, Ts, H, N).

    Returns (y0, cyp, q, pmat):
      y0   (B,Ts,H,N)  outputs as if the span entered with S0 = 0
      cyp  (B,Ts,H,N)  correction rows: y_t = y0_t + S_span_in @ cyp_t
      q    (B,H,N,N)   span exit state for S0 = 0
      pmat (B,H,N,N)   span transfer: S_out = S_span_in @ pmat + q
    """
    B, Ts, H, N = r.shape
    n_chunks = Ts // chunk

    def to_chunks(x):
        return jnp.moveaxis(x.reshape((B, n_chunks, chunk) + x.shape[2:]), 1, 0)

    xs = tuple(to_chunks(x) for x in (r, logw, k, v, z, b, resets))

    def body(carry, chunk_inputs):
        s, pmat = carry
        p, mx, cy = _chunk_prep_affine(*chunk_inputs, chunk=chunk)
        s_out, _, y = _chunk_step(s, jnp.zeros((B,), jnp.int32), p)
        # lift the chunk-relative correction to span-relative:
        # Δy_l = S_chunk_in @ cy_l = S_span_in @ (pmat @ cy_l)
        cyp = jnp.einsum("bhmn,blhn->blhm", pmat, cy)
        return (s_out, pmat @ mx), (y, cyp)

    fn = jax.checkpoint(body)
    s0 = jnp.zeros((B, H, N, N), jnp.float32)
    p0 = jnp.broadcast_to(jnp.eye(N, dtype=jnp.float32), (B, H, N, N))
    (q, pmat), (ys, cyps) = jax.lax.scan(fn, (s0, p0), xs)
    reshape = lambda t: jnp.moveaxis(t, 0, 1).reshape(B, Ts, H, N)
    return reshape(ys), reshape(cyps), q, pmat


def wkv7_chunked_sp(
    r: jax.Array,
    w_raw: jax.Array,
    k: jax.Array,
    v: jax.Array,
    z: jax.Array,
    b: jax.Array,
    state: Optional[jax.Array] = None,
    resets: Optional[jax.Array] = None,
    *,
    chunk: int = DEFAULT_CHUNK,
    spans: int = 4,
) -> Tuple[jax.Array, jax.Array]:
    """Two-level chunked WKV7: spans in parallel, chunks within each span.

    Same contract (and same fp32 numerics contract) as ``wkv7_chunked``;
    exact for any spans/chunk, resets and entry state included. When the
    caller shards T over a mesh axis in `spans` equal pieces, the span dim
    of every heavy tensor inherits that sharding through the reshape and
    the only cross-device dataflow is the (B,H,N,N) compose scan — context
    parallelism for the linear-state recurrence (see block comment above).

    Sharded-T caveat: keep T a multiple of chunk*spans. Values stay exact
    regardless (padding is handled), but a padded tail shifts the
    span-reshape off the shard boundaries, so GSPMD reshards the heavy
    tensors instead of keeping spans device-local (train/cli.py warns).
    """
    B, T, H, N = r.shape
    out_dtype = v.dtype
    if state is None:
        state = init_state(B, H, N)
    pad = (-T) % (chunk * spans)
    logw = log_decay_from_raw(w_raw)
    f32 = lambda x: x.astype(jnp.float32)
    if pad:
        zpad = lambda x: jnp.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
        r, k, v, z, b = (zpad(f32(x)) for x in (r, k, v, z, b))
        logw = jnp.pad(logw, ((0, 0), (0, pad), (0, 0), (0, 0)))
    else:
        r, k, v, z, b = (f32(x) for x in (r, k, v, z, b))
    Tp = T + pad
    Ts = Tp // spans
    if resets is None:
        resets_i = jnp.zeros((B, Tp), dtype=jnp.int32)
    else:
        resets_i = resets.astype(jnp.int32)
        if pad:
            resets_i = jnp.pad(resets_i, ((0, 0), (0, pad)))

    def to_spans(x):
        return x.reshape((B, spans, Ts) + x.shape[2:])

    y0, cyp, q, pmat = jax.vmap(
        functools.partial(_span_affine, chunk=chunk),
        in_axes=1, out_axes=(1, 1, 0, 0),
    )(*(to_spans(x) for x in (r, logw, k, v, z, b, resets_i)))

    # compose the spans' affine maps: tiny (B,H,N,N) scan, `spans` steps —
    # the ONLY sequential/cross-device dataflow in the whole op
    def comp(s, qp):
        q_j, p_j = qp
        return jnp.einsum("bhim,bhmn->bhin", s, p_j) + q_j, s

    s_fin, s_in = jax.lax.scan(comp, state, (q, pmat))

    y = y0 + jnp.einsum("sbhim,bslhm->bslhi", s_in, cyp)
    y = y.reshape(B, Tp, H, N)[:, :T]
    return y.astype(out_dtype), s_fin


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def wkv7_step(
    state: jax.Array,
    r: jax.Array,
    w_raw: jax.Array,
    k: jax.Array,
    v: jax.Array,
    z: jax.Array,
    b: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """One decode step. state (B,H,N,N) fp32; r..b (B,H,N). Returns (y, state).

    Equivalent to the persistent-state inference kernels
    (reference cuda/rwkv7_state_fwd_fp16.cu) but batched and designed to be
    fused by XLA into a single whole-model decode program.
    """
    out_dtype = v.dtype
    # the carry dtype is preserved: a bf16 state (cfg.decode_state_bf16)
    # is stepped in fp32 and cast back at the carry boundary — the
    # reference's fp16-state decode kernel contract
    # (cuda/rwkv7_state_fwd_fp16.cu)
    state_dtype = state.dtype
    f32 = lambda x: x.astype(jnp.float32)
    r, k, v, z, b = map(f32, (r, k, v, z, b))
    state = f32(state)
    w = decay_from_raw(w_raw)
    sa = jnp.einsum("bhij,bhj->bhi", state, z)
    state = (
        state * w[:, :, None, :]
        + sa[..., None] * b[:, :, None, :]
        + v[..., None] * k[:, :, None, :]
    )
    y = jnp.einsum("bhij,bhj->bhi", state, r)
    return y.astype(out_dtype), state.astype(state_dtype)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

IMPLS = ("chunked", "scan")


def resolve_impl(impl: str) -> str:
    """Validate a WKV implementation name: 'chunked' (training/prefill) or
    'scan' (the per-step reference)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown wkv7 impl: {impl!r} (expected one of {IMPLS})")
    return impl


def wkv7(
    r,
    w_raw,
    k,
    v,
    z,
    b,
    state=None,
    resets=None,
    *,
    impl: str = "chunked",
    chunk: int = DEFAULT_CHUNK,
    spans: int = 1,
):
    """Dispatching entry point used by the models.

    impl: 'chunked' (training/prefill) or 'scan' (reference).

    spans > 1 selects the two-level hierarchical path (wkv7_chunked_sp)
    regardless of impl; spans is also the sequence-parallel sharding unit
    when T is sharded.
    """
    impl = resolve_impl(impl)
    if spans > 1:
        return wkv7_chunked_sp(
            r, w_raw, k, v, z, b, state, resets, chunk=chunk, spans=spans
        )
    if impl == "scan":
        return wkv7_scan(r, w_raw, k, v, z, b, state, resets)
    return wkv7_chunked(r, w_raw, k, v, z, b, state, resets, chunk=chunk)
