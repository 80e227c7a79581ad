"""WKV7 equivalence tests: chunked / span / step vs the scan ground truth.

Mirrors the verification strategy the reference lacks but implies: the
pure-Python RWKV_x070 decode math (reference rwkv_s2s_single_ffn.py:499-506)
is the spec; wkv7_scan transcribes it; everything else must match it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rwkvtts_tpu.ops import wkv7 as W


def make_inputs(key, B=2, T=48, H=3, N=8, dtype=jnp.float32):
    ks = jax.random.split(key, 7)
    shp = (B, T, H, N)
    r = jax.random.normal(ks[0], shp, dtype) * 0.4
    # w_raw <= -0.5 soft-clamp range, keep decays in the realistic band
    w_raw = -0.5 - jax.nn.softplus(jax.random.normal(ks[1], shp, dtype))
    k = jax.random.normal(ks[2], shp, dtype) * 0.4
    v = jax.random.normal(ks[3], shp, dtype) * 0.4
    kk = jax.random.normal(ks[4], shp, dtype)
    kk = kk / (jnp.linalg.norm(kk, axis=-1, keepdims=True) + 1e-12)
    a = jax.nn.sigmoid(jax.random.normal(ks[5], shp, dtype))
    z = -kk
    b = kk * a
    state = jax.random.normal(ks[6], (B, H, N, N), jnp.float32) * 0.3
    return r, w_raw, k, v, z, b, state


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("T", [16, 48, 37, 64])
def test_chunked_matches_scan(chunk, T):
    key = jax.random.PRNGKey(0)
    r, w_raw, k, v, z, b, state = make_inputs(key, T=T)
    y_ref, s_ref = W.wkv7_scan(r, w_raw, k, v, z, b, state)
    y, s = W.wkv7_chunked(r, w_raw, k, v, z, b, state, chunk=chunk)
    np.testing.assert_allclose(y, y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s, s_ref, rtol=2e-4, atol=2e-4)


def test_chunked_zero_init_state():
    key = jax.random.PRNGKey(1)
    r, w_raw, k, v, z, b, _ = make_inputs(key, T=32)
    y_ref, s_ref = W.wkv7_scan(r, w_raw, k, v, z, b)
    y, s = W.wkv7_chunked(r, w_raw, k, v, z, b, chunk=16)
    np.testing.assert_allclose(y, y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s, s_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("chunk", [16, 64])
def test_segment_resets(chunk):
    """Packed segments must not leak state across boundaries."""
    key = jax.random.PRNGKey(2)
    B, T = 2, 40
    r, w_raw, k, v, z, b, state = make_inputs(key, B=B, T=T)
    resets = np.zeros((B, T), dtype=bool)
    resets[0, 13] = True
    resets[0, 29] = True
    resets[1, 5] = True
    resets = jnp.asarray(resets)

    y_ref, s_ref = W.wkv7_scan(r, w_raw, k, v, z, b, state, resets)
    y, s = W.wkv7_chunked(r, w_raw, k, v, z, b, state, resets, chunk=chunk)
    np.testing.assert_allclose(y, y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s, s_ref, rtol=2e-4, atol=2e-4)

    # Independently: segment after a reset equals a fresh run of that span.
    t0 = 13
    y_seg, _ = W.wkv7_scan(
        r[:1, t0:29], w_raw[:1, t0:29], k[:1, t0:29], v[:1, t0:29],
        z[:1, t0:29], b[:1, t0:29],
    )
    np.testing.assert_allclose(y[:1, t0:29], y_seg, rtol=2e-4, atol=2e-4)


def test_step_matches_scan():
    key = jax.random.PRNGKey(3)
    r, w_raw, k, v, z, b, state = make_inputs(key, T=7)
    y_ref, s_ref = W.wkv7_scan(r, w_raw, k, v, z, b, state)
    s = state
    ys = []
    for t in range(7):
        y, s = W.wkv7_step(
            s, r[:, t], w_raw[:, t], k[:, t], v[:, t], z[:, t], b[:, t]
        )
        ys.append(y)
    y_step = jnp.stack(ys, axis=1)
    np.testing.assert_allclose(y_step, y_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s, s_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_gradients_match_scan(chunk):
    """AD through the chunked scan must agree with AD through the step scan
    (the analogue of checking the CUDA backward against autograd)."""
    key = jax.random.PRNGKey(4)
    r, w_raw, k, v, z, b, state = make_inputs(key, B=1, T=32, H=2, N=8)

    def loss_fn(impl):
        def f(args):
            y, s = impl(*args)
            return (y.astype(jnp.float32) ** 2).sum() + (s**2).sum() * 0.1

        return f

    args = (r, w_raw, k, v, z, b, state)
    g_ref = jax.grad(loss_fn(W.wkv7_scan))(args)
    g_chk = jax.grad(
        loss_fn(lambda *a: W.wkv7_chunked(*a, chunk=chunk))
    )(args)
    for gr, gc, name in zip(g_ref, g_chk, "r w k v z b state".split()):
        np.testing.assert_allclose(
            gc, gr, rtol=5e-3, atol=5e-4, err_msg=f"grad mismatch: {name}"
        )


@pytest.mark.parametrize("chunk", [W.DEFAULT_CHUNK, 64])
def test_bf16_io(chunk):
    key = jax.random.PRNGKey(5)
    r, w_raw, k, v, z, b, state = make_inputs(key, T=32)
    cast = lambda x: x.astype(jnp.bfloat16)
    y, s = W.wkv7_chunked(
        cast(r), cast(w_raw), cast(k), cast(v), cast(z), cast(b), state,
        chunk=chunk,
    )
    assert y.dtype == jnp.bfloat16
    assert s.dtype == jnp.float32
    y_ref, _ = W.wkv7_scan(r, w_raw, k, v, z, b, state)
    np.testing.assert_allclose(
        y.astype(jnp.float32), y_ref, rtol=0.1, atol=0.1
    )


@pytest.mark.parametrize("chunk", [16, 64])
def test_segment_resets_gradients_match_scan(chunk):
    """Gradients through packed segments (resets mid-chunk and, at chunk
    16, on a chunk boundary) agree with AD through the scan, the initial
    state's gradient included."""
    key = jax.random.PRNGKey(12)
    B, T = 2, 40
    r, w_raw, k, v, z, b, state = make_inputs(key, B=B, T=T, H=2, N=8)
    resets = np.zeros((B, T), dtype=bool)
    resets[0, 13] = resets[0, 32] = resets[1, 5] = True
    resets = jnp.asarray(resets)

    def loss_fn(impl):
        def f(args):
            y, s = impl(*args, resets)
            return (y.astype(jnp.float32) ** 2).sum() + (s ** 2).sum() * 0.1

        return f

    args = (r, w_raw, k, v, z, b, state)
    g_ref = jax.grad(loss_fn(W.wkv7_scan))(args)
    g_chk = jax.grad(
        loss_fn(lambda *a: W.wkv7_chunked(*a, chunk=chunk))
    )(args)
    for gr, gc, name in zip(g_ref, g_chk, "r w k v z b state".split()):
        np.testing.assert_allclose(
            gc, gr, rtol=5e-3, atol=5e-4, err_msg=f"resets grad: {name}"
        )


@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_wkv_under_shard_map(impl):
    """Each batch shard runs the recurrence on its own device under
    shard_map over a dp axis of the virtual mesh, and matches the
    unsharded scan."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    r, w_raw, k, v, z, b, state = make_inputs(
        jax.random.PRNGKey(9), B=4, T=32, H=2, N=8
    )

    def local(*a):
        return W.wkv7(*a, impl=impl, chunk=16)

    sharded = jax.shard_map(
        local, mesh=mesh, in_specs=(P("dp"),) * 7, out_specs=(P("dp"), P("dp")),
    )
    y, s = jax.jit(sharded)(r, w_raw, k, v, z, b, state)
    y_ref, s_ref = W.wkv7_scan(r, w_raw, k, v, z, b, state)
    np.testing.assert_allclose(y, y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s, s_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("carry", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_step_carry_matches_scan(B, carry):
    """wkv7_step over several steps, its state carried in `carry` between
    steps (stepped in fp32 inside), against the fp32 scan. The bf16 carry
    rounds the state to 8 mantissa bits once per step."""
    T = 6
    r, w_raw, k, v, z, b, state = make_inputs(
        jax.random.PRNGKey(11), B=B, T=T, H=2, N=16
    )
    y_ref, s_ref = W.wkv7_scan(r, w_raw, k, v, z, b, state)
    step = jax.jit(W.wkv7_step)
    s = state.astype(carry)
    ys = []
    for t in range(T):
        y, s = step(s, r[:, t], w_raw[:, t], k[:, t], v[:, t], z[:, t], b[:, t])
        assert s.dtype == carry
        ys.append(y)
    tol = 1e-5 if carry == jnp.float32 else 2e-2
    np.testing.assert_allclose(jnp.stack(ys, 1), y_ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(s.astype(jnp.float32), s_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", W.IMPLS)
def test_resolve_impl_accepts(impl):
    assert W.resolve_impl(impl) == impl


@pytest.mark.parametrize("impl", ["pallas", "auto", "chunked_hoisted"])
def test_resolve_impl_rejects(impl):
    with pytest.raises(ValueError, match="unknown wkv7 impl"):
        W.resolve_impl(impl)


def test_wkv7_rejects_pallas():
    r, w_raw, k, v, z, b, state = make_inputs(jax.random.PRNGKey(7), T=16)
    with pytest.raises(ValueError, match="unknown wkv7 impl"):
        W.wkv7(r, w_raw, k, v, z, b, state, impl="pallas")
