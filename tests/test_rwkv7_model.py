"""RWKV-7 core model tests: prefill/decode equivalence, state carry, masking.

Greedy-equivalence between the parallel (chunked) forward and the sequential
decode step is the model-level analogue of the reference's pure-Python
RWKV_x070 forward_one/forward_seq consistency (rwkv_s2s_single_ffn.py:400-477).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rwkvtts_tpu.models import rwkv7 as M


@pytest.fixture(scope="module")
def setup():
    cfg = M.RWKV7Config(
        vocab_size=97,
        hidden_size=32,
        num_layers=3,
        head_size=8,
        gate_lora=16,
        dtype=jnp.float32,
        wkv_chunk=16,
        remat=False,
    )
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    # zero-init output/value projections make layers near-identity; perturb
    # them so the test actually exercises the whole path.
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    params["blocks"]["att"]["output"] = (
        jax.random.normal(k1, params["blocks"]["att"]["output"].shape) * 0.1
    )
    params["blocks"]["ffn"]["value"] = (
        jax.random.normal(k2, params["blocks"]["ffn"]["value"].shape) * 0.1
    )
    return cfg, params


def test_forward_shapes(setup):
    cfg, params = setup
    ids = jnp.arange(10)[None, :] % cfg.vocab_size
    h = M.forward(params, cfg, input_ids=ids)
    assert h.shape == (1, 10, cfg.hidden_size)
    lg = M.logits(params, cfg, h)
    assert lg.shape == (1, 10, cfg.vocab_size)


def test_decode_matches_forward(setup):
    cfg, params = setup
    B, T = 2, 12
    ids = jax.random.randint(jax.random.PRNGKey(2), (B, T), 0, cfg.vocab_size)
    h_par = M.forward(params, cfg, input_ids=ids)

    st = M.init_model_state(cfg, B, dtype=jnp.float32)
    hs = []
    for t in range(T):
        x = M.embed(params, cfg, ids[:, t])
        h, st = M.decode_step(params, cfg, x, st)
        hs.append(h)
    h_seq = jnp.stack(hs, axis=1)
    np.testing.assert_allclose(h_seq, h_par, rtol=2e-4, atol=2e-4)


def test_prefill_state_then_decode(setup):
    """forward(return_state) then decode_step == full forward."""
    cfg, params = setup
    B, T = 1, 14
    ids = jax.random.randint(jax.random.PRNGKey(3), (B, T), 0, cfg.vocab_size)
    h_full = M.forward(params, cfg, input_ids=ids)

    h_pre, st = M.forward(
        params, cfg, input_ids=ids[:, : T - 2], return_state=True
    )
    np.testing.assert_allclose(h_pre, h_full[:, : T - 2], rtol=2e-4, atol=2e-4)
    for t in range(T - 2, T):
        x = M.embed(params, cfg, ids[:, t])
        h, st = M.decode_step(params, cfg, x, st)
        np.testing.assert_allclose(h, h_full[:, t], rtol=2e-4, atol=2e-4)


def test_scan_impl_matches_chunked(setup):
    cfg, params = setup
    ids = jax.random.randint(jax.random.PRNGKey(4), (2, 9), 0, cfg.vocab_size)
    h_c = M.forward(params, cfg, input_ids=ids)
    cfg_s = M.RWKV7Config(**{**cfg.__dict__, "wkv_impl": "scan"})
    h_s = M.forward(params, cfg_s, input_ids=ids)
    np.testing.assert_allclose(h_c, h_s, rtol=2e-4, atol=2e-4)


def test_packing_resets_match_separate(setup):
    """Two samples packed with a reset == the two run separately."""
    cfg, params = setup
    ids_a = jax.random.randint(jax.random.PRNGKey(5), (1, 7), 0, cfg.vocab_size)
    ids_b = jax.random.randint(jax.random.PRNGKey(6), (1, 9), 0, cfg.vocab_size)
    packed = jnp.concatenate([ids_a, ids_b], axis=1)
    resets = jnp.zeros((1, 16), dtype=bool).at[0, 7].set(True)
    h_packed = M.forward(params, cfg, input_ids=packed, resets=resets)
    h_a = M.forward(params, cfg, input_ids=ids_a)
    h_b = M.forward(params, cfg, input_ids=ids_b)
    np.testing.assert_allclose(h_packed[:, :7], h_a, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h_packed[:, 7:], h_b, rtol=2e-4, atol=2e-4)


def test_gradients_flow(setup):
    cfg, params = setup
    ids = jax.random.randint(jax.random.PRNGKey(7), (2, 8), 0, cfg.vocab_size)

    def loss(p):
        h = M.forward(p, cfg, input_ids=ids)
        return (M.logits(p, cfg, h) ** 2).mean()

    g = jax.grad(loss)(params)
    gnorm = jax.tree.reduce(
        lambda a, x: a + jnp.abs(x).sum(), g, jnp.float32(0)
    )
    assert np.isfinite(gnorm) and gnorm > 0


def test_layer_unroll_matches_scan():
    """cfg.layer_unroll=True (python loop) is numerically identical to the
    scan-over-stacked-layers forward."""
    import dataclasses

    from rwkvtts_tpu.models import rwkv7

    cfg = rwkv7.RWKV7Config(
        vocab_size=100, hidden_size=64, num_layers=3, head_size=32,
        gate_lora=16, dtype=jnp.float32, remat=False,
    )
    params = rwkv7.init_params(jax.random.PRNGKey(0), cfg)
    ids = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, 100)
    h0 = rwkv7.forward(params, cfg, ids)
    cfg_u = dataclasses.replace(cfg, layer_unroll=True)
    h1 = rwkv7.forward(params, cfg_u, ids)
    np.testing.assert_allclose(np.asarray(h0), np.asarray(h1), rtol=1e-6, atol=1e-6)


def test_decode_state_pack_roundtrip(setup):
    """pack_decode_state <-> unpack_decode_state preserve layout exactly
    (guards the per-layer tuple layout the decode loops carry)."""
    cfg, params = setup
    st = M.init_model_state(cfg, batch=2, dtype=jnp.float32)
    # make the buffers distinguishable
    st = jax.tree.map(
        lambda x: x + jnp.arange(x.size, dtype=x.dtype).reshape(x.shape), st
    )
    packed = M.pack_decode_state(st, cfg)
    assert isinstance(packed, tuple) and len(packed) == cfg.num_layers
    # idempotent on an already-packed state
    assert M.pack_decode_state(packed, cfg) is packed
    unpacked = M.unpack_decode_state(packed, cfg)
    assert set(unpacked) == set(st)
    for k in st:
        np.testing.assert_array_equal(np.asarray(unpacked[k]), np.asarray(st[k]))
    # unpack on an already-stacked state is identity
    assert M.unpack_decode_state(st, cfg) is st
