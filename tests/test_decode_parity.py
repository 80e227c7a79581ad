"""Prefill + decode through the carried state against a plain float32
forward, for every prompt layout with an XLA decode path.

Each layout builds its prompt embeddings with its own model code, decodes
a few steps through `rwkv7.decode_step` (chip_checks.decode_parity, the
same helper chip_smoke.py runs at full width on the GPU), and compares the
last position's logits with one float32 full-sequence forward at
precision="highest". The system runs the deployed dtype (bf16) with the
state carried fp32 or bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rwkvtts_tpu.models import rwkv7
from rwkvtts_tpu.utils import chip_checks

B, T, K = 2, 12, 4
SMALL = dict(hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
             wkv_chunk=16)
# relative L2 of the logits and of the final WKV state: bf16 activations
# over two layers against float32 measure ~1e-2 here, with or without the
# bf16 carry; a decay off by 0.5 in log-log space measures ~6e-2 on the state
TOL = chip_checks.Tolerance(0.03, "bf16 activations (and carry) vs float32")


def _ids(seed, shape, hi):
    return jax.random.randint(jax.random.PRNGKey(seed), shape, 0, hi)


def _bf16(p):
    return jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, p)


def _steps(table, ids):
    """(K, B, C) float32 step embeddings from a (B, K) id array."""
    return jnp.moveaxis(table[ids], 0, 1).astype(jnp.float32)


def spark_layout(carry):
    from rwkvtts_tpu.models import spark

    cfg = spark.default_config(decode_state_bf16=carry, **SMALL)
    p = _bf16(chip_checks.fill_zero_init(
        spark.init_params(jax.random.PRNGKey(0), cfg), jax.random.PRNGKey(1)))
    mod = jnp.full((B, T), spark.MOD_TEXT).at[:, -1].set(spark.MOD_TAG)
    x = spark.embed_layout(p, cfg, _ids(2, (B, T), 4000), mod)
    return p, cfg.backbone, p["head"], x, _steps(p["embedding"], _ids(3, (B, K), 8192))


def cosy_layout(carry):
    from rwkvtts_tpu.models import cosy

    cfg = cosy.default_config(decode_state_bf16=carry, **SMALL)
    p = _bf16(chip_checks.fill_zero_init(
        cosy.init_params(jax.random.PRNGKey(0), cfg), jax.random.PRNGKey(1)))
    mod = jnp.full((B, T), cosy.MOD_TEXT).at[:, -1].set(cosy.MOD_SPECIAL)
    x = cosy.embed_layout(p, cfg, _ids(2, (B, T), 2), mod)
    return (p, cfg.backbone, p["head"], x,
            _steps(p["speech_embedding"], _ids(3, (B, K), cfg.speech_head_size)))


def xy_layout(carry):
    from rwkvtts_tpu.models import xy

    cfg = xy.default_config(decode_state_bf16=carry, **SMALL)
    p = _bf16(chip_checks.fill_zero_init(
        xy.init_params(jax.random.PRNGKey(0), cfg), jax.random.PRNGKey(1)))
    ids = jnp.concatenate([
        _ids(2, (B, T, 1), cfg.text_vocab_size),
        _ids(4, (B, T, cfg.num_channels - 1), cfg.speech_vocab_size),
    ], axis=-1)
    x = xy.embed_channels(p, cfg, ids)
    frames = jnp.concatenate([
        _ids(3, (B, K, 1), cfg.text_vocab_size),
        _ids(5, (B, K, cfg.num_channels - 1), cfg.speech_vocab_size),
    ], axis=-1)
    steps = jnp.stack([xy.decode_embed(p, cfg, frames[:, k]) for k in range(K)])
    return p, cfg.backbone, p["heads"]["3"], x, steps.astype(jnp.float32)


def asr_layout(carry):
    from rwkvtts_tpu.models import asr

    cfg = asr.default_config(
        adapter_layers=1, variant="discrete", audio_vocab=64,
        decode_state_bf16=carry, **SMALL,
    )
    p = _bf16(chip_checks.fill_zero_init(
        asr.init_params(jax.random.PRNGKey(0), cfg), jax.random.PRNGKey(1)))
    aud, _ = asr.audio_embeds(p, cfg, {"audio_ids": _ids(2, (B, T - 4), 64)})
    text = p["llm"]["embedding"][_ids(4, (B, 4), 65536)]
    x = jnp.concatenate([text.astype(aud.dtype), aud], axis=1)
    llm = p["llm"]
    return llm, cfg.llm, llm["head"], x, _steps(llm["embedding"], _ids(3, (B, K), 65536))


def s2s_layout(carry):
    from rwkvtts_tpu.models import s2s

    cfg = s2s.default_config(decode_state_bf16=carry, **SMALL)
    p = _bf16(chip_checks.fill_zero_init(
        s2s.init_params(jax.random.PRNGKey(0), cfg), jax.random.PRNGKey(1)))
    x = p["embedding"][_ids(2, (B, T), cfg.text_vocab_size)]
    # audio-head decode: sampled ids offset by the text vocab on input
    steps = _steps(p["embedding"], _ids(3, (B, K), cfg.audio_vocab_size)
                   + cfg.text_vocab_size)
    return p, cfg.backbone, p["audio_head"], x, steps


def two_tower_layout(carry):
    from rwkvtts_tpu.models import tts_two_tower as tt

    small = {k: v for k, v in SMALL.items()
             if k not in ("hidden_size", "num_layers")}
    cfg = tt.default_config(
        text_hidden=32, text_layers=1, audio_hidden=32, audio_layers=2,
        decode_state_bf16=carry, **small,
    )
    p = _bf16(chip_checks.fill_zero_init(
        tt.init_params(jax.random.PRNGKey(0), cfg), jax.random.PRNGKey(1)))
    x = tt._text_tower(p, cfg, _ids(2, (B, T), 65536), jnp.ones((B, T), jnp.int32))
    a = p["audio_lm"]
    return a, cfg.audio, a["head"], x, _steps(a["embedding"], _ids(3, (B, K), tt.AUDIO_VOCAB))


LAYOUTS = {
    "spark": spark_layout, "cosy": cosy_layout, "xy": xy_layout,
    "asr": asr_layout, "s2s": s2s_layout, "tts_two_tower": two_tower_layout,
}


@pytest.mark.parametrize("carry", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prefill_decode_matches_float32_forward(layout, carry):
    params, cfg, head, x, steps = LAYOUTS[layout](carry)
    assert cfg.dtype == jnp.bfloat16 and cfg.decode_state_bf16 == carry
    res = chip_checks.decode_parity(params, cfg, head, x, steps)
    assert res["logits"][0].shape == (B, head.shape[1])
    assert res["wkv"][0].shape == (cfg.num_layers, B, cfg.num_heads,
                                   cfg.head_size, cfg.head_size)
    for k, (got, want) in res.items():
        chip_checks.check_close(f"{layout} {k}", got, want, TOL)


@pytest.mark.parametrize("carry", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_state_pack_roundtrip(layout, carry):
    """pack_decode_state gives one dict per layer (wkv carried in the
    configured dtype, no pair packing); unpack_decode_state restores the
    stacked layout."""
    _, cfg, _, _, _ = LAYOUTS[layout](carry)
    st = rwkv7.init_model_state(cfg, batch=3, dtype=jnp.float32)
    st = jax.tree.map(
        lambda a: jax.random.normal(jax.random.PRNGKey(a.ndim), a.shape), st
    )
    packed = rwkv7.pack_decode_state(st, cfg)
    assert isinstance(packed, tuple) and len(packed) == cfg.num_layers
    H, N = cfg.num_heads, cfg.head_size
    for st_l in packed:
        assert st_l["wkv"].shape == (3, H, N, N)
        assert st_l["wkv"].dtype == (jnp.bfloat16 if carry else jnp.float32)
    assert rwkv7.pack_decode_state(packed, cfg) is packed
    back = rwkv7.unpack_decode_state(packed, cfg)
    for k in st:
        want = st[k].astype(jnp.bfloat16) if (carry and k == "wkv") else st[k]
        np.testing.assert_array_equal(
            np.asarray(back[k], np.float32), np.asarray(want, np.float32)
        )


def test_decode_parity_catches_injected_error():
    """The parity helper, at the tolerance the tests use, fails a system
    that departs from the reference: here the decode params carry every
    layer's decay bias w0 off by 0.5."""
    params, cfg, head, x, steps = spark_layout(False)
    dp = rwkv7.pack_decode_params(params, cfg)
    att = dict(dp["blocks"]["att"])
    att["w0"] = att["w0"] + 0.5
    bad = {**dp, "blocks": {**dp["blocks"], "att": att}}
    got, want = chip_checks.decode_parity(
        params, cfg, head, x, steps, decode_params=bad
    )["wkv"]
    with pytest.raises(AssertionError, match="relative error"):
        chip_checks.check_close("injected", got, want, TOL)


def test_reference_config_is_plain_float32():
    _, cfg, _, _, _ = spark_layout(True)
    ref = chip_checks.reference_config(dataclasses.replace(cfg, wkv_spans=2))
    assert ref.dtype == jnp.float32 and ref.wkv_impl == "scan"
    assert not ref.decode_state_bf16 and ref.wkv_spans == 1 and not ref.remat
