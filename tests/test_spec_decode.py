"""Self-speculative greedy decode: losslessness + collected-state math.

The whole point of infer/spec_decode.py is that its output is BIT-EXACT
the plain greedy rollout (the draft only proposes; every emitted token is
re-derived from full-precision verify logits) — so the tests assert token
equality against infer/generate.greedy_spark_generate, with both a bf16
draft and an int8 draft.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rwkvtts_tpu.infer import generate, spec_decode
from rwkvtts_tpu.models import rwkv7, spark


@pytest.fixture(scope="module")
def setup():
    cfg = spark.default_config(
        hidden_size=32, num_layers=2, dtype=jnp.float32, head_size=8,
        gate_lora=16, remat=False, wkv_chunk=16,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    # randomize zero-init loras so quantization/fusion paths are exercised
    k = jax.random.PRNGKey(1)
    att = dict(params["blocks"]["att"])
    for name in ("w1", "a1", "v1", "g1"):
        k, sub = jax.random.split(k)
        att[name] = 0.1 * jax.random.normal(sub, att[name].shape)
    params["blocks"] = dict(params["blocks"], att=att)
    return cfg, params


def _prompt(cfg):
    # tiny hand-built prompt: TAG2 + a few text tokens (all modality TAG/TEXT
    # semantics don't matter for rollout equality — only determinism does)
    tokens = jnp.array([[spark.TAG_START_TTS, 11, 23, 7, 5]], jnp.int32)
    modality = jnp.full_like(tokens, spark.MOD_TEXT)
    modality = modality.at[0, 0].set(spark.MOD_TAG)
    mask = jnp.ones_like(tokens)
    return tokens, modality, mask


def _plain_greedy(params, cfg, tokens, modality, mask, n):
    toks, lengths = generate.greedy_spark_generate(
        params, cfg, tokens, modality, mask, max_new_tokens=n
    )
    toks = np.asarray(toks)[0]
    L = int(np.asarray(lengths)[0])
    # include the EOS itself when one was produced
    return toks[: L + 1] if L < n else toks


def _spec_tokens(out, eos):
    return out  # spec output already ends at EOS / max_new


@pytest.mark.parametrize("k", [3, 8])
def test_spec_matches_plain_greedy(setup, k):
    cfg, params = setup
    tokens, modality, mask = _prompt(cfg)
    n = 25  # not a multiple of k: exercises the tail round
    plain = _plain_greedy(params, cfg, tokens, modality, mask, n)
    out, stats = spec_decode.spec_generate_greedy(
        params, cfg, tokens, modality, mask, k=k, max_new_tokens=n
    )
    np.testing.assert_array_equal(out, plain[: len(out)])
    assert len(out) == len(plain)
    assert stats["rounds"] >= 1
    assert 0 < stats["accept_rate"] <= 1.0


def test_spec_int8_draft_is_lossless(setup):
    cfg, params = setup
    tokens, modality, mask = _prompt(cfg)
    n = 25
    plain = _plain_greedy(params, cfg, tokens, modality, mask, n)
    q8 = rwkv7.pack_decode_params(params, cfg.backbone, quantize_int8=True)
    out, stats = spec_decode.spec_generate_greedy(
        params, cfg, tokens, modality, mask,
        draft_params=q8, k=4, max_new_tokens=n,
    )
    # the draft is quantized; the OUTPUT must still be the bf16/fp32 rollout
    np.testing.assert_array_equal(out, plain[: len(out)])
    assert len(out) == len(plain)


def test_collect_states_positions_match_incremental(setup):
    cfg, params = setup
    bb = cfg.backbone
    T = 6
    ids = jax.random.randint(jax.random.PRNGKey(3), (1, T), 0, cfg.text_vocab_size)
    x = params["embedding"][ids].astype(bb.dtype)

    h_col, st_col = rwkv7.forward(params, bb, inputs_embeds=x, collect_states=True)
    h_ref, st_ref = rwkv7.forward(params, bb, inputs_embeds=x, return_state=True)
    np.testing.assert_allclose(
        np.asarray(h_col), np.asarray(h_ref), atol=1e-4
    )
    # last collected position == the plain final state
    for key in ("att_x", "ffn_x", "wkv"):
        np.testing.assert_allclose(
            np.asarray(st_col[key][:, :, -1]), np.asarray(st_ref[key]), atol=1e-4
        )
    # every prefix: state at position j == final state of forward over x[:, :j+1]
    for j in (0, 2, 4):
        _, st_j = rwkv7.forward(
            params, bb, inputs_embeds=x[:, : j + 1], return_state=True
        )
        for key in ("att_x", "ffn_x", "wkv"):
            np.testing.assert_allclose(
                np.asarray(st_col[key][:, :, j]),
                np.asarray(st_j[key]),
                atol=1e-4,
                err_msg=f"{key} at position {j}",
            )


def test_spec_sampling_degenerates_to_greedy(setup):
    cfg, params = setup
    tokens, modality, mask = _prompt(cfg)
    n = 17
    plain = _plain_greedy(params, cfg, tokens, modality, mask, n)
    out, stats = spec_decode.spec_sample_generate(
        params, cfg, tokens, modality, mask,
        k=4, max_new_tokens=n, temperature=1e-6, top_k=1, top_p=1.0,
        key=jax.random.PRNGKey(7),
    )
    np.testing.assert_array_equal(out, plain[: len(out)])
    assert len(out) == len(plain)


def test_spec_sampling_matches_plain_distribution(setup):
    """The accept/residual rule must leave the sampled-token distribution
    unchanged: the empirical distribution of the 3rd generated token over
    many seeded runs matches plain sampling (total variation distance)."""
    cfg, params = setup
    tokens, modality, mask = _prompt(cfg)
    n_trials = 300
    kw = dict(temperature=1.0, top_k=4, top_p=0.9)

    plain_counts: dict = {}
    for i in range(n_trials):
        toks, lengths = generate.spark_generate(
            params, cfg, tokens, modality, mask,
            jax.random.PRNGKey(20_000 + i), max_new_tokens=3, **kw,
        )
        if int(np.asarray(lengths)[0]) < 2:
            continue  # EOS before position 2: spec runs drop these too
        t = int(np.asarray(toks)[0, 2])
        plain_counts[t] = plain_counts.get(t, 0) + 1

    spec_counts: dict = {}
    for i in range(n_trials):
        out, _ = spec_decode.spec_sample_generate(
            params, cfg, tokens, modality, mask,
            k=2, max_new_tokens=3, key=jax.random.PRNGKey(10_000 + i), **kw,
        )
        if len(out) >= 3:
            spec_counts[int(out[2])] = spec_counts.get(int(out[2]), 0) + 1

    n_spec = sum(spec_counts.values())
    n_plain = sum(plain_counts.values())
    assert n_spec > n_trials * 0.5 and n_plain > n_trials * 0.5
    support = set(plain_counts) | set(spec_counts)
    tvd = 0.5 * sum(
        abs(plain_counts.get(t, 0) / n_plain - spec_counts.get(t, 0) / n_spec)
        for t in support
    )
    assert tvd < 0.15, (tvd, plain_counts, spec_counts)


def test_select_position_gathers_per_row():
    leaf = jnp.arange(2 * 2 * 3 * 4, dtype=jnp.float32).reshape(2, 2, 3, 4)
    idx = jnp.array([0, 2])
    out = spec_decode._select_position({"x": leaf}, idx)["x"]
    np.testing.assert_array_equal(np.asarray(out[:, 0]), np.asarray(leaf[:, 0, 0]))
    np.testing.assert_array_equal(np.asarray(out[:, 1]), np.asarray(leaf[:, 1, 2]))


def test_pipeline_spec_wiring(setup):
    """SparkPipeline(spec_k=...) routes B=1 synthesis through
    spec_sample_generate with the quantized draft tree — same tokens as
    calling the module directly on the pipeline's own prompt batch."""
    from rwkvtts_tpu.infer.spark_pipeline import SparkPipeline

    cfg, params = setup

    class FakeTok:
        def encode(self, text):
            return [ord(c) % 200 + 1 for c in text][:16]

    pipe = SparkPipeline(cfg, params, FakeTok(), audio_tokenizer=None, spec_k=4)
    res = pipe.synthesize(
        "hello", global_tokens=[1, 2, 3], max_new_tokens=20, seed=3,
        temperature=1.0, top_k=8, top_p=0.9,
    )
    batch = pipe._prompt_batch(["hello"], [[1, 2, 3]], [[]], [None])
    out, stats = spec_decode.spec_sample_generate(
        pipe.params, cfg,
        jnp.asarray(batch["tokens"]), jnp.asarray(batch["modality"]),
        jnp.asarray(batch["attention_mask"]),
        key=jax.random.PRNGKey(3), draft_params=pipe.draft_params,
        k=4, max_new_tokens=20, temperature=1.0, top_k=8, top_p=0.9,
    )
    expect = out[:-1] if len(out) and int(out[-1]) == cfg.eos_token_id else out
    np.testing.assert_array_equal(res.semantic_tokens, expect)
    assert stats["rounds"] >= 1
    # batched synthesis falls back to the chunked path (no assertion crash)
    multi = pipe.synthesize(
        ["a", "b"], global_tokens=[1, 2, 3], max_new_tokens=8, seed=0
    )
    assert len(multi) == 2


def test_pipeline_spec_rejects_quantized_verifier(setup):
    from rwkvtts_tpu.infer.spark_pipeline import SparkPipeline

    cfg, params = setup
    with pytest.raises(ValueError):
        SparkPipeline(cfg, params, None, spec_k=4, quantize_int8=True)
    with pytest.raises(ValueError):
        SparkPipeline(cfg, params, None, spec_k=4, spec_draft="fp8")


def test_spec_k_cap(setup):
    """spec_k > 8 is fenced: the verify window keeps one full decode state
    per position, so its memory grows with k."""
    from rwkvtts_tpu.infer.spark_pipeline import SparkPipeline

    cfg, params = setup
    with pytest.raises(ValueError, match="spec_k > 8"):
        SparkPipeline(cfg, params, None, spec_k=16)
