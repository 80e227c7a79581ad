"""Incremental-state streaming: chunked early-exit LM decode, bounded-window
flow hops, HiFT mel/source caches + crossfade (reference cli/model.py:330-446)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rwkvtts_tpu.codecs import conformer, flow as flow_lib, hift as hift_lib
from rwkvtts_tpu.infer import generate as gen
from rwkvtts_tpu.infer import streaming
from rwkvtts_tpu.infer.cosy_pipeline import CosyPipeline
from rwkvtts_tpu.models import cosy


class FakeTok:
    def encode(self, text):
        return [ord(c) % 200 + 1 for c in text][:8]


@pytest.fixture(scope="module")
def pipe():
    lm_cfg = cosy.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
        dtype=jnp.float32, wkv_chunk=16, remat=False,
    )
    lm_params = cosy.init_params(jax.random.PRNGKey(0), lm_cfg)
    fcfg = flow_lib.FlowConfig(
        input_size=24, output_size=16, spk_embed_dim=12, vocab_size=6562,
        encoder=conformer.UpsampleConformerConfig(
            input_size=24, output_size=24, attention_heads=2,
            linear_units=48, num_blocks=1, num_up_blocks=1,
        ),
        estimator=flow_lib.EstimatorConfig(
            in_channels=16 * 4, out_channels=16, channels=(16,),
            n_blocks=1, num_mid_blocks=1, num_heads=2, attention_head_dim=8,
            causal=True, static_chunk_size=2,
        ),
        n_timesteps=2,
    )
    fparams = flow_lib.init_params(jax.random.PRNGKey(1), fcfg)
    hcfg = hift_lib.HiFTConfig(
        in_channels=16, base_channels=32, nb_harmonics=2,
        upsample_rates=(4, 3), upsample_kernel_sizes=(8, 7),
        istft_n_fft=16, istft_hop_len=4,
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
        source_resblock_kernel_sizes=(7, 7),
        source_resblock_dilation_sizes=((1, 2), (1, 2)),
        f0_cond_channels=16,
    )
    hparams = hift_lib.init_params(jax.random.PRNGKey(2), hcfg)
    return CosyPipeline(
        lm_cfg, lm_params, FakeTok(),
        flow_cfg=fcfg, flow_params=fparams,
        hift_cfg=hcfg, hift_params=hparams,
    )


def test_chunked_decode_matches_fixed_scan(pipe):
    """One chunk of length N with the same key reproduces cosy_generate's
    N-step scan exactly (same step fn, same key split)."""
    tok = FakeTok()
    text_ids = tok.encode("hello")
    from rwkvtts_tpu.data import cosy_collator
    from rwkvtts_tpu.data.spark_collator import pad_prompts_left

    sample = cosy_collator.build_prompt(text_ids, [])
    batch = pad_prompts_left([sample])
    args = (
        jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["modality"]),
        jnp.asarray(batch["attention_mask"]),
    )
    key = jax.random.PRNGKey(7)
    toks_full, _ = gen.cosy_generate(
        pipe.lm_params, pipe.lm_cfg, *args, key,
        max_new_tokens=12, min_new_tokens=2,
    )
    carry = gen.cosy_prefill_carry(pipe.lm_params, pipe.lm_cfg, *args)
    _, toks_chunk, done = gen.cosy_decode_chunk(
        pipe.lm_params, pipe.lm_cfg, carry, key,
        chunk_len=12, min_new_tokens=2,
    )
    np.testing.assert_array_equal(np.asarray(toks_full), np.asarray(toks_chunk))
    assert done.shape == (1,)


def test_chunked_decode_early_exit(pipe):
    """Post-EOS chunks would just pad with EOS; the host loop stops instead."""
    tok = FakeTok()
    from rwkvtts_tpu.data import cosy_collator
    from rwkvtts_tpu.data.spark_collator import pad_prompts_left

    sample = cosy_collator.build_prompt(tok.encode("a"), [])
    batch = pad_prompts_left([sample])
    args = (
        jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["modality"]),
        jnp.asarray(batch["attention_mask"]),
    )
    carry = gen.cosy_prefill_carry(pipe.lm_params, pipe.lm_cfg, *args)
    key = jax.random.PRNGKey(0)
    n_chunks = 0
    for i in range(16):
        key, sub = jax.random.split(key)
        carry, toks, done = gen.cosy_decode_chunk(
            pipe.lm_params, pipe.lm_cfg, carry, sub, chunk_len=8
        )
        n_chunks += 1
        if bool(np.asarray(done)[0]):
            break
    # random tiny model: EOS id is sampleable, should stop well before 16
    assert n_chunks <= 16


def test_flow_window_matches_full_prefix(pipe):
    """With the window covering the entire prefix (gen_start=0, no pad),
    inference_window reproduces inference() bit-for-bit — the positional
    noise and every op are identical."""
    fcfg = pipe.flow_cfg
    rng = np.random.default_rng(0)
    P, G = 4, 6
    tokens = jnp.asarray(rng.integers(0, 100, (1, P + G)))
    mask = jnp.ones((1, P + G), jnp.float32)
    prompt_mel = jnp.asarray(
        rng.standard_normal((1, 2 * P, fcfg.output_size)).astype(np.float32)
    )
    spk = jnp.asarray(rng.standard_normal((1, 12)).astype(np.float32))
    key = jax.random.PRNGKey(3)

    full = flow_lib.inference(
        pipe.flow_params, fcfg, key, tokens, mask, prompt_mel, 2 * P, spk,
        n_timesteps=2,
    )
    win = flow_lib.inference_window(
        pipe.flow_params, fcfg, key, tokens, mask, prompt_mel,
        P, jnp.int32(0), spk, n_timesteps=2,
    )
    np.testing.assert_allclose(
        np.asarray(full), np.asarray(win[:, 2 * P :]), rtol=0, atol=1e-5
    )


def test_stream_synthesize_end_to_end(pipe):
    scfg = streaming.StreamConfig(
        token_hop_len=4, ctx_tokens=4, mel_cache_len=2, n_timesteps=2,
        lm_chunk=4,
    )
    chunks = list(
        streaming.stream_synthesize(
            pipe, "hello streaming", stream_cfg=scfg, max_new_tokens=24,
        )
    )
    assert len(chunks) >= 1
    wav = np.concatenate(chunks)
    assert np.isfinite(wav).all()
    up = pipe.hift_cfg.total_upsample
    # emitted sample count == total mel frames * upsample (nothing lost or
    # duplicated across hop/cache/fade boundaries)
    assert len(wav) % up == 0
    n_frames = len(wav) // up
    assert n_frames % pipe.flow_cfg.token_mel_ratio == 0


@pytest.fixture(scope="module")
def sfm_pipe(pipe):
    """Same tiny stack but with an SFM-headed flow (cfg.sfm=True)."""
    import dataclasses

    fcfg = dataclasses.replace(pipe.flow_cfg, sfm=True)
    fparams = flow_lib.init_params(jax.random.PRNGKey(11), fcfg)
    lm_params = cosy.init_params(jax.random.PRNGKey(0), pipe.lm_cfg)
    return CosyPipeline(
        pipe.lm_cfg, lm_params, FakeTok(),
        flow_cfg=fcfg, flow_params=fparams,
        hift_cfg=pipe.hift_cfg, hift_params=pipe.hift_params,
    )


def test_sfm_window_matches_full_prefix(sfm_pipe):
    """With the window covering the entire prefix (gen_start=0, no pad),
    sfm_inference_window reproduces sfm_inference bit-for-bit — both use
    the counter-based positional noise."""
    fcfg = sfm_pipe.flow_cfg
    rng = np.random.default_rng(5)
    P, G = 4, 6
    tokens = jnp.asarray(rng.integers(0, 100, (1, P + G)))
    mask = jnp.ones((1, P + G), jnp.float32)
    spk = jnp.asarray(rng.standard_normal((1, 12)).astype(np.float32))
    key = jax.random.PRNGKey(9)

    full = flow_lib.sfm_inference(
        sfm_pipe.flow_params, fcfg, key, tokens, mask, spk, n_timesteps=2
    )
    win = flow_lib.sfm_inference_window(
        sfm_pipe.flow_params, fcfg, key, tokens, mask,
        P, jnp.int32(0), spk, n_timesteps=2,
    )
    np.testing.assert_allclose(
        np.asarray(full), np.asarray(win), rtol=0, atol=1e-5
    )


def test_stream_synthesize_sfm_end_to_end(sfm_pipe):
    """Streaming with the SFM fast-decode hop (StreamConfig.sfm=True)."""
    scfg = streaming.StreamConfig(
        token_hop_len=4, ctx_tokens=4, mel_cache_len=2, n_timesteps=2,
        lm_chunk=4, sfm=True,
    )
    chunks = list(
        streaming.stream_synthesize(
            sfm_pipe, "hello sfm streaming", stream_cfg=scfg,
            max_new_tokens=24,
        )
    )
    assert len(chunks) >= 1
    wav = np.concatenate(chunks)
    assert np.isfinite(wav).all()
    up = sfm_pipe.hift_cfg.total_upsample
    assert len(wav) % up == 0


def test_stream_zero_or_short_token_case(pipe):
    """Utterance shorter than one hop: single finalize chunk, correct length."""
    scfg = streaming.StreamConfig(
        token_hop_len=32, ctx_tokens=8, mel_cache_len=2, n_timesteps=2,
        lm_chunk=8,
    )
    chunks = list(
        streaming.stream_synthesize(
            pipe, "x", stream_cfg=scfg, max_new_tokens=6,
        )
    )
    wav = np.concatenate(chunks) if chunks else np.zeros(0)
    assert np.isfinite(wav).all()


def test_prefetch_token_parity(pipe):
    """lm_prefetch dispatches chunk N+1 early but splits keys in the same
    order — the emitted wav must be bit-identical to the sequential loop."""
    kw = dict(token_hop_len=4, ctx_tokens=4, mel_cache_len=2, n_timesteps=2,
              lm_chunk=4)
    wavs = []
    for prefetch in (False, True):
        scfg = streaming.StreamConfig(lm_prefetch=prefetch, **kw)
        wavs.append(np.concatenate(list(streaming.stream_synthesize(
            pipe, "hello prefetch", stream_cfg=scfg, max_new_tokens=24,
        ))))
    assert wavs[0].shape == wavs[1].shape
    np.testing.assert_array_equal(wavs[0], wavs[1])


def test_vocode_every_batches_hift_calls(pipe):
    """vocode_every=K: same LM/flow path (total samples preserved), but
    the steady-state HiFT call count drops — first hop still vocodes
    immediately (TTFA unchanged)."""
    kw = dict(token_hop_len=4, ctx_tokens=4, mel_cache_len=2, n_timesteps=2,
              lm_chunk=4)
    calls = {}
    wavs = {}
    orig = streaming.CosyStreamSession._vocode
    for K in (1, 3):
        n = 0

        def counting(self, mel, finalize=False):
            nonlocal n
            n += 1
            return orig(self, mel, finalize=finalize)

        streaming.CosyStreamSession._vocode = counting
        try:
            scfg = streaming.StreamConfig(vocode_every=K, **kw)
            wavs[K] = np.concatenate(list(streaming.stream_synthesize(
                pipe, "hello batching", stream_cfg=scfg, max_new_tokens=24,
            )))
        finally:
            streaming.CosyStreamSession._vocode = orig
        calls[K] = n
    # same audio duration (crossfade seams differ, so not bit-identical)
    assert wavs[1].shape == wavs[3].shape
    assert calls[3] < calls[1]
    assert np.isfinite(wavs[3]).all()


def test_hop_ramp_parity_and_fewer_flow_calls(pipe):
    """hop_max ramp: flow hop doubles per chunk — total samples match the
    fixed-hop stream, flow call count drops, first chunk (TTFA) is still
    the base hop's size."""
    kw = dict(token_hop_len=4, ctx_tokens=4, mel_cache_len=2, n_timesteps=2,
              lm_chunk=4)
    orig = streaming.CosyStreamSession._window_mel
    calls = {}
    wavs = {}
    firsts = {}
    for hop_max in (None, 16):
        n = 0

        def counting(self, tokens, off, n_new):
            nonlocal n
            n += 1
            return orig(self, tokens, off, n_new)

        streaming.CosyStreamSession._window_mel = counting
        try:
            scfg = streaming.StreamConfig(hop_max=hop_max, **kw)
            chunks = list(streaming.stream_synthesize(
                pipe, "hello ramp", stream_cfg=scfg, max_new_tokens=24,
            ))
        finally:
            streaming.CosyStreamSession._window_mel = orig
        wavs[hop_max] = np.concatenate(chunks)
        firsts[hop_max] = len(chunks[0])
        calls[hop_max] = n
    assert wavs[None].shape == wavs[16].shape
    assert calls[16] < calls[None]
    assert firsts[16] == firsts[None]  # TTFA chunk unchanged
    assert np.isfinite(wavs[16]).all()


def test_lm_chunk_ramp_streams_complete_audio(pipe):
    """lm_chunk_max (bigger LM dispatches after first audio) must deliver
    the same complete frame-aligned stream contract as the fixed chunk —
    and fewer LM dispatches. Token draws differ by design (per-dispatch
    key splits), so this checks the contract, not sample parity."""
    calls = {"n": 0}
    orig = streaming.gen.cosy_decode_chunk

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    streaming.gen.cosy_decode_chunk = counting
    try:
        def run(lm_chunk_max):
            calls["n"] = 0
            scfg = streaming.StreamConfig(
                token_hop_len=4, ctx_tokens=4, mel_cache_len=2,
                n_timesteps=2, lm_chunk=4, lm_chunk_max=lm_chunk_max,
            )
            chunks = list(
                streaming.stream_synthesize(
                    pipe, "hello ramping", stream_cfg=scfg,
                    max_new_tokens=24,
                )
            )
            wav = np.concatenate(chunks)
            return wav, calls["n"]

        wav_fixed, n_fixed = run(None)
        wav_ramp, n_ramp = run(12)
        for wav in (wav_fixed, wav_ramp):
            assert np.isfinite(wav).all()
            up = pipe.hift_cfg.total_upsample
            assert len(wav) % up == 0
        assert n_ramp < n_fixed
    finally:
        streaming.gen.cosy_decode_chunk = orig


def test_stream_session_tokens_match_offline_generate(pipe, monkeypatch):
    """The streaming session's LM decode (XLA path, one chunk covering the
    whole utterance) emits exactly the tokens offline cosy_generate emits
    for the same prompt, key and min/max length."""
    from rwkvtts_tpu.data import cosy_collator
    from rwkvtts_tpu.data.spark_collator import pad_prompts_left

    seen = []
    orig = streaming.CosyStreamSession.emit_ready

    def spy(self, tokens, lm_done):
        seen.append(np.array(tokens))
        return orig(self, tokens, lm_done)

    monkeypatch.setattr(streaming.CosyStreamSession, "emit_ready", spy)
    text, seed, n = "offline parity", 3, 32
    scfg = streaming.StreamConfig(
        token_hop_len=4, ctx_tokens=4, mel_cache_len=2, n_timesteps=2,
        lm_chunk=n,
    )
    wav = np.concatenate(list(streaming.stream_synthesize(
        pipe, text, stream_cfg=scfg, max_new_tokens=n, seed=seed,
    )))
    assert np.isfinite(wav).all()
    streamed = seen[-1]

    text_ids = pipe.tok.encode(text)
    batch = pad_prompts_left([cosy_collator.build_prompt(text_ids, [])])
    T = batch["tokens"].shape[1]
    cap = ((T + 63) // 64) * 64
    batch = {k: np.pad(np.asarray(v), ((0, 0), (cap - T, 0)))
             for k, v in batch.items()}
    content = cosy_collator.content_length(text_ids)
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    toks, lengths = gen.cosy_generate(
        pipe.lm_params, pipe.lm_cfg, jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["modality"]), jnp.asarray(batch["attention_mask"]),
        sub, max_new_tokens=n, min_new_tokens=int(content * 2),
    )
    n_off = min(int(np.asarray(lengths)[0]), int(content * 20), n)
    np.testing.assert_array_equal(streamed, np.asarray(toks)[0, :n_off])
