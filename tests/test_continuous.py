"""Continuous batching: slot-pool decode produces exactly the tokens an
isolated greedy generate produces, across admissions/evictions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rwkvtts_tpu.data import spark_collator
from rwkvtts_tpu.infer import generate as gen
from rwkvtts_tpu.models import spark
from rwkvtts_tpu.serving.continuous import ContinuousBatcher


class FakeTok:
    def encode(self, text):
        return [ord(c) % 200 + 1 for c in text][:12]


def _prompt(text, tok):
    s = spark_collator.build_prompt(tok.encode(text), [1, 2, 3, 4])
    return spark_collator.pad_prompts_left([s])


def test_continuous_matches_isolated_greedy():
    cfg = spark.default_config(
        hidden_size=64, num_layers=2, head_size=16, gate_lora=16,
        dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    tok = FakeTok()
    texts = [f"request number {i}" for i in range(5)]
    max_new = 12

    # isolated reference: one greedy generate per request
    expected = {}
    for i, t in enumerate(texts):
        pb = _prompt(t, tok)
        toks, lengths = gen.spark_generate(
            params, cfg, jnp.asarray(pb["tokens"]), jnp.asarray(pb["modality"]),
            jnp.asarray(pb["attention_mask"]), jax.random.PRNGKey(9),
            max_new_tokens=max_new, top_k=1, top_p=1.0,
        )
        n = int(np.asarray(lengths)[0])
        expected[i] = np.asarray(toks)[0, :n].tolist()[:max_new]

    # continuous: 5 requests through 2 slots, 4-step chunks
    cb = ContinuousBatcher(
        params, cfg, n_slots=2, chunk=4, prompt_cap=32, top_k=1,
    )
    rids = {cb.add_request(_prompt(t, tok), max_new): i for i, t in enumerate(texts)}
    out = cb.drain()
    assert len(out) == 5
    for rid, toks in out.items():
        assert toks == expected[rids[rid]], (
            f"slot decode diverged for request {rids[rid]}"
        )


def test_overlap_matches_sequential():
    """Overlap mode (dispatch chunk N+1 before syncing chunk N) returns
    token-identical results: sampling keys are pure functions of each
    request's (seed, own step index), so chunk-boundary timing and the
    one-chunk-later slot frees cannot change any draw. Exercises slot
    reuse (6 requests, 2 slots), sampled (not greedy) decoding, mixed
    per-request seeds/caps, and the stale-owner path."""
    cfg = spark.default_config(
        hidden_size=64, num_layers=2, head_size=16, gate_lora=16,
        dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    tok = FakeTok()
    texts = [f"overlap request {i}" for i in range(6)]

    def run(overlap):
        cb = ContinuousBatcher(
            params, cfg, n_slots=2, chunk=4, prompt_cap=32,
            top_k=8, top_p=0.9, overlap=overlap,
        )
        rids = {}
        for i, t in enumerate(texts):
            rids[cb.add_request(
                _prompt(t, tok), max_new_tokens=6 + 2 * (i % 3),
                temperature=1.0, seed=100 + i,
            )] = i
        out = cb.drain()
        assert cb.idle()
        return {rids[r]: toks for r, toks in out.items()}

    seq = run(overlap=False)
    ovl = run(overlap=True)
    assert seq == ovl


def test_admission_reuses_freed_slots():
    cfg = spark.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
        dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    tok = FakeTok()
    cb = ContinuousBatcher(params, cfg, n_slots=1, chunk=4, prompt_cap=32, top_k=1)
    a = cb.add_request(_prompt("one", tok), 6)
    b = cb.add_request(_prompt("two", tok), 6)
    out = cb.drain()
    assert set(out) == {a, b}
    assert all(0 < len(v) <= 6 for v in out.values())
    assert cb.idle()
    # stats counters tracked the run: both requests admitted, pool ran
    # non-empty, timing buckets accumulated
    st = cb.stats
    assert st["admitted"] == 2 and st["chunks"] >= 2
    assert 0 < st["active_rows"] <= st["chunks"] * cb.n_slots
    assert st["chunk_s"] > 0
    cb.reset_stats()
    assert cb.stats["chunks"] == 0


def test_warmup_then_serve_unchanged():
    """warmup() precompiles every program without corrupting engine state:
    results after warmup equal results without it."""
    cfg = spark.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
        dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    tok = FakeTok()

    def run(warm):
        cb = ContinuousBatcher(params, cfg, n_slots=2, chunk=4, prompt_cap=32, top_k=1)
        if warm:
            # multiple prompt widths: precompiles the 64-wide prefill the
            # long prompt below would otherwise compile at admission time
            cb.warmup(prompt_widths=[32, 64])
        rids = [cb.add_request(_prompt(t, tok), 8) for t in ("aa", "bb", "cc")]
        # a prompt past prompt_cap (40 text tokens; FakeTok caps at 12, so
        # build the row directly) exercises the doubled pad bucket
        long_row = spark_collator.build_prompt(
            [i % 150 + 1 for i in range(40)], [1, 2, 3, 4]
        )
        rids.append(
            cb.add_request(spark_collator.pad_prompts_left([long_row]), 8)
        )
        out = cb.drain()
        return [out[r] for r in rids]

    assert run(True) == run(False)


def test_capped_slot_sets_device_done_flag():
    """A slot retired by the max_new cap (no EOS sampled) must flip the
    device-side done flag so it stops burning decode work (ADVICE r2)."""
    cfg = spark.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
        dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    tok = FakeTok()
    cb = ContinuousBatcher(params, cfg, n_slots=2, chunk=4, prompt_cap=32, top_k=1)
    # random init never samples EOS in 4 tokens -> retires via cap
    rid = cb.add_request(_prompt("cap me", tok), 4)
    out = {}
    while not cb.idle():
        out.update(cb.step())
    assert rid in out and len(out[rid]) == 4
    done = np.asarray(cb._carry[2])
    assert done.all(), f"capped slot left done=False: {done}"


@pytest.mark.parametrize("state_bf16", [False, True], ids=["fp32", "bf16"])
def test_continuous_state_carry_matches_isolated_greedy(state_bf16):
    """Slot-pool parity for each decode-state carry: per-layer (L-tuple)
    wkv leaves, fp32 or bf16 (cfg.decode_state_bf16). Weights with the
    zero-initialized matrices filled, so the recurrence shapes every
    token."""
    from rwkvtts_tpu.utils import chip_checks

    cfg = spark.default_config(
        hidden_size=64, num_layers=2, head_size=16, gate_lora=16,
        dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0,
        decode_state_bf16=state_bf16,
    )
    params = chip_checks.spark_params(cfg, bf16_tables=False)
    tok = FakeTok()
    texts = [f"carry req {i}" for i in range(4)]
    max_new = 10

    expected = {}
    for i, t in enumerate(texts):
        pb = _prompt(t, tok)
        toks, lengths = gen.spark_generate(
            params, cfg, jnp.asarray(pb["tokens"]), jnp.asarray(pb["modality"]),
            jnp.asarray(pb["attention_mask"]), jax.random.PRNGKey(9),
            max_new_tokens=max_new, top_k=1, top_p=1.0,
        )
        n = int(np.asarray(lengths)[0])
        expected[i] = np.asarray(toks)[0, :n].tolist()[:max_new]

    cb = ContinuousBatcher(params, cfg, n_slots=2, chunk=4, prompt_cap=32, top_k=1)
    wkv_dtypes = {st["wkv"].dtype for st in cb._carry[1]}
    assert wkv_dtypes == {jnp.dtype(jnp.bfloat16 if state_bf16 else jnp.float32)}
    rids = {cb.add_request(_prompt(t, tok), max_new): i for i, t in enumerate(texts)}
    out = cb.drain()
    assert len(out) == 4
    for rid, toks in out.items():
        assert toks == expected[rids[rid]], (
            f"slot decode diverged for request {rids[rid]}"
        )


def test_dp_sharded_pool_matches_unsharded():
    """Slot pool sharded over a dp mesh (pod-scale serving) must produce
    exactly the tokens the single-device pool produces: decode-step math is
    batch-row-independent, so GSPMD splitting the slot axis cannot change
    results (same claim as tests/test_sharded_decode.py, at the serving
    engine level)."""
    from rwkvtts_tpu.parallel import mesh as mesh_lib

    cfg = spark.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
        dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    tok = FakeTok()
    texts = [f"sharded pool req {i}" for i in range(6)]
    max_new = 10

    def run(mesh):
        cb = ContinuousBatcher(
            params, cfg, n_slots=4, chunk=4, prompt_cap=32, top_k=1,
            mesh=mesh,
        )
        rids = {
            cb.add_request(_prompt(t, tok), max_new): i
            for i, t in enumerate(texts)
        }
        return {rids[r]: t for r, t in cb.drain().items()}

    base = run(None)
    mesh = mesh_lib.make_mesh(dp=4)
    sharded = run(mesh)
    assert sharded == base


def test_per_request_sampling_params_ride_slots():
    """Per-request temperature/top_p live in the slot carry: a near-zero-
    temperature request must reproduce the isolated greedy decode even when
    it shares the pool (and one compiled chunk program) with a hot-
    temperature request, and the hot slot must actually explore (diverge
    from greedy) — the reference's service has no per-request sampling at
    all (service/rwkv_tts_service.py)."""
    cfg = spark.default_config(
        hidden_size=64, num_layers=2, head_size=16, gate_lora=16,
        dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    tok = FakeTok()
    max_new = 12

    pb = _prompt("cold deterministic request", tok)
    toks, lengths = gen.spark_generate(
        params, cfg, jnp.asarray(pb["tokens"]), jnp.asarray(pb["modality"]),
        jnp.asarray(pb["attention_mask"]), jax.random.PRNGKey(9),
        max_new_tokens=max_new, top_k=1, top_p=1.0,
    )
    n = int(np.asarray(lengths)[0])
    greedy = np.asarray(toks)[0, :n].tolist()[:max_new]

    cb = ContinuousBatcher(
        params, cfg, n_slots=2, chunk=4, prompt_cap=32,
        top_k=0, temperature=1.0, top_p=1.0,  # pool default: full sampling
    )
    cold = cb.add_request(pb, max_new, temperature=1e-6)
    hot = cb.add_request(
        _prompt("cold deterministic request", tok), max_new, temperature=3.0
    )
    out = cb.drain()
    assert out[cold] == greedy
    assert out[hot] != greedy  # same prompt, hot slot must explore


def test_seed_determinism_across_pool_mixes():
    """A (prompt, seed) request reproduces EXACTLY no matter what else
    shares the pool: each row's sampling key is fold_in(PRNGKey(seed),
    own-step-index), independent of slot position, admission timing, and
    chunk counters. Different seeds must differ."""
    cfg = spark.default_config(
        hidden_size=64, num_layers=2, head_size=16, gate_lora=16,
        dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    tok = FakeTok()
    max_new = 10
    target = _prompt("the reproducible request", tok)

    def run(n_slots, chunk, others, seed=123):
        cb = ContinuousBatcher(
            params, cfg, n_slots=n_slots, chunk=chunk, prompt_cap=32,
            top_k=0, temperature=1.0, top_p=1.0,
        )
        # admit decoys first so the target lands in different slots with
        # different admission timing across configurations
        for i in range(others):
            cb.add_request(_prompt(f"decoy {i}", tok), max_new, seed=7 + i)
        rid = cb.add_request(target, max_new, seed=seed)
        return cb.drain()[rid]

    alone = run(n_slots=2, chunk=4, others=0)
    crowded = run(n_slots=3, chunk=5, others=4)
    assert crowded == alone, "pool cohabitation changed a seeded request"
    assert run(n_slots=2, chunk=4, others=0, seed=124) != alone


def test_dp_pool_first_step_matches_single_pool():
    """The --four comparison's helper on the virtual mesh: a dp=4 slot
    pool's first-step logits and tokens equal the one-device pool's."""
    from rwkvtts_tpu.parallel import mesh as mesh_lib
    from rwkvtts_tpu.utils import chip_checks

    cfg = spark.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
        wkv_chunk=16, remat=False, dropout=0.0,
    )
    params = chip_checks.spark_params(cfg)
    tokens, modality, mask = chip_checks.spark_prompts(8, 16, seed=5)
    prompts = [
        {"tokens": np.asarray(tokens[i:i + 1]),
         "modality": np.asarray(modality[i:i + 1]),
         "attention_mask": np.asarray(mask[i:i + 1])}
        for i in range(8)
    ]
    one_logits, one_toks = chip_checks.pool_first_step(params, cfg, prompts, 8)
    dp_logits, dp_toks = chip_checks.pool_first_step(
        params, cfg, prompts, 8, mesh=mesh_lib.make_mesh(dp=4)
    )
    assert one_logits.shape == (8, cfg.backbone.vocab_size)
    np.testing.assert_allclose(dp_logits, one_logits, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(dp_toks, one_toks)
