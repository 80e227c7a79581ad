"""Batched offline generate: every row of a B=64 greedy decode equals the
same prompt decoded alone (B=1), for the spark, cosy and xy layouts. Rows
are independent in every op of the XLA decode step, so batching may not
change a single token."""
import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.infer import generate as gen
from rwkvtts_tpu.models import rwkv7
from rwkvtts_tpu.utils import chip_checks

B, T, NEW = 64, 10, 8
SMALL = dict(hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
             dtype=jnp.float32, wkv_chunk=16, remat=False)


def _mask():
    """Left padding of 0..4 positions, varying by row."""
    pad = np.arange(B) % 5
    return jnp.asarray((np.arange(T)[None, :] >= pad[:, None]).astype(np.int32))


def _params(model, cfg):
    p = model.init_params(jax.random.PRNGKey(0), cfg)
    p = chip_checks.fill_zero_init(p, jax.random.PRNGKey(1))
    return rwkv7.pack_decode_params(p, cfg.backbone)


def _check_rows(run, args):
    """run(*row_args) -> (B', NEW[, ...]) tokens; compare each row."""
    full = np.asarray(run(*args))
    assert full.shape[0] == B
    for i in range(B):
        one = np.asarray(run(*(a[i:i + 1] for a in args)))
        np.testing.assert_array_equal(one[0], full[i], err_msg=f"row {i}")


def test_spark_b64_greedy_matches_rows():
    from rwkvtts_tpu.models import spark

    cfg = spark.default_config(**SMALL)
    params = _params(spark, cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(2), (B, T), 0, 4000)
    mod = jnp.full((B, T), spark.MOD_TEXT).at[:, -1].set(spark.MOD_TAG)

    def run(tok, m, mask):
        return gen.greedy_spark_generate(
            params, cfg, tok, m, mask, max_new_tokens=NEW
        )[0]

    _check_rows(run, (tokens, mod, _mask()))


def test_cosy_b64_greedy_matches_rows():
    from rwkvtts_tpu.models import cosy

    cfg = cosy.default_config(**SMALL)
    params = _params(cosy, cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(2), (B, T), 0, 2)
    mod = jnp.full((B, T), cosy.MOD_TEXT).at[:, -1].set(cosy.MOD_SPECIAL)

    def run(tok, m, mask):
        # top_k 1 and a repetition threshold above the window (tau_r 2):
        # RAS never falls back to a random draw, so the decode is greedy
        return gen.cosy_generate(
            params, cfg, tok, m, mask, jax.random.PRNGKey(3),
            max_new_tokens=NEW, top_k=1, top_p=1.0, tau_r=2.0,
        )[0]

    _check_rows(run, (tokens, mod, _mask()))


def test_xy_b64_greedy_matches_rows():
    from rwkvtts_tpu.models import xy

    cfg = xy.default_config(**SMALL)
    params = _params(xy, cfg)
    ids = jnp.concatenate([
        jax.random.randint(jax.random.PRNGKey(2), (B, T, 1), 0, cfg.text_vocab_size),
        jax.random.randint(jax.random.PRNGKey(4), (B, T, cfg.num_channels - 1),
                           0, cfg.speech_vocab_size),
    ], axis=-1)

    def run(i, mask):
        # temperature 1e-6: every channel draw is its argmax
        return gen.xy_generate(
            params, cfg, i, mask, jax.random.PRNGKey(3),
            max_new_tokens=NEW, temperature=1e-6,
        )[0]

    _check_rows(run, (ids, _mask()))


def test_spark_early_exit_matches_fixed_length():
    """The host-chunked early-exit generate returns the fixed-length
    generate's tokens (post-EOS positions filled with EOS)."""
    from rwkvtts_tpu.models import spark

    cfg = spark.default_config(**SMALL)
    params = _params(spark, cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(5), (4, T), 0, 4000)
    mod = jnp.full((4, T), spark.MOD_TEXT).at[:, -1].set(spark.MOD_TAG)
    mask = jnp.ones((4, T), jnp.int32)
    kw = dict(max_new_tokens=NEW, top_k=1, top_p=1.0, temperature=1e-6)
    fixed, _ = gen.spark_generate(params, cfg, tokens, mod, mask,
                                  jax.random.PRNGKey(6), **kw)
    early, _ = gen.spark_generate_early_exit(
        params, cfg, tokens, mod, mask, jax.random.PRNGKey(6), chunk_len=4,
        **kw,
    )
    np.testing.assert_array_equal(np.asarray(early), np.asarray(fixed))
