"""Smoke test on the GPU: the main paths at the full width of the 0.4B-class
Spark LM (hidden 1024, 24 layers), with random weights from a seed.

    python chip_smoke.py          # phases 1-4 on one card
    python chip_smoke.py --four   # only the four-card comparisons

Phases, each printing one line with its result and seconds:
  1. device   JAX's default backend must be a GPU (no CPU fallback, no
              interpreter); prints the card, versions and nvidia-smi's
              name and power limit.
  2. decode   infer/generate.spark_generate at B=64, 128-token prompts,
              256 new tokens, top-k 50 / top-p 0.95: tok/s (median of 5),
              then prefill + 16 decode steps through the carried state
              (fp32 and bf16 carry) against a float32 forward.
  3. serving  the continuous slot pool (96 slots) behind the HTTP server,
              with a random-init BiCodec decoder for token->wav: 4
              concurrent requests of different lengths, each wav checked.
  4. train    3 steps of the train step train/cli.py builds, B=8 x T=2048
              packed documents: finite loss, step time, peak memory.
With --four, only: one train step on a dp=2 x fsdp=2 and on a fsdp=2 x tp=2
mesh against the same step on one card, and the --dp 4 slot pool's first
step against the one-card pool's.

Any failure exits non-zero. The last line of stdout is the one JSON result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import statistics
import sys
import threading
import time
import urllib.request
import wave

import numpy as np

HIDDEN, LAYERS = 1024, 24
SEED = 0


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def report(name: str, **kv) -> None:
    print(f"  {name}: " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


# ---------------------------------------------------------------------------
# Setup shared by the phases
# ---------------------------------------------------------------------------


# Tolerances of the decode check (relative L2). The system runs bf16
# activations and matmul inputs over 24 layers against a float32 reference
# (TF32 excluded by precision="highest") that uses the same bf16-rounded
# weight values, so the weights themselves add no error; the bf16 state
# carry rounds the 64x64 WKV state to 8 mantissa bits at each of the 16
# steps. The WKV state of the deepest layers integrates the rounding of
# every layer below it, so its bound is the looser one.
def decode_tolerances():
    from rwkvtts_tpu.utils.chip_checks import Tolerance

    return {
        "logits": Tolerance(0.05, "bf16 activations (and carry) vs float32 "
                                  "reference, last-position logits"),
        "wkv": Tolerance(0.1, "bf16 activations (and carry) vs float32 "
                              "reference, final WKV state of all 24 layers"),
    }


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    import jax
    import jaxlib

    from rwkvtts_tpu.utils import chip_checks, jit_cache

    chip_checks.require_gpu()
    info = chip_checks.device_info()
    smi = chip_checks.smi_line()
    try:
        import orbax.checkpoint  # noqa: F401

        orbax = "importable"
    except ImportError:
        orbax = "not importable (checkpoints are written with numpy)"
    report("device", kind=repr(info["kind"]), count=info["count"],
           jax=jax.__version__, jaxlib=jaxlib.__version__)
    report("compile cache", dir=jit_cache.enable())
    report("orbax.checkpoint", status=orbax)
    print(f"  nvidia-smi: {smi}", flush=True)
    return info, smi


def phase_decode(hidden=HIDDEN, layers=LAYERS, batch=64, prompt=128,
                 new=256, reps=5, steps=16, rows=4):
    import jax

    from rwkvtts_tpu.infer.generate import spark_generate
    from rwkvtts_tpu.models import rwkv7, spark
    from rwkvtts_tpu.utils import chip_checks

    cfg = spark.default_config(
        hidden_size=hidden, num_layers=layers, decode_state_bf16=True
    )
    params = chip_checks.spark_params(cfg)
    pk = rwkv7.pack_decode_params(params, cfg.backbone)
    tokens, modality, mask = chip_checks.spark_prompts(batch, prompt)

    def run(seed):
        toks, _ = spark_generate(
            pk, cfg, tokens, modality, mask, jax.random.PRNGKey(seed),
            max_new_tokens=new, top_k=50, top_p=0.95, temperature=1.0,
        )
        return jax.block_until_ready(toks)

    t0 = time.perf_counter()
    toks = np.asarray(run(2))
    compile_s = time.perf_counter() - t0
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        run(3 + i)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    report("decode", batch=batch, prompt=prompt, new=new,
           tok_per_s=f"{batch * new / med:.1f}", median_s=f"{med:.4f}",
           passes_s=[round(t, 4) for t in times],
           first_call_s=f"{compile_s:.1f}")

    # parity: the timed run's own first `steps` tokens, teacher-forced
    x = spark.embed_layout(params, cfg, tokens[:rows], modality[:rows])
    step_emb = params["embedding"][np.moveaxis(toks[:rows, :steps], 0, 1)]
    tols = decode_tolerances()
    for bf16_carry in (False, True):
        bb = dataclasses.replace(cfg.backbone, decode_state_bf16=bf16_carry)
        res = chip_checks.decode_parity(
            params, bb, params["head"], x, step_emb,
            attention_mask=mask[:rows], decode_params=pk,
        )
        for what, (got, want) in res.items():
            tol = tols[what]
            err = chip_checks.check_close(
                f"decode parity {what} (bf16 carry={bf16_carry})", got, want,
                tol,
            )
            report(f"decode parity {what}",
                   state="bf16" if bf16_carry else "fp32", rows=rows,
                   steps=steps, rel_l2=f"{err:.3e}",
                   max_abs=f"{np.max(np.abs(got - want)):.3e}",
                   tol=tol.rel, reason=repr(tol.reason))
    return batch * new / med


def phase_serving(hidden=HIDDEN, layers=LAYERS, n_slots=96,
                  caps=(48, 64, 80, 96), codec_cfg=None):
    import jax
    import jax.numpy as jnp

    from rwkvtts_tpu.codecs import bicodec
    from rwkvtts_tpu.codecs.spark_tokenizer import SparkAudioTokenizer
    from rwkvtts_tpu.infer.spark_pipeline import SparkPipeline
    from rwkvtts_tpu.models import spark
    from rwkvtts_tpu.serving import http_server, launch
    from rwkvtts_tpu.utils import chip_checks
    from rwkvtts_tpu.utils.tokenizer import get_world_tokenizer

    cfg = spark.default_config(hidden_size=hidden, num_layers=layers)
    params = chip_checks.spark_params(cfg)
    # EOS logit pinned at 0 (its head column zeroed): far below the top-50
    # cut of 8193 random logits, so every request runs to its own cap and
    # its wav length is known exactly
    params["head"] = params["head"].at[:, cfg.eos_token_id].set(0)
    codec_cfg = codec_cfg or bicodec.BiCodecConfig()
    codec = SparkAudioTokenizer(
        codec_cfg, bicodec.init_params(jax.random.PRNGKey(SEED + 7), codec_cfg)
    )
    pipe = SparkPipeline(cfg, params, get_world_tokenizer(n_spct=48),
                         audio_tokenizer=codec)
    # warmup=False: admissions compile the prefill buckets they reach
    # instead of all eight at boot
    tts = launch.build_service(pipe, n_slots=n_slots, warmup=False)
    rng = np.random.default_rng(SEED)
    tts.speakers.register(
        "smoke", rng.integers(0, 4096, codec_cfg.speaker.token_num).tolist()
    )
    server, port = http_server.start_background(tts)
    texts = ["Hi.", "A short sentence for the pool.",
             "A somewhat longer sentence, so that the prompts differ.",
             "The longest request of the four, with the most text in it, "
             "for the continuous batcher to admit."]
    # wav samples per semantic token: the prenet's and the wave
    # generator's upsampling (320 at BiCodecConfig() widths: 16 kHz / 50 Hz)
    hop = int(np.prod(codec_cfg.prenet.sample_ratios)
              * np.prod(codec_cfg.wave.rates))
    outs = [None] * len(caps)

    def post(i):
        body = json.dumps({"text": texts[i % len(texts)], "speaker": "smoke",
                           "max_new_tokens": caps[i], "seed": i}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/rwkv_tts", body,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                outs[i] = (r.status, r.read())
        except Exception as e:  # noqa: BLE001 — reported below
            outs[i] = (None, repr(e).encode())

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(caps))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        tts.close()
    for i, (status, body) in enumerate(outs):
        if status != 200:
            raise AssertionError(f"request {i}: status {status}: {body[:300]!r}")
        with wave.open(io.BytesIO(body)) as w:
            n, sr = w.getnframes(), w.getframerate()
            pcm = np.frombuffer(w.readframes(n), np.int16)
        if sr != 16000 or n != caps[i] * hop:
            raise AssertionError(
                f"request {i}: {n} samples at {sr} Hz, expected "
                f"{caps[i] * hop} at 16000"
            )
        if not np.any(pcm):
            raise AssertionError(f"request {i}: silent wav")
        report("served", request=i, tokens=caps[i], samples=n, sample_rate=sr)
    report("serving", requests=len(caps), n_slots=n_slots,
           wall_s=f"{wall:.1f}")


def phase_train(hidden=HIDDEN, layers=LAYERS, batch=8, seq=2048, steps=3):
    import jax

    from rwkvtts_tpu.models import spark
    from rwkvtts_tpu.parallel import train_step as ts
    from rwkvtts_tpu.train import optimizer as opt_lib
    from rwkvtts_tpu.utils import chip_checks

    cfg = spark.default_config(hidden_size=hidden, num_layers=layers)
    params = chip_checks.spark_params(cfg, bf16_tables=False)
    tx = opt_lib.build_optimizer(params)
    state = ts.init_train_state(params, tx)
    step = ts.make_train_step(cfg, tx)
    b = chip_checks.spark_packed_batch(batch, seq, seed=SEED)
    n_docs = int(b["resets"].sum())
    b = jax.device_put({k: jax.numpy.asarray(v) for k, v in b.items()})
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, b, jax.random.PRNGKey(i))
        loss = float(jax.block_until_ready(m["loss"]))
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"train step {i}: loss {loss}")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", 0) / 2**30
    tok = int(np.asarray(b["attention_mask"]).sum())
    med = statistics.median(times[1:])
    report("train", batch=batch, seq=seq, docs=n_docs,
           losses=[round(x, 4) for x in losses],
           step_s=[round(t, 4) for t in times],
           steady_step_s=f"{med:.4f}", tokens_per_s=f"{tok / med:.1f}",
           peak_gib=f"{peak:.2f}")


# Tolerances of the four-card comparisons (relative L2).
def four_tolerances():
    from rwkvtts_tpu.utils.chip_checks import Tolerance

    return {
        "loss": Tolerance(2e-3, "bf16 compute; sharded reductions sum in "
                                "another order"),
        "update": Tolerance(0.3, "AdamW's first step is lr*sign(g): a bf16 "
                                 "gradient entry near zero can flip sign "
                                 "with the summation order and move a full "
                                 "step the other way; a wrong collective "
                                 "flips most entries (error ~1)"),
        "logits": Tolerance(1e-2, "slot-pool rows are independent; only "
                                  "the reduction order of sharded matmuls "
                                  "differs"),
    }


def phase_four(hidden=HIDDEN, layers=LAYERS, batch=8, seq=1024, n_slots=8,
               prompt=64):
    import jax
    import jax.numpy as jnp

    from rwkvtts_tpu.models import rwkv7, spark
    from rwkvtts_tpu.parallel import mesh as mesh_lib
    from rwkvtts_tpu.utils import chip_checks

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four needs 4 devices, JAX sees {len(devs)}")
    tol = four_tolerances()
    cfg = spark.default_config(hidden_size=hidden, num_layers=layers)
    params = chip_checks.spark_params(cfg, bf16_tables=False)
    b = chip_checks.spark_packed_batch(batch, seq, seed=SEED)
    key = jax.random.PRNGKey(3)
    old = jax.tree.map(np.asarray, params)
    delta = lambda p: jax.tree.map(lambda n, o: n - o, p, old)
    base_loss, base_gn, base_p = chip_checks.train_step_once(cfg, params, b, key)
    base_d = delta(base_p)
    for shape in ({"dp": 2, "fsdp": 2}, {"fsdp": 2, "tp": 2}):
        mesh = mesh_lib.make_mesh(**shape)
        used = sorted(d.id for d in mesh.devices.flat)
        if used != sorted(d.id for d in devs[:4]):
            raise AssertionError(f"mesh {shape} uses devices {used}")
        loss, gn, p = chip_checks.train_step_once(cfg, params, b, key, mesh=mesh)
        e_loss = chip_checks.check_close(
            f"loss {shape}", np.float64(loss), np.float64(base_loss), tol["loss"]
        )
        e_u = chip_checks.tree_rel_err(delta(p), base_d)
        if not e_u <= tol["update"].rel:
            raise AssertionError(
                f"update {shape}: relative error {e_u:.3e} > "
                f"{tol['update'].rel} ({tol['update'].reason})"
            )
        e_p = chip_checks.tree_rel_err(p, base_p)
        report("train step vs one card", mesh=shape, devices=used,
               loss=f"{loss:.6f}", one_card_loss=f"{base_loss:.6f}",
               loss_rel=f"{e_loss:.2e}", grad_norm=f"{gn:.4f}",
               one_card_grad_norm=f"{base_gn:.4f}",
               update_rel=f"{e_u:.2e}", params_rel=f"{e_p:.2e}")

    dparams = rwkv7.pack_decode_params(
        jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x,
                     params),
        cfg.backbone,
    )
    tokens, modality, mask = chip_checks.spark_prompts(n_slots, prompt, seed=5)
    prompts = [
        {"tokens": np.asarray(tokens[i:i + 1]),
         "modality": np.asarray(modality[i:i + 1]),
         "attention_mask": np.asarray(mask[i:i + 1])}
        for i in range(n_slots)
    ]
    one_logits, one_toks = chip_checks.pool_first_step(
        dparams, cfg, prompts, n_slots
    )
    dp_logits, dp_toks = chip_checks.pool_first_step(
        dparams, cfg, prompts, n_slots, mesh=mesh_lib.make_mesh(dp=4)
    )
    err = chip_checks.check_close("dp=4 pool logits", dp_logits, one_logits,
                                  tol["logits"])
    if not np.array_equal(dp_toks, one_toks):
        raise AssertionError(f"dp=4 pool tokens {dp_toks} vs {one_toks}")
    report("dp=4 pool vs one card", slots=n_slots, logits_rel=f"{err:.2e}",
           tokens_equal=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card comparisons")
    args = ap.parse_args(argv)

    from rwkvtts_tpu.utils import chip_checks

    with phase("device"):
        info, smi = phase_device()
    if args.four:
        with phase("four"):
            phase_four()
    else:
        with phase("decode"):
            phase_decode()
        with phase("serving"):
            phase_serving()
        with phase("train"):
            phase_train()
    print(f"card: {smi}", flush=True)
    print(chip_checks.result_line(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
