"""End-to-end WER ranking demonstration: the seed-eval loop distinguishes a
trained TTS system from an untrained one.

No pretrained BiCodec/whisper weights exist in this image, so absolute WER
on real speech cannot be produced here. What CAN be demonstrated — and what
the reference's eval exists for (/root/reference/eval/run_wer.py:21-28,
which ranks trained systems) — is that the full synthesize -> wav ->
transcribe -> WER pipeline is mechanically sound and MONOTONE: a model that
learned the corpus scores far lower WER than an untrained control through
the exact same harness.

Construction (every stage is the production component, sized tiny):
  * a deterministic invertible codec ("sine codec": each semantic token is
    one 20 ms sine frame; tokenize = rfft argmax) stands in for BiCodec so
    tokens survive an actual wav round trip on disk;
  * the Spark LM (models/spark.py) is trained text -> semantic tokens with
    the production collator/trainer stack;
  * the discrete ASR (models/asr.py variant='discrete', C7) is trained
    wav-tokens -> text and serves as the transcription backend via
    eval.seed_tts.evaluate_wer's injectable transcribe_fn;
  * WER math is eval.seed_tts.corpus_wer (run_wer.py:31-59 parity).
"""
from __future__ import annotations

import functools
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.data import spark_collator
from rwkvtts_tpu.eval import seed_tts
from rwkvtts_tpu.infer import generate as gen
from rwkvtts_tpu.models import asr as asr_model
from rwkvtts_tpu.models import spark
from rwkvtts_tpu.parallel import train_step as ts
from rwkvtts_tpu.train import optimizer as opt_lib
from rwkvtts_tpu.utils import audio_io

SR = 16000
FRAME = 320  # 20 ms -> 50 Hz rfft bins: token t <-> bin (t + BIN0)
BIN0 = 6  # lowest token frequency = 300 Hz
N_CODES = 64


# ---------------------------------------------------------------------------
# Sine codec: deterministic, invertible, survives wav files on disk


def sine_detokenize(tokens: Sequence[int]) -> np.ndarray:
    """tokens -> wav: one pure-tone 20 ms frame per token."""
    n = np.arange(FRAME)
    out = [
        0.5 * np.sin(2 * np.pi * (BIN0 + int(t)) * 50.0 * n / SR)
        for t in tokens
    ]
    return np.concatenate(out).astype(np.float32) if out else np.zeros(0, np.float32)


def sine_tokenize(wav: np.ndarray) -> List[int]:
    """wav -> tokens: rfft argmax per frame (exact for codec output)."""
    n_frames = len(wav) // FRAME
    toks = []
    for i in range(n_frames):
        spec = np.abs(np.fft.rfft(wav[i * FRAME : (i + 1) * FRAME]))
        toks.append(int(np.argmax(spec)) - BIN0)
    return [t for t in toks if 0 <= t < N_CODES]


# ---------------------------------------------------------------------------
# Reversible char tokenizer (so ASR decode returns real text)


class CharTok:
    def encode(self, text: str) -> List[int]:
        return [min(ord(c), 126) + 1 for c in text]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(chr(i - 1) for i in ids if i > 1)


# ---------------------------------------------------------------------------
# Synthetic corpus: 16 words, each a fixed triple of codec tokens


WORDS = (
    "cat dog sun moon tree fish bird star rain snow wind fire "
    "rock leaf wave cloud"
).split()


def word_token_table(seed: int = 7) -> Dict[str, List[int]]:
    rng = np.random.default_rng(seed)
    triples: List[Tuple[int, ...]] = []
    seen = set()
    while len(triples) < len(WORDS):
        t = tuple(rng.integers(0, N_CODES, 3).tolist())
        if t not in seen:
            seen.add(t)
            triples.append(t)
    return {w: list(t) for w, t in zip(WORDS, triples)}


def build_corpus(n_sentences: int = 16, words_per: int = 4, seed: int = 11):
    table = word_token_table()
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_sentences):
        ws = [WORDS[i] for i in rng.integers(0, len(WORDS), words_per)]
        text = " ".join(ws)
        toks = [t for w in ws for t in table[w]]
        rows.append({"text": text, "semantic_tokens": toks,
                     "global_tokens": [1, 2, 3, 4]})
    return rows


# ---------------------------------------------------------------------------
# TTS: train the Spark LM on the corpus (production stack, tiny config)


def _spark_cfg():
    return spark.default_config(
        hidden_size=64, num_layers=2, head_size=16, gate_lora=16,
        dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0,
    )


def train_tts(rows, steps: int = 400, seed: int = 0):
    cfg = _spark_cfg()
    params = spark.init_params(jax.random.PRNGKey(seed), cfg)
    tok = CharTok()
    collate = functools.partial(
        spark_collator.collate_plain, tokenizer=tok,
        eos_id=cfg.eos_token_id, pad_to=64,
    )
    batch = {k: jnp.asarray(v) for k, v in collate(rows).items()}
    tx = opt_lib.build_optimizer(
        params, total_steps=steps, peak_lr=3e-3, final_lr=3e-4, warmup_steps=10
    )
    state = ts.init_train_state(params, tx)
    step = ts.make_train_step(cfg, tx)
    key = jax.random.PRNGKey(seed + 1)
    loss = None
    for _ in range(steps):
        key, sub = jax.random.split(key)
        state, metrics = step(state, batch, sub)
        loss = metrics["loss"]
    return cfg, state.params, float(loss)


def tts_synthesize(params, cfg, text: str, out_path: str, max_tokens: int = 20):
    """text -> greedy semantic tokens -> sine-codec wav file."""
    tok = CharTok()
    prompt = spark_collator.build_prompt(tok.encode(text), [1, 2, 3, 4])
    pb = spark_collator.pad_prompts_left([prompt])
    toks, lengths = gen.spark_generate(
        params, cfg,
        jnp.asarray(pb["tokens"]), jnp.asarray(pb["modality"]),
        jnp.asarray(pb["attention_mask"]), jax.random.PRNGKey(0),
        max_new_tokens=max_tokens, top_k=1, top_p=1.0, temperature=1.0,
    )
    n = int(np.asarray(lengths)[0])
    sem = [int(t) % N_CODES for t in np.asarray(toks)[0, :n]]
    audio_io.save_wav(out_path, sine_detokenize(sem), SR)
    return sem


# ---------------------------------------------------------------------------
# ASR: train the discrete-variant model wav-tokens -> text (C7)


def _asr_cfg():
    return asr_model.default_config(
        hidden_size=64, num_layers=2, head_size=16, gate_lora=16,
        variant="discrete", dtype=jnp.float32, wkv_chunk=16, remat=False,
    )


def _asr_batch(rows, tok: CharTok, pad_audio: int = 16, pad_label: int = 32):
    """Batch for the discrete variant: audio token ids + char labels."""
    from rwkvtts_tpu.data.asr_collator import EOS_ID, HINTS, INSTRUCTIONS

    B = len(rows)
    audio = np.zeros((B, pad_audio), np.int64)
    amask = np.zeros((B, pad_audio), np.int32)
    labels = np.full((B, pad_label), -100, np.int64)
    lmask = np.zeros((B, pad_label), np.int32)
    for i, r in enumerate(rows):
        # through the REAL wav round trip, not the stored tokens
        ids = sine_tokenize(sine_detokenize(r["semantic_tokens"]))
        audio[i, : len(ids)] = ids
        amask[i, : len(ids)] = 1
        lab = tok.encode(r["text"]) + [EOS_ID]
        labels[i, : len(lab)] = lab
        lmask[i, : len(lab)] = 1
    instr = np.asarray(tok.encode(INSTRUCTIONS["en"]), np.int64)
    hints = np.asarray(tok.encode(HINTS), np.int64)
    return {
        "audio_ids": audio, "audio_mask": amask,
        "text_ids": np.tile(instr[None], (B, 1)),
        "text_mask": np.ones((B, len(instr)), np.int32),
        "hints_ids": np.tile(hints[None], (B, 1)),
        "hints_mask": np.ones((B, len(hints)), np.int32),
        "labels": labels, "labels_mask": lmask,
    }


def train_asr(rows, steps: int = 400, seed: int = 5):
    cfg = _asr_cfg()
    params = asr_model.init_params(jax.random.PRNGKey(seed), cfg)
    tok = CharTok()
    batch = {k: jnp.asarray(v) for k, v in _asr_batch(rows, tok).items()}
    tx = opt_lib.build_optimizer(
        params, total_steps=steps, peak_lr=3e-3, final_lr=3e-4, warmup_steps=10
    )
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            loss, _ = asr_model.forward(p, cfg, batch)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        import optax

        return optax.apply_updates(params, updates), opt_state, loss

    loss = None
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state)
    return cfg, params, float(loss)


def make_transcribe_fn(asr_params, asr_cfg):
    tok = CharTok()

    def fn(wav_path: str) -> str:
        wav = audio_io.load_wav(wav_path, SR)
        ids = sine_tokenize(wav) or [0]
        row = {"text": "", "semantic_tokens": ids}
        batch = {
            k: jnp.asarray(v)
            for k, v in _asr_batch([row], tok, pad_audio=max(16, len(ids))).items()
            if k not in ("labels", "labels_mask")
        }
        toks, lengths = asr_model.transcribe(
            asr_params, asr_cfg, batch, max_new_tokens=32
        )
        n = int(np.asarray(lengths)[0])
        return tok.decode([int(t) for t in np.asarray(toks)[0, :n]])

    return fn


# ---------------------------------------------------------------------------
# The ranking experiment


def run(
    n_sentences: int = 12,
    tts_steps: int = 400,
    asr_steps: int = 400,
    out_dir: Optional[str] = None,
    verbose: bool = True,
) -> Dict[str, float]:
    """Train TTS + ASR on the corpus; report WER(trained) vs WER(untrained
    control) through the identical seed-eval path. Returns both WERs."""
    rows = build_corpus(n_sentences)
    tts_cfg, tts_params, tts_loss = train_tts(rows, steps=tts_steps)
    asr_cfg, asr_params, asr_loss = train_asr(rows, steps=asr_steps)
    control_params = spark.init_params(jax.random.PRNGKey(99), _spark_cfg())
    transcribe = make_transcribe_fn(asr_params, asr_cfg)

    out_dir = out_dir or tempfile.mkdtemp(prefix="wer_ranking_")
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for name, params in (("trained", tts_params), ("untrained", control_params)):
        pairs = []
        for i, r in enumerate(rows):
            path = os.path.join(out_dir, f"{name}_{i}.wav")
            tts_synthesize(params, tts_cfg, r["text"], path,
                           max_tokens=len(r["semantic_tokens"]) + 6)
            pairs.append((path, r["text"]))
        res = seed_tts.evaluate_wer(pairs, "en", transcribe)
        results[name] = res["wer"]
        if verbose:
            print(f"WER({name}) = {res['wer']:.3f}  "
                  f"(S {res['substitutions']:.3f} D {res['deletions']:.3f} "
                  f"I {res['insertions']:.3f}, N={res['n_ref_tokens']})")
    if verbose:
        print(f"tts final loss {tts_loss:.4f} | asr final loss {asr_loss:.4f}")
        gap = results["untrained"] - results["trained"]
        print(f"ranking gap: {gap:.3f} "
              f"({'MONOTONE' if gap > 0.3 else 'NOT SEPARATED'})")
    return results


if __name__ == "__main__":
    # tiny-model CPU workload — never claim a (possibly busy) GPU; set the
    # platform before first use
    jax.config.update("jax_platforms", "cpu")
    run()
