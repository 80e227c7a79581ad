"""Spark-TTS prompt-layout collators, token-domain.

Layout contract (reference utils/multiple_jsonl.py):
  plain        [TAG2][text][TAG0][global×32][TAG1][semantic…][EOS]
               labels: -100 over prefix, then semantic+EOS        (:34-54)
  properties   SPCT prefix + same; labels additionally cover the global
               tokens (voice "design" supervision)                 (:139-233)
  global-only  predict only the global tokens                      (:313-400)
  packed       all samples of a batch in one row + segment resets  (:76-136)

Difference: the reference concatenates *embeddings* per sample on
the GPU; here everything is host-side numpy in the token domain —
(tokens, modality) pairs — and the jitted model does the table lookups
(models/spark.py embed_layout). Static output width (pad_to) keeps XLA
recompilation away; packing replaces cu_seqlens with per-position resets
consumed by the WKV kernel.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from rwkvtts_tpu.data.properties import properties_string
from rwkvtts_tpu.models.spark import (
    MOD_GLOBAL,
    MOD_PAD,
    MOD_SEMANTIC,
    MOD_TAG,
    MOD_TEXT,
    TAG_GLOBAL,
    TAG_SEMANTIC,
    TAG_START_TTS,
)

IGNORE = -100

# Persistent default rng for augmentation draws (seeded for determinism of a
# full run but advancing across batches — see collate_with_properties).
_DEFAULT_RNG = random.Random(0)


@dataclasses.dataclass
class Sample:
    """One token-domain sample: parallel (tokens, modality, labels) lists."""

    tokens: List[int]
    modality: List[int]
    labels: List[int]

    def __len__(self):
        return len(self.tokens)

    def extend(self, toks, mod, labs):
        self.tokens.extend(toks)
        self.modality.extend([mod] * len(toks))
        self.labels.extend(labs)
        return self


def _spark_core(
    text_ids: Sequence[int],
    global_tokens: Sequence[int],
    semantic_tokens: Sequence[int],
    eos_id: int,
    *,
    label_globals: bool = False,
    label_semantics: bool = True,
) -> Sample:
    s = Sample([], [], [])
    s.extend([TAG_START_TTS], MOD_TAG, [IGNORE])
    s.extend(list(text_ids), MOD_TEXT, [IGNORE] * len(text_ids))
    s.extend([TAG_GLOBAL], MOD_TAG, [IGNORE])
    g_labels = list(global_tokens) if label_globals else [IGNORE] * len(global_tokens)
    s.extend(list(global_tokens), MOD_GLOBAL, g_labels)
    s.extend([TAG_SEMANTIC], MOD_TAG, [IGNORE])
    sem = list(semantic_tokens) + [eos_id]
    sem_labels = sem if label_semantics else [IGNORE] * len(sem)
    s.extend(sem, MOD_SEMANTIC, sem_labels)
    return s


def pad_batch(
    samples: Sequence[Sample], pad_to: Optional[int] = None, pad_multiple: int = 64
) -> Dict[str, np.ndarray]:
    B = len(samples)
    maxlen = max(len(s) for s in samples)
    if pad_to is None:
        pad_to = -(-maxlen // pad_multiple) * pad_multiple
    assert pad_to >= maxlen
    tokens = np.zeros((B, pad_to), dtype=np.int32)
    modality = np.full((B, pad_to), MOD_PAD, dtype=np.int32)
    labels = np.full((B, pad_to), IGNORE, dtype=np.int32)
    mask = np.zeros((B, pad_to), dtype=np.int32)
    for i, s in enumerate(samples):
        n = len(s)
        tokens[i, :n] = s.tokens
        modality[i, :n] = s.modality
        labels[i, :n] = s.labels
        mask[i, :n] = 1
    return {
        "tokens": tokens,
        "modality": modality,
        "labels": labels,
        "attention_mask": mask,
    }


def pack_batch(
    samples: Sequence[Sample], pad_to: Optional[int] = None, pad_multiple: int = 64
) -> Dict[str, np.ndarray]:
    """All samples in one row with segment resets (the reference's
    cu_seqlens packing, utils/multiple_jsonl.py:76-136, as reset flags)."""
    total = sum(len(s) for s in samples)
    if pad_to is None:
        pad_to = -(-total // pad_multiple) * pad_multiple
    assert pad_to >= total
    tokens = np.zeros((1, pad_to), dtype=np.int32)
    modality = np.full((1, pad_to), MOD_PAD, dtype=np.int32)
    labels = np.full((1, pad_to), IGNORE, dtype=np.int32)
    mask = np.zeros((1, pad_to), dtype=np.int32)
    resets = np.zeros((1, pad_to), dtype=bool)
    off = 0
    for s in samples:
        n = len(s)
        tokens[0, off : off + n] = s.tokens
        modality[0, off : off + n] = s.modality
        # internal shift means the last label of each segment must not
        # bleed into the next segment: blank it at segment end.
        labels[0, off : off + n] = s.labels
        mask[0, off : off + n] = 1
        resets[0, off] = True
        off += n
    # With shift=True the model predicts labels[t+1] from position t; a
    # position at a segment end would predict the next segment's first
    # label. First labels are IGNORE by construction (prefix), so no leak.
    return {
        "tokens": tokens,
        "modality": modality,
        "labels": labels,
        "attention_mask": mask,
        "resets": resets,
    }


# ---------------------------------------------------------------------------
# Public collators (rows are dicts from the JSONL corpus:
# {text, global_tokens, semantic_tokens[, age, gender, emotion, pitch, speed]})
# ---------------------------------------------------------------------------


def collate_plain(rows, tokenizer, eos_id: int, pad_to=None, packed=False):
    samples = [
        _spark_core(
            tokenizer.encode(r["text"]),
            r["global_tokens"],
            r["semantic_tokens"],
            eos_id,
        )
        for r in rows
    ]
    return pack_batch(samples, pad_to) if packed else pad_batch(samples, pad_to)


def collate_with_properties(
    rows, tokenizer, eos_id: int, pad_to=None, packed=False,
    mark_phonemes_prob: float = 0.0, rng=None,
    mark_phonemes_strict: bool = True,
):
    """Two samples per row: plain + SPCT-prefixed controllable sample whose
    labels also cover the global tokens (reference multiple_jsonl.py:139-233).

    mark_phonemes_prob > 0 gives the pronunciation-controllable ft variant
    (T5 `_ipa_ft`): text is randomly phoneme-annotated via
    data/text_frontend.mark_phonemes before tokenization.

    rng defaults to a persistent module-level Random so the augmentation
    draws differ across batches; a fresh Random(0) per call would make row i
    of every batch take the same marking decision. Pass rng explicitly for
    reproducible runs."""
    rng = rng or _DEFAULT_RNG
    samples: List[Sample] = []
    for r in rows:
        text = r["text"]
        if mark_phonemes_prob > 0 and rng.random() < mark_phonemes_prob:
            from rwkvtts_tpu.data.text_frontend import mark_phonemes

            # strict by default: the ipa-ft trainer must never train on
            # letter-map fallback junk — demos/tests
            # opt out with mark_phonemes_strict=False
            text = mark_phonemes(text, rng=rng, strict=mark_phonemes_strict)
        text_ids = tokenizer.encode(text)
        samples.append(
            _spark_core(text_ids, r["global_tokens"], r["semantic_tokens"], eos_id)
        )
        props = properties_string(
            r["age"], r["gender"], r["emotion"], r["pitch"], r["speed"]
        )
        prop_ids = tokenizer.encode(props)
        s = Sample([], [], [])
        s.extend(prop_ids, MOD_TEXT, [IGNORE] * len(prop_ids))
        core = _spark_core(
            text_ids,
            r["global_tokens"],
            r["semantic_tokens"],
            eos_id,
            label_globals=True,
        )
        s.tokens += core.tokens
        s.modality += core.modality
        s.labels += core.labels
        samples.append(s)
    return pack_batch(samples, pad_to) if packed else pad_batch(samples, pad_to)


def collate_global_tokens(rows, tokenizer, eos_id: int, pad_to=None, packed=False):
    """Voice-designer variant: predict only the 32 global (speaker) tokens
    from the SPCT property prefix (reference multiple_jsonl.py:313-400)."""
    samples: List[Sample] = []
    for r in rows:
        props = properties_string(
            r["age"], r["gender"], r["emotion"], r["pitch"], r["speed"]
        )
        prop_ids = tokenizer.encode(props)
        s = Sample([], [], [])
        s.extend(prop_ids, MOD_TEXT, [IGNORE] * len(prop_ids))
        s.extend([TAG_GLOBAL], MOD_TAG, [IGNORE])
        s.extend(
            list(r["global_tokens"]), MOD_GLOBAL, list(r["global_tokens"])
        )
        s.extend([TAG_SEMANTIC], MOD_TAG, [IGNORE])
        samples.append(s)
    return pack_batch(samples, pad_to) if packed else pad_batch(samples, pad_to)


def build_prompt(
    text_ids: Sequence[int],
    global_tokens: Sequence[int],
    *,
    prompt_semantic_tokens: Sequence[int] = (),
    properties: Optional[str] = None,
    tokenizer=None,
) -> Sample:
    """Inference prompt [props?][TAG2][text][TAG0][global][TAG1][prompt_sem…]
    — decoding continues after the prompt's semantic tokens (zero-shot
    continuation; reference utils/utilities.py:170-206)."""
    s = Sample([], [], [])
    if properties is not None:
        prop_ids = tokenizer.encode(properties)
        s.extend(prop_ids, MOD_TEXT, [IGNORE] * len(prop_ids))
    s.extend([TAG_START_TTS], MOD_TAG, [IGNORE])
    s.extend(list(text_ids), MOD_TEXT, [IGNORE] * len(text_ids))
    s.extend([TAG_GLOBAL], MOD_TAG, [IGNORE])
    s.extend(list(global_tokens), MOD_GLOBAL, [IGNORE] * len(global_tokens))
    s.extend([TAG_SEMANTIC], MOD_TAG, [IGNORE])
    if prompt_semantic_tokens:
        s.extend(
            list(prompt_semantic_tokens), MOD_SEMANTIC,
            [IGNORE] * len(prompt_semantic_tokens),
        )
    return s


def pad_prompts_left(samples: Sequence[Sample], pad_to=None, pad_multiple=16):
    """Left-pad prompts for batched generation (state stays clean: leading
    pads only decay a zero state; reference inference left-pads too,
    inference/rwkv7speech_inference.py:35-67)."""
    B = len(samples)
    maxlen = max(len(s) for s in samples)
    if pad_to is None:
        pad_to = -(-maxlen // pad_multiple) * pad_multiple
    tokens = np.zeros((B, pad_to), dtype=np.int32)
    modality = np.full((B, pad_to), MOD_PAD, dtype=np.int32)
    mask = np.zeros((B, pad_to), dtype=np.int32)
    for i, s in enumerate(samples):
        n = len(s)
        tokens[i, pad_to - n :] = s.tokens
        modality[i, pad_to - n :] = s.modality
        mask[i, pad_to - n :] = 1
    return {"tokens": tokens, "modality": modality, "attention_mask": mask}
