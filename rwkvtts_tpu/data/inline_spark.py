"""Inline-tokenization Spark training data path.

Reference parity: train_spark_rwkv7speech_multiple_dataset.py (T4) —
training directly from webdataset tars, running BiCodec tokenization
inline per batch instead of consuming pre-extracted JSONL. Here the
codec runs as its own jitted program per batch; rank-local sharding comes
from the tar split (data/webdataset.stream_tars).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from rwkvtts_tpu.data import spark_collator


def make_inline_spark_collate(
    audio_tokenizer,  # codecs.spark_tokenizer.SparkAudioTokenizer
    text_tokenizer,
    eos_id: int,
    *,
    pad_to: Optional[int] = None,
    packed: bool = False,
    collate_fn: Callable = spark_collator.collate_plain,
) -> Callable[[Sequence[Dict[str, Any]]], Dict[str, np.ndarray]]:
    """Wraps a spark collator so rows carrying raw {audio, text} are
    tokenized through BiCodec on the fly."""

    def collate(rows: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        token_rows: List[Dict[str, Any]] = []
        for r in rows:
            if "semantic_tokens" in r:
                token_rows.append(r)
                continue
            glob, sem = audio_tokenizer.tokenize(np.asarray(r["audio"], np.float32))
            row = dict(r)
            row["global_tokens"] = glob.reshape(-1).tolist()
            row["semantic_tokens"] = sem.reshape(-1).tolist()
            token_rows.append(row)
        return collate_fn(
            token_rows, tokenizer=text_tokenizer, eos_id=eos_id,
            pad_to=pad_to, packed=packed,
        )

    return collate
