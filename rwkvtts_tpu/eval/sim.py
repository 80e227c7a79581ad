"""Speaker-similarity (SIM) evaluation for seed-tts-eval.

The reference lists SIM as a TODO (reference eval/README.md:14) and never
implemented it; the standard seed-tts-eval protocol scores the cosine
similarity between speaker embeddings of the synthesized utterance and the
reference prompt clip. Here the embedder is pluggable and defaults to the
in-repo native CAM++ x-vector (codecs/campplus.py) — the same model family
(3D-Speaker campplus) the community SIM evals use.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


def cosine_sim(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / denom) if denom > 0 else 0.0


@dataclasses.dataclass
class SIMResult:
    mean: float
    per_utt: List[float]
    # cohort-mean-centered scores: raw cosines between x-vector embeddings
    # saturate near 1.0 for ANY two speech clips (a shared dominant
    # embedding direction — measured 0.997 same-speaker vs 0.976
    # different-speaker on random-init CAM++, i.e. no discrimination).
    # Subtracting the eval-set mean embedding
    # removes the common component: the same probe separates to ~0.8 vs
    # ~-0.6. `mean` stays the raw-protocol number; `centered_mean` is the
    # discriminative one.
    centered_mean: float = 0.0
    per_utt_centered: Optional[List[float]] = None


def evaluate_sim(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    embed_fn: Callable[[np.ndarray], np.ndarray],
) -> SIMResult:
    """pairs: (synth_wav, prompt_wav) float32 @16 kHz; embed_fn: wav ->
    speaker embedding (e.g. the native CAM++, codecs/campplus.embed_wav)."""
    if not pairs:
        return SIMResult(0.0, [], 0.0, [])
    embs = [(embed_fn(synth), embed_fn(prompt)) for synth, prompt in pairs]
    sims = [cosine_sim(a, b) for a, b in embs]
    mu = np.mean([e for ab in embs for e in ab], axis=0)
    cent = [cosine_sim(a - mu, b - mu) for a, b in embs]
    return SIMResult(
        mean=float(np.mean(sims)), per_utt=sims,
        centered_mean=float(np.mean(cent)), per_utt_centered=cent,
    )


def discriminability(
    same_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    diff_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    embed_fn: Callable[[np.ndarray], np.ndarray],
) -> dict:
    """Sanity check that the SIM metric as wired can actually discriminate:
    same-speaker pairs must score above different-speaker pairs (on the
    centered score). Returns the two means and the gap."""
    all_pairs = list(same_pairs) + list(diff_pairs)
    embs = [(embed_fn(a), embed_fn(b)) for a, b in all_pairs]
    mu = np.mean([e for ab in embs for e in ab], axis=0)
    cent = [cosine_sim(a - mu, b - mu) for a, b in embs]
    n = len(same_pairs)
    same_mean = float(np.mean(cent[:n])) if n else 0.0
    diff_mean = float(np.mean(cent[n:])) if len(cent) > n else 0.0
    return {
        "same_mean": same_mean,
        "diff_mean": diff_mean,
        "gap": same_mean - diff_mean,
        "discriminates": same_mean > diff_mean,
    }


def campplus_embed_fn(params, cfg=None):
    """Build an embed_fn from native CAM++ params (codecs/campplus.py)."""
    import jax.numpy as jnp

    from rwkvtts_tpu.codecs import campplus as cp

    cfg = cfg or cp.CampplusConfig()

    def fn(wav: np.ndarray) -> np.ndarray:
        return np.asarray(cp.embed_wav(params, cfg, jnp.asarray(wav)[None]))[0]

    return fn
