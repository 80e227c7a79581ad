"""Signal-processing primitives: STFT/ISTFT, mel filterbanks, framing.

Pure JAX, jittable, static shapes. These replace the reference's
torchaudio.MelSpectrogram (bicodec.py:init_mel_transformer), torch.stft
inside HiFT, and kaldi fbank (cosyvoice frontend).

STFT is expressed as a matmul against precomputed DFT bases: a dense
matmul that XLA fuses with surrounding ops, at typical codec frame sizes
(n_fft <= 2048).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    n = win_length if periodic else win_length - 1
    t = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2 * math.pi * t / max(n, 1))).astype(np.float32)


def _frame(x: jax.Array, frame_length: int, hop: int) -> jax.Array:
    """x: (..., T) -> (..., n_frames, frame_length), truncating the tail."""
    T = x.shape[-1]
    n_frames = 1 + (T - frame_length) // hop
    idx = np.arange(frame_length)[None, :] + hop * np.arange(n_frames)[:, None]
    return x[..., idx]


@lru_cache(maxsize=16)
def _dft_bases(n_fft: int, win_length: int, periodic: bool = True):
    """Windowed real-DFT analysis bases (2, n_fft, n_fft//2+1) as numpy."""
    win = hann_window(win_length, periodic)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        w = np.zeros(n_fft, np.float32)
        w[pad : pad + win_length] = win
    else:
        w = win
    k = np.arange(n_fft // 2 + 1)
    t = np.arange(n_fft)
    ang = 2 * math.pi * np.outer(t, k) / n_fft
    cos_b = (np.cos(ang) * w[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * w[:, None]).astype(np.float32)
    return cos_b, sin_b


def stft(
    x: jax.Array,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    center: bool = True,
    pad_mode: str = "reflect",
) -> Tuple[jax.Array, jax.Array]:
    """x: (..., T) -> (real, imag) each (..., n_frames, n_fft//2+1).

    Matches torch.stft(center=True, window=hann, onesided=True) up to
    numerical precision.
    """
    win_length = win_length or n_fft
    if center:
        p = n_fft // 2
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(p, p)], mode=pad_mode)
    frames = _frame(x, n_fft, hop_length)
    cos_b, sin_b = _dft_bases(n_fft, win_length)
    real = frames @ jnp.asarray(cos_b)
    imag = frames @ jnp.asarray(sin_b)
    return real, imag


def istft(
    real: jax.Array,
    imag: jax.Array,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    center: bool = True,
    length: Optional[int] = None,
) -> jax.Array:
    """Inverse STFT with hann-squared overlap-add normalization.

    real/imag: (..., n_frames, n_fft//2+1) -> (..., T). Matches
    torch.istft(center=True) semantics (used by HiFT's ISTFT head).
    """
    win_length = win_length or n_fft
    win = jnp.asarray(hann_window(win_length))
    F = n_fft // 2 + 1
    k = np.arange(F)
    t = np.arange(n_fft)
    ang = 2 * math.pi * np.outer(k, t) / n_fft
    # irfft synthesis: x_t = (1/n) * [X_0 + 2*sum_mid Re(X_k e^{i2pikt/n}) + X_nyq*(-1)^t]
    w_cos = np.cos(ang).astype(np.float32)
    w_sin = -np.sin(ang).astype(np.float32)
    scale = np.full((F, 1), 2.0, np.float32)
    scale[0] = 1.0
    if n_fft % 2 == 0:
        scale[-1] = 1.0
    w_cos = w_cos * scale / n_fft
    w_sin = w_sin * scale / n_fft

    frames = real @ jnp.asarray(w_cos) + imag @ jnp.asarray(w_sin)  # (..., N, n_fft)
    frames = frames * win  # synthesis window

    n_frames = frames.shape[-2]
    T_full = n_fft + hop_length * (n_frames - 1)
    batch_shape = frames.shape[:-2]
    fr = frames.reshape((-1, n_frames, n_fft))

    idx = (np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]).reshape(-1)
    sig = jnp.zeros((fr.shape[0], T_full))
    sig = sig.at[:, idx].add(fr.reshape(fr.shape[0], -1))

    wsq = jnp.zeros((T_full,))
    wsq = wsq.at[idx].add(jnp.tile(win * win, n_frames))
    sig = sig / jnp.maximum(wsq, 1e-11)

    sig = sig.reshape(batch_shape + (T_full,))
    if center:
        p = n_fft // 2
        sig = sig[..., p : T_full - p]
    if length is not None:
        sig = sig[..., :length]
    return sig


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    safe_f = np.maximum(f, 1e-10)
    return np.where(
        f >= min_log_hz, min_log_mel + np.log(safe_f / min_log_hz) / logstep, mel
    )


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    f = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    norm: str = "slaney",
    mel_scale: str = "slaney",
) -> np.ndarray:
    """(n_fft//2+1, n_mels) slaney filterbank — matches librosa/torchaudio
    `norm="slaney", mel_scale="slaney"` (the BiCodec/HiFT/whisper setting)."""
    fmax = fmax or sample_rate / 2
    if mel_scale == "slaney":
        mels = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
        f_pts = _mel_to_hz_slaney(mels)
    else:  # htk
        def hz2mel(f):
            return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

        def mel2hz(m):
            return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

        mels = np.linspace(hz2mel(fmin), hz2mel(fmax), n_mels + 2)
        f_pts = mel2hz(mels)

    freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    fb = np.zeros((len(freqs), n_mels))
    for m in range(n_mels):
        lo, ctr, hi = f_pts[m], f_pts[m + 1], f_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb *= enorm[None, :]
    return fb.astype(np.float32)


def mel_spectrogram(
    x: jax.Array,
    sample_rate: int,
    n_fft: int,
    win_length: int,
    hop_length: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    power: float = 1.0,
    center: bool = True,
) -> jax.Array:
    """x: (..., T) -> (..., n_frames, n_mels). torchaudio-MelSpectrogram
    parity with norm=slaney, mel_scale=slaney (bicodec.py mel_params)."""
    real, imag = stft(x, n_fft, hop_length, win_length, center=center)
    mag = jnp.sqrt(real * real + imag * imag + 1e-24)
    spec = mag if power == 1.0 else mag**power
    fb = jnp.asarray(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax))
    return spec @ fb


def log_mel_hifigan(
    x: jax.Array,
    sample_rate: int = 24000,
    n_fft: int = 1920,
    win_length: int = 1920,
    hop_length: int = 480,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = 8000.0,
) -> jax.Array:
    """HiFi-GAN/matcha-style log-mel: center=False with manual reflect pad of
    (n_fft - hop)/2, magnitude spectrogram (+1e-9 floor), slaney mel,
    ln(clamp(mel, 1e-5)). x: (..., T) -> (..., frames, n_mels).

    This is the CosyVoice2 flow-prompt/HiFT feature
    (matcha.utils.audio.mel_spectrogram, configured at
    model/flow/train_sfm_flow.yaml:11-19).
    """
    pad = (n_fft - hop_length) // 2
    x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    real, imag = stft(x, n_fft, hop_length, win_length, center=False)
    mag = jnp.sqrt(real * real + imag * imag + 1e-9)
    fb = jnp.asarray(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax))
    mel = mag @ fb
    return jnp.log(jnp.clip(mel, 1e-5))
