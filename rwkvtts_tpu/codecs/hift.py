"""HiFT vocoder (NSF source-filter + ISTFT head), in JAX.

Behavioral parity source (/root/reference):
third_party/cosyvoice/hifigan/generator.py:43-420 — ConvRNNF0Predictor
(f0_predictor.py:19-55), SineGen/SourceModuleHnNSF (:106-220), HiFTGenerator
(:223-420): mel -> f0 -> harmonic sine source -> STFT(source) fused into the
upsampling stack -> conv_post -> (log-magnitude, phase) -> ISTFT -> wav.

Channels-last, jittable; the 24 kHz CosyVoice2 config is the default
(upsample 8x8, istft n_fft 16 hop 4 => total 256x mel hop).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.codecs import dsp, nn

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 7, 11)
    source_resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_cond_channels: int = 512

    @property
    def total_upsample(self) -> int:
        r = self.istft_hop_len
        for u in self.upsample_rates:
            r *= u
        return r


# ---------------------------------------------------------------------------
# F0 predictor (ConvRNNF0Predictor)


def f0_predictor_init(key, cfg: HiFTConfig) -> Params:
    ks = jax.random.split(key, 6)
    ch = cfg.f0_cond_channels
    return {
        "convs": [
            nn.conv1d_init(ks[0], cfg.in_channels, ch, 3),
            nn.conv1d_init(ks[1], ch, ch, 3),
            nn.conv1d_init(ks[2], ch, ch, 3),
            nn.conv1d_init(ks[3], ch, ch, 3),
            nn.conv1d_init(ks[4], ch, ch, 3),
        ],
        "classifier": nn.linear_init(ks[5], ch, 1),
    }


def f0_predict(p: Params, mel) -> jax.Array:
    """mel: (B, T, 80) -> f0 (B, T) in Hz."""
    h = mel
    for c in p["convs"]:
        h = jax.nn.elu(nn.conv1d(c, h, padding=1))
    return jnp.abs(nn.linear(p["classifier"], h))[..., 0]


# ---------------------------------------------------------------------------
# Harmonic sine source (SineGen + SourceModuleHnNSF)


def source_init(key, cfg: HiFTConfig) -> Params:
    return {"l_linear": nn.linear_init(key, cfg.nb_harmonics + 1, 1)}


def sine_source(p: Params, cfg: HiFTConfig, key, f0_up) -> jax.Array:
    """f0_up: (B, T_samples) upsampled f0 -> merged sine source (B, T, 1).

    generator.py:138-168: per-harmonic cumsum phase + random initial phase
    (zero for the fundamental), voiced/unvoiced gating with noise.
    """
    k1, k2 = jax.random.split(key)
    B, T = f0_up.shape
    H = cfg.nb_harmonics + 1
    harmonics = jnp.arange(1, H + 1, dtype=jnp.float32)
    F_mat = f0_up[:, None, :] * harmonics[None, :, None] / cfg.sampling_rate
    theta = 2 * jnp.pi * (jnp.cumsum(F_mat, axis=-1) % 1.0)
    phase = jax.random.uniform(k1, (B, H, 1), minval=-jnp.pi, maxval=jnp.pi)
    phase = phase.at[:, 0, :].set(0.0)
    sines = cfg.nsf_alpha * jnp.sin(theta + phase)

    uv = (f0_up > cfg.nsf_voiced_threshold).astype(jnp.float32)[:, None, :]
    noise_amp = uv * cfg.nsf_sigma + (1 - uv) * cfg.nsf_alpha / 3
    noise = noise_amp * jax.random.normal(k2, sines.shape)
    sines = sines * uv + noise  # (B, H, T)

    merged = nn.linear(p["l_linear"], sines.transpose(0, 2, 1))  # (B, T, 1)
    return jnp.tanh(merged)


# ---------------------------------------------------------------------------
# ResBlock (HiFiGAN/BigVGAN style with snake activations)


def _resblock_init(key, channels, kernel, dilations):
    ks = jax.random.split(key, 2 * len(dilations))
    return {
        "convs1": [nn.conv1d_init(ks[2 * i], channels, channels, kernel) for i in range(len(dilations))],
        "convs2": [nn.conv1d_init(ks[2 * i + 1], channels, channels, kernel) for i in range(len(dilations))],
        "act1": [nn.snake_init(channels) for _ in dilations],
        "act2": [nn.snake_init(channels) for _ in dilations],
    }


def _resblock(p, x, kernel, dilations):
    for i, d in enumerate(dilations):
        xt = nn.snake(p["act1"][i], x)
        xt = nn.conv1d(p["convs1"][i], xt, dilation=d, padding=(kernel * d - d) // 2)
        xt = nn.snake(p["act2"][i], xt)
        xt = nn.conv1d(p["convs2"][i], xt, padding=(kernel - 1) // 2)
        x = x + xt
    return x


# ---------------------------------------------------------------------------
# HiFT generator


def init_params(key, cfg: HiFTConfig) -> Params:
    n_up = len(cfg.upsample_rates)
    ks = iter(jax.random.split(key, 6 + 3 * n_up + len(cfg.resblock_kernel_sizes) * n_up))
    p: Params = {
        "f0_predictor": f0_predictor_init(next(ks), cfg),
        "m_source": source_init(next(ks), cfg),
        "conv_pre": nn.conv1d_init(next(ks), cfg.in_channels, cfg.base_channels, 7),
        "ups": [],
        "source_downs": [],
        "source_resblocks": [],
        "resblocks": [],
    }
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        p["ups"].append(
            nn.conv_transpose1d_init(
                next(ks), cfg.base_channels // (2**i), cfg.base_channels // (2 ** (i + 1)), k
            )
        )
    # source fusion downs: rates [1] + reversed(upsample)[:-1], cumulative
    down_rates = [1] + list(cfg.upsample_rates[::-1][:-1])
    cum = np.cumprod(down_rates)[::-1]
    nfft2 = cfg.istft_n_fft + 2
    for i, (u, k, d) in enumerate(
        zip(cum, cfg.source_resblock_kernel_sizes, cfg.source_resblock_dilation_sizes)
    ):
        ch = cfg.base_channels // (2 ** (i + 1))
        if u == 1:
            p["source_downs"].append(nn.conv1d_init(next(ks), nfft2, ch, 1))
        else:
            p["source_downs"].append(nn.conv1d_init(next(ks), nfft2, ch, int(u) * 2))
        p["source_resblocks"].append(_resblock_init(next(ks), ch, k, d))
    for i in range(n_up):
        ch = cfg.base_channels // (2 ** (i + 1))
        for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            p["resblocks"].append(_resblock_init(next(ks), ch, k, d))
    p["conv_post"] = nn.conv1d_init(next(ks), ch, nfft2, 7)
    return p


def _stft_source(cfg: HiFTConfig, s) -> jax.Array:
    """s: (B, T_samples) -> (B, frames, n_fft+2) real|imag stacked."""
    real, imag = dsp.stft(s, cfg.istft_n_fft, cfg.istft_hop_len, cfg.istft_n_fft)
    return jnp.concatenate([real, imag], axis=-1)


def decode(p: Params, cfg: HiFTConfig, mel, source) -> jax.Array:
    """mel: (B, T, 80), source: (B, T_samples) -> wav (B, T*256)."""
    s_stft = _stft_source(cfg, source)

    x = nn.conv1d(p["conv_pre"], mel, padding=3)
    n_up = len(cfg.upsample_rates)
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(n_up):
        x = nn.leaky_relu(x, cfg.lrelu_slope)
        u, k = cfg.upsample_rates[i], cfg.upsample_kernel_sizes[i]
        x = nn.conv_transpose1d(p["ups"][i], x, stride=u, padding=(k - u) // 2)
        if i == n_up - 1:
            # reflection pad (1, 0) on time
            x = jnp.concatenate([x[:, 1:2], x], axis=1)

        si = s_stft
        down_rates = [1] + list(cfg.upsample_rates[::-1][:-1])
        uu = int(np.cumprod(down_rates)[::-1][i])
        if uu == 1:
            si = nn.conv1d(p["source_downs"][i], si, padding=0)
        else:
            si = nn.conv1d(p["source_downs"][i], si, stride=uu, padding=uu // 2)
        si = _resblock(
            p["source_resblocks"][i], si,
            cfg.source_resblock_kernel_sizes[i], cfg.source_resblock_dilation_sizes[i],
        )
        L = min(x.shape[1], si.shape[1])
        x = x[:, :L] + si[:, :L]

        xs = None
        for j in range(n_k):
            r = _resblock(
                p["resblocks"][i * n_k + j], x,
                cfg.resblock_kernel_sizes[j], cfg.resblock_dilation_sizes[j],
            )
            xs = r if xs is None else xs + r
        x = xs / n_k

    x = nn.leaky_relu(x, 0.01)
    x = nn.conv1d(p["conv_post"], x, padding=3)
    F = cfg.istft_n_fft // 2 + 1
    magnitude = jnp.clip(jnp.exp(x[..., :F]), max=1e2)
    phase = jnp.sin(x[..., F:])  # reference applies sin here (generator.py:380)

    real = magnitude * jnp.cos(phase)
    imag = magnitude * jnp.sin(phase)
    wav = dsp.istft(real, imag, cfg.istft_n_fft, cfg.istft_hop_len)
    return jnp.clip(wav, -cfg.audio_limit, cfg.audio_limit)


def inference(
    p: Params, cfg: HiFTConfig, key, mel, cache_source: Optional[jax.Array] = None
) -> Tuple[jax.Array, jax.Array]:
    """mel: (B, T, 80) -> (wav (B, T*total_upsample), source).

    cache_source: (B, Ts) previous source samples for streaming glitch-free
    continuation (generator.py:407-412)."""
    f0 = f0_predict(p["f0_predictor"], mel)  # (B, T)
    f0_up = jnp.repeat(f0, cfg.total_upsample, axis=1)
    s = sine_source(p["m_source"], cfg, key, f0_up)[..., 0]  # (B, T_samples)
    if cache_source is not None and cache_source.shape[1] > 0:
        s = jax.lax.dynamic_update_slice(s, cache_source, (0, 0))
    wav = decode(p, cfg, mel, s)
    return wav, s
