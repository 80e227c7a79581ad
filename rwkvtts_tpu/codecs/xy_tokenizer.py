"""XY_Tokenizer (dual semantic+acoustic RVQ codec, nq=8 @ 12.5 Hz), in JAX.

Behavioral parity sources (/root/reference):
  * model assembly + tokenize/detokenize:
      third_party/XY_Tokenizer/xy_tokenizer/model.py:13-279
  * whisper-style encoder/decoder, adapters, up/down sampling, Vocos:
      third_party/XY_Tokenizer/xy_tokenizer/nn/modules.py
  * plain-euclidean EMA ResidualVQ:
      third_party/XY_Tokenizer/xy_tokenizer/nn/quantizer.py
  * config (shapes/rates): third_party/XY_Tokenizer/config/xy_tokenizer_config.yaml
      (16 kHz in, 24 kHz out; encoder 1280x downsample to 12.5 Hz; nq=8,
       codebook 1024)

Channels-last functional JAX; inference-first (codec ships pretrained), with
commit losses available for fine-tuning.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.codecs import dsp, nn

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    input_dim: int
    d_model: int
    output_dim: int
    layers: int
    heads: int
    ffn_dim: int
    max_positions: int = 1500


@dataclasses.dataclass(frozen=True)
class XYTokenizerConfig:
    input_sample_rate: int = 16000
    output_sample_rate: int = 24000
    n_mels: int = 80
    d_model: int = 768
    enc_layers: int = 12
    heads: int = 12
    ffn_dim: int = 3072
    adapter_layers: int = 4
    avg_pooler: int = 4  # 50 Hz -> 12.5 Hz
    nq: int = 8
    codebook_size: int = 1024
    codebook_dim: int = 512
    rvq_dim: int = 512
    quantizer_io_dim: int = 3072  # d_model * avg_pooler
    dec_layers: int = 12
    vocos_dim: int = 512
    vocos_intermediate_dim: int = 4096
    vocos_layers: int = 30
    vocos_n_fft: int = 960
    vocos_hop: int = 240  # 100 Hz -> 24 kHz

    @property
    def frame_rate(self) -> float:
        return 12.5


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper-style sinusoidal positions (modules.py:25-31)."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Whisper-style transformer layer (pre-LN, full attention over valid region)


def _tf_layer_init(key, d, heads, ffn):
    ks = jax.random.split(key, 6)
    return {
        "attn_ln": nn.layer_norm_init(d),
        "q": nn.linear_init(ks[0], d, d),
        "k": nn.linear_init(ks[1], d, d, bias=False),
        "v": nn.linear_init(ks[2], d, d),
        "out": nn.linear_init(ks[3], d, d),
        "final_ln": nn.layer_norm_init(d),
        "fc1": nn.linear_init(ks[4], d, ffn),
        "fc2": nn.linear_init(ks[5], ffn, d),
    }


def _tf_layer(p, x, heads, mask=None):
    B, T, D = x.shape
    dk = D // heads
    h = nn.layer_norm(p["attn_ln"], x, eps=1e-5)
    q = nn.linear(p["q"], h).reshape(B, T, heads, dk).transpose(0, 2, 1, 3)
    k = nn.linear(p["k"], h).reshape(B, T, heads, dk).transpose(0, 2, 1, 3)
    v = nn.linear(p["v"], h).reshape(B, T, heads, dk).transpose(0, 2, 1, 3)
    scores = jnp.einsum("bhid,bhjd->bhij", q, k) / math.sqrt(dk)
    if mask is not None:
        scores = jnp.where(mask[:, None, None, :] > 0, scores, -1e10)
    attn = jax.nn.softmax(scores, axis=-1)
    o = jnp.einsum("bhij,bhjd->bhid", attn, v).transpose(0, 2, 1, 3).reshape(B, T, D)
    x = x + nn.linear(p["out"], o)
    h = nn.layer_norm(p["final_ln"], x, eps=1e-5)
    x = x + nn.linear(p["fc2"], nn.gelu(nn.linear(p["fc1"], h)))
    return x


def _tf_stack_init(key, layers, d, heads, ffn):
    ks = jax.random.split(key, layers)
    return [_tf_layer_init(ks[i], d, heads, ffn) for i in range(layers)]


def _tf_stack(ps, x, heads, mask=None):
    for p in ps:
        x = _tf_layer(p, x, heads, mask)
    return x


# ---------------------------------------------------------------------------
# OmniAudioEncoder / Decoder / Transformer adapter


def audio_encoder_init(key, cfg: XYTokenizerConfig) -> Params:
    ks = jax.random.split(key, 3)
    d = cfg.d_model
    return {
        "conv1": nn.conv1d_init(ks[0], cfg.n_mels, d, 3),
        "conv2": nn.conv1d_init(ks[1], d, d, 3),
        "layers": _tf_stack_init(ks[2], cfg.enc_layers, d, cfg.heads, cfg.ffn_dim),
        "ln": nn.layer_norm_init(d),
    }


def audio_encoder(p: Params, cfg: XYTokenizerConfig, mel, mask=None):
    """mel: (B, T_mel, n_mels) @ 100 Hz -> (B, T_mel//2, d) @ 50 Hz."""
    h = nn.gelu(nn.conv1d(p["conv1"], mel, padding=1))
    h = nn.gelu(nn.conv1d(p["conv2"], h, stride=2, padding=1))
    T = h.shape[1]
    h = h + jnp.asarray(sinusoids(T, cfg.d_model))
    sub_mask = mask[:, ::2][:, :T] if mask is not None else None
    h = _tf_stack(p["layers"], h, cfg.heads, sub_mask)
    h = nn.layer_norm(p["ln"], h, eps=1e-5)
    if sub_mask is not None:
        h = h * sub_mask[:, :, None]
    return h


def adapter_init(key, cfg: TransformerConfig) -> Params:
    ks = jax.random.split(key, 3)
    p: Params = {
        "layers": _tf_stack_init(ks[0], cfg.layers, cfg.d_model, cfg.heads, cfg.ffn_dim),
        "ln": nn.layer_norm_init(cfg.d_model),
    }
    if cfg.input_dim != cfg.d_model:
        p["proj"] = nn.linear_init(ks[1], cfg.input_dim, cfg.d_model)
    if cfg.output_dim != cfg.d_model:
        p["out_proj"] = nn.linear_init(ks[2], cfg.d_model, cfg.output_dim)
    return p


def adapter_apply(p: Params, cfg: TransformerConfig, x, mask=None):
    """x: (B, T, input_dim) -> (B, T, output_dim)."""
    if "proj" in p:
        x = nn.linear(p["proj"], x)
    x = x + jnp.asarray(sinusoids(x.shape[1], cfg.d_model))
    x = _tf_stack(p["layers"], x, cfg.heads, mask)
    x = nn.layer_norm(p["ln"], x, eps=1e-5)
    if mask is not None:
        x = x * mask[:, :, None]
    if "out_proj" in p:
        x = nn.linear(p["out_proj"], x)
    return x


def audio_decoder_init(key, cfg: XYTokenizerConfig) -> Params:
    ks = jax.random.split(key, 3)
    d = cfg.d_model
    return {
        "layers": _tf_stack_init(ks[0], cfg.dec_layers, d, cfg.heads, cfg.ffn_dim),
        "ln": nn.layer_norm_init(d),
        "deconv1": nn.conv_transpose1d_init(ks[1], d, d, 3),
        "deconv2": nn.conv_transpose1d_init(ks[2], d, cfg.n_mels, 3),
    }


def audio_decoder(p: Params, cfg: XYTokenizerConfig, h, mask=None):
    """h: (B, T, d) @ 50 Hz -> (B, 2T, n_mels) @ 100 Hz."""
    T = h.shape[1]
    h = h + jnp.asarray(sinusoids(T, cfg.d_model))
    h = _tf_stack(p["layers"], h, cfg.heads, mask)
    h = nn.layer_norm(p["ln"], h, eps=1e-5)
    if mask is not None:
        h = h * mask[:, :, None]
    # deconv1: stride 2, no padding; deconv2: stride 1 channel map
    y = nn.gelu(nn.conv_transpose1d(p["deconv1"], h, stride=2, padding=0))
    y = nn.gelu(nn.conv_transpose1d(p["deconv2"], y, stride=1, padding=0))
    return y[:, : T * 2]


# ---------------------------------------------------------------------------
# Residual down/up sampling (SwiGLU pooling)


def down_conv_init(key, cfg: XYTokenizerConfig) -> Params:
    ks = jax.random.split(key, 3)
    d, pool = cfg.d_model, cfg.avg_pooler
    inter = d * pool
    return {
        "gate": nn.conv1d_init(ks[0], d, inter, pool, bias=False),
        "up": nn.conv1d_init(ks[1], d, inter, pool, bias=False),
        "down": nn.linear_init(ks[2], inter, inter, bias=False),
        "ln": nn.layer_norm_init(inter),
    }


def down_conv(p: Params, cfg: XYTokenizerConfig, x):
    """(B, T, d) @ 50 Hz -> (B, T//pool, d*pool) @ 12.5 Hz (modules.py:451-478)."""
    pool = cfg.avg_pooler
    B, T, D = x.shape
    pad = (-T) % pool
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad), (0, 0)))
    g = nn.conv1d(p["gate"], x, stride=pool, padding=0)
    u = nn.conv1d(p["up"], x, stride=pool, padding=0)
    res = x.reshape(B, -1, D * pool)
    c = nn.linear(p["down"], jax.nn.silu(g) * u)
    return nn.layer_norm(p["ln"], c + res, eps=1e-5)


def up_conv_init(key, cfg: XYTokenizerConfig) -> Params:
    d, s = cfg.d_model, cfg.avg_pooler
    return {"up": nn.conv_transpose1d_init(key, s * d, d, s, bias=False)}


def up_conv(p: Params, cfg: XYTokenizerConfig, x):
    """(B, T, d*s) -> (B, T*s, d)."""
    return nn.conv_transpose1d(p["up"], x, stride=cfg.avg_pooler, padding=0)


# ---------------------------------------------------------------------------
# Residual VQ (plain euclidean, EMA codebooks)


def rvq_init(key, cfg: XYTokenizerConfig) -> Params:
    ks = jax.random.split(key, cfg.nq + 2)
    p: Params = {"quantizers": []}
    if cfg.quantizer_io_dim != cfg.rvq_dim:
        p["input_proj"] = nn.linear_init(ks[-1], cfg.quantizer_io_dim, cfg.rvq_dim)
        p["output_proj"] = nn.linear_init(ks[-2], cfg.rvq_dim, cfg.quantizer_io_dim)
    for i in range(cfg.nq):
        q: Params = {"codebook": jax.random.normal(ks[i], (cfg.codebook_size, cfg.codebook_dim))}
        if cfg.rvq_dim != cfg.codebook_dim:
            kk = jax.random.split(ks[i])
            q["in_project"] = nn.linear_init(kk[0], cfg.rvq_dim, cfg.codebook_dim)
            q["out_project"] = nn.linear_init(kk[1], cfg.codebook_dim, cfg.rvq_dim)
        p["quantizers"].append(q)
    return p


def _vq_nearest(codebook, z_e):
    """Plain euclidean nearest-code lookup. z_e: (B, T, D')."""
    d = (
        jnp.sum(z_e**2, -1, keepdims=True)
        - 2 * z_e @ codebook.T
        + jnp.sum(codebook**2, -1)[None, None, :]
    )
    return jnp.argmin(d, axis=-1)


def rvq_encode(p: Params, cfg: XYTokenizerConfig, z) -> Tuple[jax.Array, jax.Array]:
    """z: (B, T, io_dim) -> (zq (B, T, io_dim), codes (nq, B, T))."""
    h = nn.linear(p["input_proj"], z) if "input_proj" in p else z
    residual = h
    out = jnp.zeros_like(h)
    codes = []
    for q in p["quantizers"]:
        z_e = nn.linear(q["in_project"], residual) if "in_project" in q else residual
        idx = _vq_nearest(q["codebook"], z_e)
        z_q = q["codebook"][idx]
        z_q = nn.linear(q["out_project"], z_q) if "out_project" in q else z_q
        residual = residual - z_q
        out = out + z_q
        codes.append(idx)
    out = nn.linear(p["output_proj"], out) if "output_proj" in p else out
    return out, jnp.stack(codes)


def rvq_decode(p: Params, cfg: XYTokenizerConfig, codes) -> jax.Array:
    """codes: (nq, B, T) -> (B, T, io_dim)."""
    nq = codes.shape[0]
    out = None
    for i in range(nq):
        q = p["quantizers"][i]
        z_q = q["codebook"][codes[i]]
        z_q = nn.linear(q["out_project"], z_q) if "out_project" in q else z_q
        out = z_q if out is None else out + z_q
    return nn.linear(p["output_proj"], out) if "output_proj" in p else out


# ---------------------------------------------------------------------------
# Vocos head (ConvNeXt backbone + ISTFT "same")


def vocos_init(key, cfg: XYTokenizerConfig) -> Params:
    k1, k2 = jax.random.split(key)
    return {
        "backbone": nn.vocos_backbone_init(
            k1, cfg.n_mels, cfg.vocos_dim, cfg.vocos_intermediate_dim, cfg.vocos_layers
        ),
        "head": nn.linear_init(k2, cfg.vocos_dim, cfg.vocos_n_fft + 2),
    }


def vocos_apply(p: Params, cfg: XYTokenizerConfig, mel) -> jax.Array:
    """mel: (B, T, n_mels) @ 100 Hz -> wav (B, T*hop) @ 24 kHz."""
    h = nn.vocos_backbone(p["backbone"], mel)
    x = nn.linear(p["head"], h)
    F = cfg.vocos_n_fft // 2 + 1
    mag = jnp.clip(jnp.exp(x[..., :F]), max=1e2)
    phase = x[..., F:]
    real = mag * jnp.cos(phase)
    imag = mag * jnp.sin(phase)
    # ISTFT padding="same": OLA then trim (win - hop)/2 each side
    pad = (cfg.vocos_n_fft - cfg.vocos_hop) // 2
    wav = dsp.istft(real, imag, cfg.vocos_n_fft, cfg.vocos_hop, center=False)
    return wav[..., pad : pad + mel.shape[1] * cfg.vocos_hop]


# ---------------------------------------------------------------------------
# Full tokenizer


def init_params(key, cfg: XYTokenizerConfig) -> Params:
    ks = jax.random.split(key, 9)
    d = cfg.d_model
    sem_adapter = TransformerConfig(d, d, d, cfg.adapter_layers, cfg.heads, cfg.ffn_dim)
    pre_adapter = TransformerConfig(2 * d, d, d, cfg.adapter_layers, cfg.heads, cfg.ffn_dim)
    post_adapter = TransformerConfig(
        cfg.quantizer_io_dim, d, cfg.quantizer_io_dim, cfg.adapter_layers, cfg.heads, cfg.ffn_dim
    )
    return {
        "semantic_encoder": audio_encoder_init(ks[0], cfg),
        "semantic_adapter": adapter_init(ks[1], sem_adapter),
        "acoustic_encoder": audio_encoder_init(ks[2], cfg),
        "pre_rvq_adapter": adapter_init(ks[3], pre_adapter),
        "downsample": down_conv_init(ks[4], cfg),
        "quantizer": rvq_init(ks[5], cfg),
        "post_rvq_adapter": adapter_init(ks[6], post_adapter),
        "upsample": up_conv_init(ks[7], cfg),
        "acoustic_decoder": audio_decoder_init(ks[8], cfg),
        "vocos": vocos_init(jax.random.fold_in(key, 99), cfg),
    }


def _adapter_cfgs(cfg: XYTokenizerConfig):
    d = cfg.d_model
    return (
        TransformerConfig(d, d, d, cfg.adapter_layers, cfg.heads, cfg.ffn_dim),
        TransformerConfig(2 * d, d, d, cfg.adapter_layers, cfg.heads, cfg.ffn_dim),
        TransformerConfig(
            cfg.quantizer_io_dim, d, cfg.quantizer_io_dim, cfg.adapter_layers, cfg.heads, cfg.ffn_dim
        ),
    )


def encode(p: Params, cfg: XYTokenizerConfig, mel, mel_mask=None) -> jax.Array:
    """mel: (B, T_mel, n_mels) whisper log-mel @ 100 Hz -> codes (nq, B, T/8)."""
    sem_cfg, pre_cfg, _ = _adapter_cfgs(cfg)
    sub = mel_mask[:, ::2] if mel_mask is not None else None
    sem = audio_encoder(p["semantic_encoder"], cfg, mel, mel_mask)
    sem = adapter_apply(p["semantic_adapter"], sem_cfg, sem, sub)
    aco = audio_encoder(p["acoustic_encoder"], cfg, mel, mel_mask)
    h = jnp.concatenate([sem, aco], axis=-1)
    h = adapter_apply(p["pre_rvq_adapter"], pre_cfg, h, sub)
    h = down_conv(p["downsample"], cfg, h)
    _, codes = rvq_encode(p["quantizer"], cfg, h)
    return codes


def decode(p: Params, cfg: XYTokenizerConfig, codes, mask=None) -> jax.Array:
    """codes: (nq, B, T) @ 12.5 Hz -> wav (B, T*1920) @ 24 kHz."""
    _, _, post_cfg = _adapter_cfgs(cfg)
    zq = rvq_decode(p["quantizer"], cfg, codes)
    h = adapter_apply(p["post_rvq_adapter"], post_cfg, zq, mask)
    h = up_conv(p["upsample"], cfg, h)
    mel = audio_decoder(p["acoustic_decoder"], cfg, h)
    return vocos_apply(p["vocos"], cfg, mel)


def whisper_log_mel(wav, sample_rate: int = 16000, n_fft: int = 400, hop: int = 160, n_mels: int = 80):
    """Whisper-style log-mel: log10(clamp(mel,1e-10)), dynamic-range clamp to
    max-8, then (x+4)/4. wav: (B, T) -> (B, T//hop, n_mels)."""
    real, imag = dsp.stft(wav, n_fft, hop, n_fft, center=True)
    real, imag = real[:, :-1], imag[:, :-1]  # whisper drops the last frame
    power = real**2 + imag**2
    fb = jnp.asarray(dsp.mel_filterbank(sample_rate, n_fft, n_mels, 0.0, None))
    mel = power @ fb
    log_spec = jnp.log10(jnp.clip(mel, 1e-10))
    log_spec = jnp.maximum(log_spec, jnp.max(log_spec, axis=(1, 2), keepdims=True) - 8.0)
    return (log_spec + 4.0) / 4.0


# ---------------------------------------------------------------------------
# Long-audio chunked encode/decode (reference model.py:131-256): audio beyond
# the encoder's positional window is processed in fixed windows stepping by
# (window - overlap), keeping the leading (window - overlap) of each chunk's
# output — the overlap serves as lookahead context.


def encode_long(
    p: Params,
    cfg: XYTokenizerConfig,
    wav,
    window_seconds: float = 30.0,
    overlap_seconds: float = 10.0,
):
    """wav: (T,) float @16 kHz of any length -> codes (nq, T_codes).

    Fixed 16 kHz window shapes (zero-padded + masked) -> one compiled
    program regardless of utterance length."""
    import numpy as np

    wav = np.asarray(wav, np.float32)
    sr = cfg.input_sample_rate
    win = int(window_seconds * sr)
    dur = int((window_seconds - overlap_seconds) * sr)
    samples_per_code = 8 * 160  # 8 mel frames (100 Hz) per 12.5 Hz code
    keep_codes = dur // samples_per_code
    total_codes = len(wav) // samples_per_code
    if len(wav) <= win:
        mel = whisper_log_mel(jnp.asarray(wav[None]), n_mels=cfg.n_mels)
        return np.asarray(encode(p, cfg, mel))[:, 0, :total_codes]
    chunks = []
    for start in range(0, len(wav), dur):
        piece = wav[start : start + win]
        n = len(piece)
        if n == 0:
            break
        buf = np.zeros(win, np.float32)
        buf[:n] = piece
        mel = whisper_log_mel(jnp.asarray(buf[None]), n_mels=cfg.n_mels)
        mask = (np.arange(mel.shape[1]) * 160 < n).astype(np.float32)[None]
        codes = np.asarray(encode(p, cfg, mel, jnp.asarray(mask)))[:, 0]
        valid = min(keep_codes, n // samples_per_code)
        if valid > 0:
            chunks.append(codes[:, :valid])
    return np.concatenate(chunks, axis=-1)[:, :total_codes]


def decode_long(
    p: Params,
    cfg: XYTokenizerConfig,
    codes,
    window_seconds: float = 30.0,
    overlap_seconds: float = 10.0,
):
    """codes (nq, T) of any length -> wav (T * out_rate/frame_rate,) @24 kHz."""
    import numpy as np

    codes = np.asarray(codes)
    win = int(window_seconds * cfg.frame_rate)
    keep = int((window_seconds - overlap_seconds) * cfg.frame_rate)
    # 8 output mel frames per code x vocos hop (1920 @24 kHz production)
    out_per_code = 8 * cfg.vocos_hop
    T = codes.shape[-1]
    if T <= win:
        return np.asarray(decode(p, cfg, jnp.asarray(codes[:, None, :])))[0]
    pieces = []
    for start in range(0, T, keep):
        piece = codes[:, start : start + win]
        n = piece.shape[-1]
        if n == 0:
            break
        buf = np.zeros((codes.shape[0], win), codes.dtype)
        buf[:, :n] = piece
        mask = (np.arange(win) < n).astype(np.float32)[None]
        wav = np.asarray(
            decode(p, cfg, jnp.asarray(buf[:, None, :]), jnp.asarray(mask))
        )[0]
        valid = min(keep, n) * out_per_code
        if valid > 0:
            pieces.append(wav[:valid])
    return np.concatenate(pieces)[: T * out_per_code]
