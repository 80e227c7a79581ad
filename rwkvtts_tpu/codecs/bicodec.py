"""BiCodec (SparkTTS audio codec), JAX implementation.

Token <-> waveform codec for the Spark path:
  * semantic tokens: FactorizedVQ over wav2vec2 features, 8192 codes @ 50 Hz
  * global (speaker) tokens: ECAPA-TDNN -> perceiver -> ResidualFSQ,
    32 tokens/utterance, 4096 ids (levels [4]^6)

Behavioral parity sources (reference, /root/reference):
  * assembly + tokenize/detokenize: third_party/sparktts/models/bicodec.py:31-221
  * mel frontend:                   bicodec.py:init_mel_transformer (torchaudio,
                                    power=1, slaney/slaney)
  * encoder/decoder(prenet/postnet):third_party/sparktts/modules/encoder_decoder/
  * speaker encoder:                third_party/sparktts/modules/speaker/
  * ECAPA-TDNN:                     .../speaker/ecapa_tdnn.py (GLOB_c512: channels
                                    512, global-context ASTP)

Everything is channels-last (B, T, C), functional, jittable; intended for
inference (the codec ships pretrained — the reference never trains it), with
the VQ training losses available via quantizers.factorized_vq_forward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.codecs import dsp, nn, quantizers

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MelParams:
    sample_rate: int = 16000
    n_fft: int = 1024
    win_length: int = 640
    hop_length: int = 320
    mel_fmin: float = 10.0
    mel_fmax: Optional[float] = None
    num_mels: int = 128


@dataclasses.dataclass(frozen=True)
class VocosStackConfig:
    """Shared shape of the Encoder / Decoder(prenet/postnet) modules."""

    input_channels: int
    vocos_dim: int
    vocos_intermediate_dim: int
    vocos_num_layers: int
    out_channels: int
    sample_ratios: Tuple[int, ...] = (1, 1)
    condition_dim: Optional[int] = None
    use_tanh_at_final: bool = False


@dataclasses.dataclass(frozen=True)
class WaveGeneratorConfig:
    input_channel: int = 1024
    channels: int = 1536
    rates: Tuple[int, ...] = (8, 5, 4, 2)
    kernel_sizes: Tuple[int, ...] = (16, 11, 8, 4)
    d_out: int = 1


@dataclasses.dataclass(frozen=True)
class SpeakerEncoderConfig:
    input_dim: int = 128  # mel bins
    out_dim: int = 1024
    latent_dim: int = 128
    token_num: int = 32
    fsq_levels: Tuple[int, ...] = (4, 4, 4, 4, 4, 4)
    fsq_num_quantizers: int = 1
    ecapa_channels: int = 512


@dataclasses.dataclass(frozen=True)
class BiCodecConfig:
    mel: MelParams = MelParams()
    encoder: VocosStackConfig = VocosStackConfig(1024, 384, 2048, 12, 1024)
    quantizer_codebook_size: int = 8192
    quantizer_codebook_dim: int = 8
    quantizer_input_dim: int = 1024
    quantizer_commitment: float = 0.25
    prenet: VocosStackConfig = VocosStackConfig(
        1024, 384, 2048, 12, 1024, condition_dim=1024
    )
    postnet: VocosStackConfig = VocosStackConfig(1024, 384, 2048, 6, 128)
    wave: WaveGeneratorConfig = WaveGeneratorConfig()
    speaker: SpeakerEncoderConfig = SpeakerEncoderConfig()
    ref_segment_duration: float = 6.0
    latent_hop_length: int = 320


# ---------------------------------------------------------------------------
# Encoder / Decoder (Vocos stacks with sampling blocks)


def _vocos_stack_init(key, cfg: VocosStackConfig, is_encoder: bool) -> Params:
    ks = jax.random.split(key, 3 + 2 * len(cfg.sample_ratios))
    p: Params = {}
    if is_encoder:
        p["backbone"] = nn.vocos_backbone_init(
            ks[0], cfg.input_channels, cfg.vocos_dim,
            cfg.vocos_intermediate_dim, cfg.vocos_num_layers,
        )
        p["project"] = nn.linear_init(ks[1], cfg.vocos_dim, cfg.out_channels)
    else:
        p["linear_pre"] = nn.linear_init(ks[0], cfg.input_channels, cfg.vocos_dim)
        p["backbone"] = nn.vocos_backbone_init(
            ks[1], cfg.vocos_dim, cfg.vocos_dim,
            cfg.vocos_intermediate_dim, cfg.vocos_num_layers,
            cond_dim=cfg.condition_dim,
        )
        p["linear"] = nn.linear_init(ks[2], cfg.vocos_dim, cfg.out_channels)
    p["samplers"] = []
    for i, r in enumerate(cfg.sample_ratios):
        kb, kv = jax.random.split(ks[3 + i])
        p["samplers"].append(
            {
                "block": nn.sampling_block_init(
                    kb, cfg.vocos_dim, groups=cfg.vocos_dim,
                    downsample_scale=r if is_encoder else 1,
                    upsample_scale=r if not is_encoder else 1,
                ),
                "vocos": nn.vocos_backbone_init(
                    kv, cfg.vocos_dim, cfg.vocos_dim,
                    cfg.vocos_intermediate_dim, 2,
                ),
            }
        )
    return p


def encoder_apply(p: Params, cfg: VocosStackConfig, x) -> jax.Array:
    """x: (B, T, input_channels) [wav2vec2 feats] -> (B, T', out_channels)."""
    x = nn.vocos_backbone(p["backbone"], x)
    for s, r in zip(p["samplers"], cfg.sample_ratios):
        x = nn.sampling_block(s["block"], x, cfg.vocos_dim, groups=cfg.vocos_dim,
                              downsample_scale=r)
        x = nn.vocos_backbone(s["vocos"], x)
    return nn.linear(p["project"], x)


def decoder_apply(p: Params, cfg: VocosStackConfig, x, cond=None) -> jax.Array:
    """The reference's `Decoder` (prenet/postnet): (B, T, in) -> (B, T', out)."""
    x = nn.linear(p["linear_pre"], x)
    for s, r in zip(p["samplers"], cfg.sample_ratios):
        x = nn.sampling_block(s["block"], x, cfg.vocos_dim, groups=cfg.vocos_dim,
                              upsample_scale=r)
        x = nn.vocos_backbone(s["vocos"], x)
    x = nn.vocos_backbone(p["backbone"], x, cond)
    x = nn.linear(p["linear"], x)
    if cfg.use_tanh_at_final:
        x = jnp.tanh(x)
    return x


# ---------------------------------------------------------------------------
# Wave generator (DAC-style HiFi-GAN decoder)


def _residual_unit_init(key, dim, dilation):
    k1, k2 = jax.random.split(key)
    return {
        "snake1": nn.snake_init(dim),
        "conv1": nn.conv1d_init(k1, dim, dim, 7),
        "snake2": nn.snake_init(dim),
        "conv2": nn.conv1d_init(k2, dim, dim, 1),
    }


def _residual_unit(p, x, dilation):
    y = nn.snake(p["snake1"], x)
    y = nn.conv1d(p["conv1"], y, dilation=dilation,
                  padding=((7 - 1) * dilation) // 2)
    y = nn.snake(p["snake2"], y)
    y = nn.conv1d(p["conv2"], y, padding=0)
    return x + y


def wave_generator_init(key, cfg: WaveGeneratorConfig) -> Params:
    n = len(cfg.rates)
    ks = jax.random.split(key, n + 2)
    p: Params = {
        "conv_in": nn.conv1d_init(ks[0], cfg.input_channel, cfg.channels, 7, std=0.02),
        "blocks": [],
    }
    out_dim = cfg.channels
    for i, (ksz, stride) in enumerate(zip(cfg.kernel_sizes, cfg.rates)):
        in_dim = cfg.channels // 2**i
        out_dim = cfg.channels // 2 ** (i + 1)
        kk = jax.random.split(ks[i + 1], 4)
        p["blocks"].append(
            {
                "snake": nn.snake_init(in_dim),
                "up": nn.conv_transpose1d_init(kk[0], in_dim, out_dim, ksz),
                "res": [
                    _residual_unit_init(kk[1 + j], out_dim, d)
                    for j, d in enumerate((1, 3, 9))
                ],
            }
        )
    p["snake_out"] = nn.snake_init(out_dim)
    p["conv_out"] = nn.conv1d_init(ks[-1], out_dim, cfg.d_out, 7, std=0.02)
    return p


def wave_generator_apply(p: Params, cfg: WaveGeneratorConfig, x) -> jax.Array:
    """x: (B, T, input_channel) -> wav (B, T * prod(rates))."""
    x = nn.conv1d(p["conv_in"], x, padding=3)
    for blk, (ksz, stride) in zip(p["blocks"], zip(cfg.kernel_sizes, cfg.rates)):
        x = nn.snake(blk["snake"], x)
        x = nn.conv_transpose1d(blk["up"], x, stride=stride,
                                padding=(ksz - stride) // 2)
        for res, d in zip(blk["res"], (1, 3, 9)):
            x = _residual_unit(res, x, d)
    x = nn.snake(p["snake_out"], x)
    x = nn.conv1d(p["conv_out"], x, padding=3)
    return jnp.tanh(x)[..., 0]


# ---------------------------------------------------------------------------
# ECAPA-TDNN (GLOB_c512) — speaker feature extractor


def _conv_relu_bn_init(key, in_ch, out_ch, k):
    return {"conv": nn.conv1d_init(key, in_ch, out_ch, k), "bn": nn.batch_norm_init(out_ch)}


def _conv_relu_bn(p, x, padding=0, dilation=1):
    return nn.batch_norm(p["bn"], jax.nn.relu(nn.conv1d(p["conv"], x, padding=padding, dilation=dilation)))


def _se_res2block_init(key, channels, scale=8):
    ks = jax.random.split(key, 4 + scale)
    width = channels // scale
    return {
        "in": _conv_relu_bn_init(ks[0], channels, channels, 1),
        "res2": [
            {"conv": nn.conv1d_init(ks[1 + i], width, width, 3), "bn": nn.batch_norm_init(width)}
            for i in range(scale - 1)
        ],
        "out": _conv_relu_bn_init(ks[-3], channels, channels, 1),
        "se1": nn.linear_init(ks[-2], channels, 128),
        "se2": nn.linear_init(ks[-1], 128, channels),
    }


def _se_res2block(p, x, dilation, scale=8):
    res = x
    x = _conv_relu_bn(p["in"], x)
    width = x.shape[-1] // scale
    sp_list = jnp.split(x, scale, axis=-1)
    out = []
    sp = sp_list[0]
    for i, layer in enumerate(p["res2"]):
        if i >= 1:
            sp = sp + sp_list[i]
        sp = nn.conv1d(layer["conv"], sp, padding=dilation, dilation=dilation)
        sp = nn.batch_norm(layer["bn"], jax.nn.relu(sp))
        out.append(sp)
    out.append(sp_list[-1])
    x = jnp.concatenate(out, axis=-1)
    x = _conv_relu_bn(p["out"], x)
    # SE connect
    s = jnp.mean(x, axis=1)
    s = jax.nn.relu(nn.linear(p["se1"], s))
    s = jax.nn.sigmoid(nn.linear(p["se2"], s))
    x = x * s[:, None, :]
    return res + x


def ecapa_init(key, feat_dim, channels=512, embed_dim=1024):
    ks = jax.random.split(key, 8)
    cat = channels * 3
    out_channels = 512 * 3
    return {
        "layer1": _conv_relu_bn_init(ks[0], feat_dim, channels, 5),
        "layer2": _se_res2block_init(ks[1], channels),
        "layer3": _se_res2block_init(ks[2], channels),
        "layer4": _se_res2block_init(ks[3], channels),
        "conv": nn.conv1d_init(ks[4], cat, out_channels, 1),
        # global-context ASTP (GLOB variant)
        "astp1": nn.conv1d_init(ks[5], out_channels * 3, 128, 1),
        "astp2": nn.conv1d_init(ks[6], 128, out_channels, 1),
        "bn": nn.batch_norm_init(out_channels * 2),
        "linear": nn.linear_init(ks[7], out_channels * 2, embed_dim),
    }


def ecapa_apply(p: Params, x) -> Tuple[jax.Array, jax.Array]:
    """x: (B, T, feat_dim) -> (x_vector (B, embed), latent (B, T, 1536))."""
    out1 = _conv_relu_bn(p["layer1"], x, padding=2)
    out2 = _se_res2block(p["layer2"], out1, dilation=2)
    out3 = _se_res2block(p["layer3"], out2, dilation=3)
    out4 = _se_res2block(p["layer4"], out3, dilation=4)
    cat = jnp.concatenate([out2, out3, out4], axis=-1)
    latent = jax.nn.relu(nn.conv1d(p["conv"], cat, padding=0))

    # global-context attentive statistics pooling
    mean_c = jnp.mean(latent, axis=1, keepdims=True)
    std_c = jnp.sqrt(jnp.var(latent, axis=1, keepdims=True) + 1e-7)
    T = latent.shape[1]
    x_in = jnp.concatenate(
        [latent, jnp.broadcast_to(mean_c, latent.shape), jnp.broadcast_to(std_c, latent.shape)],
        axis=-1,
    )
    alpha = jnp.tanh(nn.conv1d(p["astp1"], x_in, padding=0))
    alpha = jax.nn.softmax(nn.conv1d(p["astp2"], alpha, padding=0), axis=1)
    mean = jnp.sum(alpha * latent, axis=1)
    var = jnp.sum(alpha * latent**2, axis=1) - mean**2
    std = jnp.sqrt(jnp.clip(var, 1e-7))
    stats = jnp.concatenate([mean, std], axis=-1)
    xv = nn.linear(p["linear"], nn.batch_norm(p["bn"], stats))
    return xv, latent


# ---------------------------------------------------------------------------
# Speaker encoder (ECAPA -> perceiver -> ResidualFSQ -> project)


def speaker_encoder_init(key, cfg: SpeakerEncoderConfig) -> Params:
    ks = jax.random.split(key, 4)
    return {
        "ecapa": ecapa_init(ks[0], cfg.input_dim, cfg.ecapa_channels, cfg.out_dim),
        "perceiver": nn.perceiver_resampler_init(
            ks[1], dim=cfg.latent_dim, dim_context=512 * 3, num_latents=cfg.token_num
        ),
        "fsq": quantizers.residual_fsq_init(
            ks[2], cfg.latent_dim, cfg.fsq_levels, cfg.fsq_num_quantizers
        ),
        "project": nn.linear_init(
            ks[3], cfg.latent_dim * cfg.token_num, cfg.out_dim
        ),
    }


def _flatten_zq(zq):
    """(B, N, D) -> (B, D*N) in the reference's channel-first flatten order
    (zq is (B, D, N) there; reshape(B, -1) walks D then N)."""
    return jnp.swapaxes(zq, 1, 2).reshape(zq.shape[0], -1)


def speaker_encoder_tokenize(p: Params, cfg: SpeakerEncoderConfig, mels) -> jax.Array:
    """mels: (B, T, num_mels) -> global token ids (B, Q, token_num)."""
    _, latent = ecapa_apply(p["ecapa"], mels)
    x = nn.perceiver_resampler(p["perceiver"], latent)  # (B, N, latent)
    _, idx = quantizers.residual_fsq_forward(
        p["fsq"], x, cfg.fsq_levels, cfg.fsq_num_quantizers
    )  # (B, N, Q)
    return jnp.swapaxes(idx, 1, 2)  # (B, Q, N) — reference layout


def speaker_encoder_detokenize(p: Params, cfg: SpeakerEncoderConfig, indices) -> jax.Array:
    """indices: (B, Q, token_num) -> d_vector (B, out_dim)."""
    idx = jnp.swapaxes(indices, 1, 2)  # (B, N, Q)
    zq = quantizers.residual_fsq_output_from_indices(
        p["fsq"], idx, cfg.fsq_levels, cfg.fsq_num_quantizers
    )
    return nn.linear(p["project"], _flatten_zq(zq))


def speaker_encoder_forward(p: Params, cfg: SpeakerEncoderConfig, mels):
    xv, latent = ecapa_apply(p["ecapa"], mels)
    x = nn.perceiver_resampler(p["perceiver"], latent)
    zq, idx = quantizers.residual_fsq_forward(
        p["fsq"], x, cfg.fsq_levels, cfg.fsq_num_quantizers
    )
    d_vector = nn.linear(p["project"], _flatten_zq(zq))
    return xv, d_vector, jnp.swapaxes(idx, 1, 2)


# ---------------------------------------------------------------------------
# BiCodec top level


def init_params(key, cfg: BiCodecConfig) -> Params:
    ks = jax.random.split(key, 6)
    return {
        "encoder": _vocos_stack_init(ks[0], cfg.encoder, is_encoder=True),
        "quantizer": quantizers.factorized_vq_init(
            ks[1], cfg.quantizer_input_dim, cfg.quantizer_codebook_size,
            cfg.quantizer_codebook_dim,
        ),
        "speaker_encoder": speaker_encoder_init(ks[2], cfg.speaker),
        "prenet": _vocos_stack_init(ks[3], cfg.prenet, is_encoder=False),
        "postnet": _vocos_stack_init(ks[4], cfg.postnet, is_encoder=False),
        "decoder": wave_generator_init(ks[5], cfg.wave),
    }


def ref_mel(cfg: BiCodecConfig, ref_wav) -> jax.Array:
    """ref_wav: (B, T) -> (B, frames, num_mels)."""
    m = cfg.mel
    return dsp.mel_spectrogram(
        ref_wav, m.sample_rate, m.n_fft, m.win_length, m.hop_length,
        m.num_mels, m.mel_fmin, m.mel_fmax, power=1.0,
    )


def tokenize(p: Params, cfg: BiCodecConfig, feat, ref_wav) -> Tuple[jax.Array, jax.Array]:
    """feat: (B, T, 1024) wav2vec2 features; ref_wav: (B, Tr) reference clip.
    Returns (semantic_tokens (B, T'), global_tokens (B, Q, 32))."""
    z = encoder_apply(p["encoder"], cfg.encoder, feat)
    semantic = quantizers.factorized_vq_tokenize(p["quantizer"], z)
    glob = speaker_encoder_tokenize(p["speaker_encoder"], cfg.speaker, ref_mel(cfg, ref_wav))
    return semantic, glob


def detokenize(p: Params, cfg: BiCodecConfig, semantic_tokens, global_tokens) -> jax.Array:
    """semantic: (B, T); global: (B, Q, 32) -> wav (B, T*hop)."""
    z_q = quantizers.factorized_vq_detokenize(p["quantizer"], semantic_tokens)
    d_vector = speaker_encoder_detokenize(p["speaker_encoder"], cfg.speaker, global_tokens)
    x = decoder_apply(p["prenet"], cfg.prenet, z_q, d_vector)
    x = x + d_vector[:, None, :]
    return wave_generator_apply(p["decoder"], cfg.wave, x)


def get_ref_clip(cfg: BiCodecConfig, wav: np.ndarray) -> np.ndarray:
    """Host-side helper mirroring BiCodecTokenizer.get_ref_clip."""
    ref_len = (
        int(cfg.mel.sample_rate * cfg.ref_segment_duration)
        // cfg.latent_hop_length * cfg.latent_hop_length
    )
    if ref_len > len(wav):
        wav = np.tile(wav, ref_len // len(wav) + 1)
    return wav[:ref_len]
