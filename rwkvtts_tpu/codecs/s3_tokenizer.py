"""S3 speech tokenizer (CosyVoice2's `speech_tokenizer_v2.onnx`), native JAX.

The reference runs this as an ONNX black box (third_party/cosyvoice/cli/
frontend.py:95-105: whisper 128-mel -> encoder -> 6561-way tokens @ 25 Hz).
This is a native JAX implementation of the published S3TokenizerV2
architecture (FunAudioLLM S3Tokenizer, "speech_tokenizer_v2_25hz"):

  128-bin whisper log-mel (16 kHz, n_fft 400, hop 160, 100 Hz)
  -> conv k3 s2 + gelu -> conv k3 s2 + gelu        (100 Hz -> 25 Hz)
  -> + sinusoidal positions -> pre-LN transformer blocks
  -> FSQ head: Linear(d -> 8), per-dim 3 levels    (vocab 3^8 = 6561)

Weights load from the torch `s3tokenizer` checkpoint layout
(s3_from_torch_state_dict) or from the ONNX file's initializers
(s3_from_onnx; name-mapped with strict shape checks — use `probe_onnx`
to list initializer names if a export uses different naming).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.codecs import dsp, nn
from rwkvtts_tpu.codecs.quantizers import fsq_codes_to_indices, fsq_quantize
from rwkvtts_tpu.codecs.xy_tokenizer import _tf_layer_init, _tf_stack, sinusoids

Params = Dict[str, Any]

S3_LEVELS = (3, 3, 3, 3, 3, 3, 3, 3)  # 3^8 = 6561


@dataclasses.dataclass(frozen=True)
class S3TokenizerConfig:
    n_mels: int = 128
    d_model: int = 1280
    layers: int = 12
    heads: int = 20
    ffn_dim: int = 5120
    fsq_dim: int = 8
    max_positions: int = 750  # 30 s at 25 Hz
    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 160

    @property
    def vocab_size(self) -> int:
        n = 1
        for l in S3_LEVELS:
            n *= l
        return n  # 6561


def default_config(**kw) -> S3TokenizerConfig:
    return S3TokenizerConfig(**kw)


def init_params(key, cfg: S3TokenizerConfig) -> Params:
    ks = jax.random.split(key, cfg.layers + 4)
    d = cfg.d_model
    return {
        "conv1": nn.conv1d_init(ks[0], cfg.n_mels, d, 3),
        "conv2": nn.conv1d_init(ks[1], d, d, 3),
        "layers": [
            _tf_layer_init(ks[2 + i], d, cfg.heads, cfg.ffn_dim)
            for i in range(cfg.layers)
        ],
        "ln": nn.layer_norm_init(d),
        "fsq_proj": nn.linear_init(ks[-1], d, cfg.fsq_dim),
    }


def encode_mel(p: Params, cfg: S3TokenizerConfig, mel, mask=None):
    """mel (B, T100, 128) -> (tokens (B, T25) int32, token_mask (B, T25))."""
    h = nn.gelu(nn.conv1d(p["conv1"], mel, stride=2, padding=1))
    h = nn.gelu(nn.conv1d(p["conv2"], h, stride=2, padding=1))
    T = h.shape[1]
    h = h + jnp.asarray(sinusoids(T, cfg.d_model))
    sub = mask[:, ::4][:, :T] if mask is not None else None
    h = _tf_stack(p["layers"], h, cfg.heads, sub)
    h = nn.layer_norm(p["ln"], h, eps=1e-5)
    z = nn.linear(p["fsq_proj"], h)  # (B, T25, 8)
    codes = fsq_quantize(z.astype(jnp.float32), S3_LEVELS)
    tokens = fsq_codes_to_indices(codes, S3_LEVELS).astype(jnp.int32)
    if sub is not None:
        tokens = jnp.where(sub > 0, tokens, 0)
        return tokens, sub
    return tokens, jnp.ones(tokens.shape, jnp.float32)


def log_mel(cfg: S3TokenizerConfig, wav) -> jax.Array:
    """Whisper-style 128-bin log-mel. wav (B, T) 16 kHz -> (B, T//hop, 128)."""
    from rwkvtts_tpu.codecs.xy_tokenizer import whisper_log_mel

    return whisper_log_mel(
        wav, sample_rate=cfg.sample_rate, n_fft=cfg.n_fft, hop=cfg.hop,
        n_mels=cfg.n_mels,
    )


def tokenize(p: Params, cfg: S3TokenizerConfig, wav) -> jax.Array:
    """wav (B, T) 16 kHz -> speech tokens (B, T25) @ 25 Hz."""
    mel = log_mel(cfg, wav)
    tokens, _ = encode_mel(p, cfg, mel)
    return tokens


# ---------------------------------------------------------------------------
# Weight import
# ---------------------------------------------------------------------------


def s3_from_torch_state_dict(sd, cfg: S3TokenizerConfig) -> Params:
    """Public `s3tokenizer` torch checkpoint layout -> params.

    Layer names follow whisper's ResidualAttentionBlock (attn.query/key/
    value/out, attn_ln, mlp.0/mlp.2, mlp_ln) under an `encoder.` prefix,
    with the FSQ projection under `quantizer.`."""
    from rwkvtts_tpu.codecs import torch_import as ti

    pref = "encoder." if "encoder.conv1.weight" in sd else ""
    layers = []
    for i in range(cfg.layers):
        b = f"{pref}blocks.{i}"
        layers.append(
            {
                "attn_ln": ti.layer_norm_p(sd, f"{b}.attn_ln"),
                "q": ti.linear_p(sd, f"{b}.attn.query"),
                "k": ti.linear_p(sd, f"{b}.attn.key"),
                "v": ti.linear_p(sd, f"{b}.attn.value"),
                "out": ti.linear_p(sd, f"{b}.attn.out"),
                "final_ln": ti.layer_norm_p(sd, f"{b}.mlp_ln"),
                "fc1": ti.linear_p(sd, f"{b}.mlp.0"),
                "fc2": ti.linear_p(sd, f"{b}.mlp.2"),
            }
        )
    for cand in (
        "quantizer._codebook.project_down",
        "quantizer.project_down",
        f"{pref}proj",
    ):
        if f"{cand}.weight" in sd:
            fsq = ti.linear_p(sd, cand)
            break
    else:
        raise KeyError("FSQ projection not found in state_dict")
    return {
        "conv1": ti.conv1d_p(sd, f"{pref}conv1"),
        "conv2": ti.conv1d_p(sd, f"{pref}conv2"),
        "layers": layers,
        "ln": ti.layer_norm_p(sd, f"{pref}ln_post"),
        "fsq_proj": fsq,
    }


def probe_onnx(path: str):
    """List (name, shape) of every initializer in an ONNX export — the
    mapping aid for s3_from_onnx on unseen exports."""
    from rwkvtts_tpu.utils import onnx_import

    ws = onnx_import.load_onnx_initializers(path)
    return sorted((k, tuple(v.shape)) for k, v in ws.items())


def s3_from_onnx(path: str, cfg: S3TokenizerConfig) -> Params:
    """speech_tokenizer_v2.onnx -> params.

    ONNX exports keep the torch module names in initializer names
    (e.g. 'encoder.blocks.0.attn.query.weight'); strip any 'onnx::'
    duplicates and defer to the torch-layout mapping. Raises with the
    probe listing when names do not match."""
    from rwkvtts_tpu.utils import onnx_import

    sd = onnx_import.load_onnx_initializers(path)
    try:
        p = s3_from_torch_state_dict(sd, cfg)
    except KeyError as e:
        names = "\n".join(f"  {k}: {tuple(v.shape)}" for k, v in sorted(sd.items())[:80])
        raise KeyError(
            f"s3_from_onnx: unmapped initializer names ({e}); "
            f"first initializers:\n{names}"
        ) from e
    return jax.tree.map(jnp.asarray, p)
