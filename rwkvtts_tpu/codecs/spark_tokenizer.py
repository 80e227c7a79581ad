"""Spark-path audio tokenizer pipeline: wav -> (global, semantic) tokens and
tokens -> wav, in JAX.

The jax analogue of the reference BiCodecTokenizer
(third_party/sparktts/models/audio_tokenizer.py:28-160): BiCodec +
wav2vec2-large-xlsr-53 feature frontend (mean of hidden layers 11/14/16,
audio_tokenizer.py:89-103). The wav2vec2 encoder is loaded through
transformers' Flax port from the same model dir the reference uses.

Pretrained weights are read from a SparkTTS model dir:
    <model_dir>/BiCodec/model.safetensors + config.yaml
    <model_dir>/wav2vec2-large-xlsr-53/
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.codecs import bicodec, torch_import
from rwkvtts_tpu.utils import audio_io


def bicodec_config_from_yaml(path: Union[str, Path]) -> bicodec.BiCodecConfig:
    """Parse a BiCodec model-dir config.yaml into our config dataclass."""
    import yaml

    with open(path) as f:
        full = yaml.safe_load(f)
    c = full["audio_tokenizer"]

    def stack(d, cond=False):
        return bicodec.VocosStackConfig(
            input_channels=d["input_channels"],
            vocos_dim=d["vocos_dim"],
            vocos_intermediate_dim=d["vocos_intermediate_dim"],
            vocos_num_layers=d["vocos_num_layers"],
            out_channels=d["out_channels"],
            sample_ratios=tuple(d.get("sample_ratios", (1, 1))),
            condition_dim=d.get("condition_dim"),
            use_tanh_at_final=d.get("use_tanh_at_final", False),
        )

    m = c["mel_params"]
    return bicodec.BiCodecConfig(
        mel=bicodec.MelParams(
            sample_rate=m["sample_rate"], n_fft=m["n_fft"],
            win_length=m["win_length"], hop_length=m["hop_length"],
            mel_fmin=m["mel_fmin"], mel_fmax=m.get("mel_fmax"),
            num_mels=m["num_mels"],
        ),
        encoder=stack(c["encoder"]),
        quantizer_codebook_size=c["quantizer"]["codebook_size"],
        quantizer_codebook_dim=c["quantizer"]["codebook_dim"],
        quantizer_input_dim=c["quantizer"]["input_dim"],
        quantizer_commitment=c["quantizer"].get("commitment", 0.25),
        prenet=stack(c["prenet"]),
        postnet=stack(c["postnet"]),
        wave=bicodec.WaveGeneratorConfig(
            input_channel=c["decoder"]["input_channel"],
            channels=c["decoder"]["channels"],
            rates=tuple(c["decoder"]["rates"]),
            kernel_sizes=tuple(c["decoder"]["kernel_sizes"]),
        ),
        speaker=bicodec.SpeakerEncoderConfig(
            input_dim=c["speaker_encoder"]["input_dim"],
            out_dim=c["speaker_encoder"]["out_dim"],
            latent_dim=c["speaker_encoder"]["latent_dim"],
            token_num=c["speaker_encoder"]["token_num"],
            fsq_levels=tuple(c["speaker_encoder"]["fsq_levels"]),
            fsq_num_quantizers=c["speaker_encoder"]["fsq_num_quantizers"],
        ),
        ref_segment_duration=full.get("ref_segment_duration", 6.0),
        latent_hop_length=full.get("latent_hop_length", 320),
    )


class SparkAudioTokenizer:
    """wav <-> (global_tokens, semantic_tokens) for the Spark path."""

    def __init__(
        self,
        cfg: bicodec.BiCodecConfig,
        params: Dict[str, Any],
        wav2vec2=None,
        sample_rate: int = 16000,
        volume_normalize: bool = True,
    ):
        self.cfg = cfg
        self.params = params
        self.wav2vec2 = wav2vec2
        self.sample_rate = sample_rate
        self.volume_normalize = volume_normalize
        self._detok = jax.jit(
            lambda p, s, g: bicodec.detokenize(p, cfg, s, g)
        )
        self._tok = jax.jit(lambda p, f, r: bicodec.tokenize(p, cfg, f, r))

    @classmethod
    def from_pretrained(cls, model_dir: Union[str, Path], **kw) -> "SparkAudioTokenizer":
        model_dir = Path(model_dir)
        cfg = bicodec_config_from_yaml(model_dir / "BiCodec" / "config.yaml")
        sd = torch_import.load_safetensors(str(model_dir / "BiCodec" / "model.safetensors"))
        params = jax.tree.map(
            jnp.asarray, torch_import.bicodec_from_state_dict(sd, cfg)
        )
        w2v_dir = model_dir / "wav2vec2-large-xlsr-53"
        wav2vec2 = None
        if w2v_dir.exists():
            wav2vec2 = _FlaxWav2Vec2Frontend(str(w2v_dir))
        return cls(cfg, params, wav2vec2, **kw)

    # -- frontend -----------------------------------------------------------

    def extract_features(self, wavs: np.ndarray) -> jax.Array:
        """wavs: (B, T) float32 -> (B, T//320, 1024) — mean of wav2vec2
        hidden layers 11/14/16 (audio_tokenizer.py:100-103)."""
        if self.wav2vec2 is None:
            raise RuntimeError(
                "wav2vec2 frontend not loaded (tokenize requires the "
                "wav2vec2-large-xlsr-53 weights in the model dir)"
            )
        return self.wav2vec2(wavs)

    # -- public api (parity with BiCodecTokenizer) ---------------------------

    def tokenize(self, wav: Union[str, Path, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """audio -> (global_tokens (1, Q, 32), semantic_tokens (1, T))."""
        if not isinstance(wav, np.ndarray):
            wav = audio_io.load_wav(
                wav, self.sample_rate, volume_normalize=self.volume_normalize
            )
        ref = bicodec.get_ref_clip(self.cfg, wav)
        feat = self.extract_features(wav[None].astype(np.float32))
        semantic, glob = self._tok(self.params, feat, jnp.asarray(ref[None]))
        return np.asarray(glob), np.asarray(semantic)

    def detokenize(self, global_tokens: np.ndarray, semantic_tokens: np.ndarray) -> np.ndarray:
        """(B, Q, 32) x (B, T) -> wav (B, T*hop) float32."""
        if global_tokens.ndim == 2:
            global_tokens = global_tokens[:, None, :]
        wav = self._detok(
            self.params, jnp.asarray(semantic_tokens), jnp.asarray(global_tokens)
        )
        return np.asarray(wav)


class _FlaxWav2Vec2Frontend:
    """wav2vec2-large-xlsr-53 feature extractor via transformers Flax."""

    def __init__(self, model_dir: str):
        from transformers import FlaxWav2Vec2Model

        self.model = FlaxWav2Vec2Model.from_pretrained(
            model_dir, output_hidden_states=True, from_pt=True
        )

        @jax.jit
        def run(params, x):
            out = self.model.module.apply(
                {"params": params}, x, output_hidden_states=True,
                deterministic=True,
            )
            hs = out.hidden_states
            return (hs[11] + hs[14] + hs[16]) / 3

        self._run = run

    def __call__(self, wavs: np.ndarray) -> jax.Array:
        # Wav2Vec2FeatureExtractor with do_normalize: zero-mean unit-var
        x = wavs - wavs.mean(axis=-1, keepdims=True)
        x = x / np.sqrt(x.var(axis=-1, keepdims=True) + 1e-7)
        return self._run(self.model.params, jnp.asarray(x))
