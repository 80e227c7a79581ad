"""CosyVoice2-style TTS orchestrator: frontend -> RWKV LM -> flow -> HiFT.

Reference call-stack parity (SURVEY.md §3.3; third_party/cosyvoice/cli/):
  * zero-shot prompt assembly (frontend.py:164-182): prompt speech tokens +
    prompt mel + speaker embedding condition the LM and the flow
  * LM token generation (cosy_llm.py:180-261): [SOS][text][TASK][prompt_sp]
    prefill, RAS sampling, min/max length from content length
  * token2wav (cli/model.py:372-459): flow (10-step euler CFG) -> HiFT,
    non-streaming first; streaming via token hops + source cache is exposed
    through `synthesize_streaming`.

Frontend features the reference computes with ONNX models (S3 speech
tokenizer, campplus x-vector) are pluggable here: pass precomputed
prompt_speech_tokens / spk_embedding, or inject callables (e.g. an
onnxruntime wrapper when available — this image has none).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.codecs import dsp, flow as flow_lib, hift as hift_lib
from rwkvtts_tpu.data import cosy_collator
from rwkvtts_tpu.infer import generate as gen


@dataclasses.dataclass
class CosyTTSResult:
    wav: np.ndarray
    sample_rate: int
    speech_tokens: np.ndarray
    rtf: float
    llm_s: float
    flow_s: float
    vocoder_s: float


class CosyPipeline:
    def __init__(
        self,
        lm_cfg,
        lm_params,
        text_tokenizer,
        flow_cfg: Optional[flow_lib.FlowConfig] = None,
        flow_params=None,
        hift_cfg: Optional[hift_lib.HiFTConfig] = None,
        hift_params=None,
        speech_tokenizer_fn: Optional[Callable] = None,  # wav -> token ids
        spk_embed_fn: Optional[Callable] = None,  # wav -> (192,) x-vector
        s3_cfg=None,
        s3_params=None,
        campplus_cfg=None,
        campplus_params=None,
        sample_rate: int = 24000,
        quantize_int8: bool = False,
        quantize_int4: bool = False,
        fuse_projections: bool = True,
        sample_rank_bf16: bool = False,
    ):
        from rwkvtts_tpu.models import rwkv7

        self.lm_cfg = lm_cfg
        # opt-in int8/int4 LM decode weights (quality probe:
        # scripts/measure_int8_quality.py [--int4]). fuse_projections=False
        # drops the doubled fused projection copies — the B=1
        # weight-bandwidth lever (pack_decode_params docstring).
        # bf16 candidate ranking in the sampler (ops/sampling rank_bf16):
        # drops the full-vocab fp32 convert/divide/TopK from each decode
        # step; probabilities on the k survivors stay fp32
        self.lm_rank_bf16 = sample_rank_bf16
        self.lm_params = rwkv7.pack_decode_params(
            lm_params, lm_cfg.backbone, quantize_int8=quantize_int8,
            quantize_int4=quantize_int4, fuse_projections=fuse_projections,
        )
        self.tok = text_tokenizer
        self.flow_cfg = flow_cfg
        self.flow_params = flow_params
        self.hift_cfg = hift_cfg
        self.hift_params = hift_params
        self.speech_tokenizer_fn = speech_tokenizer_fn
        self.spk_embed_fn = spk_embed_fn
        self.sample_rate = sample_rate
        # Native frontends (codecs/s3_tokenizer.py, codecs/campplus.py):
        # replace the reference's ONNX black boxes so wav-prompt zero-shot
        # runs with no injected callables (frontend.py:95-122 parity).
        if speech_tokenizer_fn is None and s3_params is not None:
            from rwkvtts_tpu.codecs import s3_tokenizer as s3

            cfg = s3_cfg or s3.S3TokenizerConfig()

            def _native_s3(wav: np.ndarray) -> np.ndarray:
                toks = s3.tokenize(s3_params, cfg, jnp.asarray(wav)[None])
                return np.asarray(toks)[0]

            self.speech_tokenizer_fn = _native_s3
        self.campplus_params = campplus_params
        self.campplus_cfg = campplus_cfg
        if spk_embed_fn is None and campplus_params is not None:
            from rwkvtts_tpu.codecs import campplus as cp

            ccfg = campplus_cfg or cp.CampplusConfig()
            self.campplus_cfg = ccfg

            def _native_spk(wav: np.ndarray) -> np.ndarray:
                emb = cp.embed_wav(campplus_params, ccfg, jnp.asarray(wav)[None])
                return np.asarray(emb)[0]

            self.spk_embed_fn = _native_spk

    # -- LM stage ---------------------------------------------------------

    def generate_speech_tokens(
        self,
        text: str,
        prompt_text: str = "",
        prompt_speech_tokens: Sequence[int] = (),
        max_new_tokens: int = 2048,
        seed: int = 0,
        top_p: float = 0.8,
        top_k: int = 25,
    ) -> np.ndarray:
        """[SOS][prompt_text+text][TASK][prompt_speech] -> speech ids."""
        text_ids = self.tok.encode(prompt_text) + self.tok.encode(text)
        sample = cosy_collator.build_prompt(text_ids, list(prompt_speech_tokens))
        from rwkvtts_tpu.data.spark_collator import pad_prompts_left

        batch = pad_prompts_left([sample])
        content_len = cosy_collator.content_length(text_ids)
        min_len = int(content_len * 2)
        max_len = min(int(content_len * 20), max_new_tokens)

        toks, lengths = gen.cosy_generate(
            self.lm_params,
            self.lm_cfg,
            jnp.asarray(batch["tokens"]),
            jnp.asarray(batch["modality"]),
            jnp.asarray(batch["attention_mask"]),
            jax.random.PRNGKey(seed),
            max_new_tokens=max_len,
            min_new_tokens=min_len,
            top_p=top_p,
            top_k=top_k,
        )
        n = int(np.asarray(lengths)[0])
        return np.asarray(toks)[0, :n]

    # -- token2wav ----------------------------------------------------------

    def token2wav(
        self,
        speech_tokens: np.ndarray,
        prompt_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,  # (Tp*2, 80)
        spk_embedding: Optional[np.ndarray] = None,  # (192,)
        n_timesteps: int = 10,
        seed: int = 0,
        speed: float = 1.0,
    ) -> np.ndarray:
        if self.flow_params is None or self.hift_params is None:
            raise RuntimeError("flow/hift params not loaded")
        all_tokens = np.concatenate(
            [np.asarray(prompt_tokens, np.int64), np.asarray(speech_tokens, np.int64)]
        )[None]
        mask = np.ones_like(all_tokens, np.float32)
        if spk_embedding is None:
            spk_embedding = np.zeros((self.flow_cfg.spk_embed_dim,), np.float32)
        if prompt_mel is None:
            prompt_mel = np.zeros((0, self.flow_cfg.output_size), np.float32)
        if self.flow_cfg.sfm and "sfm_head" in self.flow_params:
            # SFM fast decode (reference model/flow/flow.py:132-180): the
            # ODE starts at t_h from the coarse prediction; prompt rides as
            # concatenated tokens and the prompt-mel span is sliced off
            # (the reference's `feat[:, :, mel_len1:]`)
            mel = flow_lib.sfm_inference(
                self.flow_params,
                self.flow_cfg,
                jax.random.PRNGKey(seed),
                jnp.asarray(all_tokens),
                jnp.asarray(mask),
                jnp.asarray(spk_embedding[None]),
                n_timesteps=n_timesteps,
            )[:, prompt_mel.shape[0]:]
        else:
            mel = flow_lib.inference(
                self.flow_params,
                self.flow_cfg,
                jax.random.PRNGKey(seed),
                jnp.asarray(all_tokens),
                jnp.asarray(mask),
                jnp.asarray(prompt_mel[None]),
                prompt_mel.shape[0],
                jnp.asarray(spk_embedding[None]),
                n_timesteps=n_timesteps,
            )
        if speed != 1.0:
            # linear time-interpolation of the mel, the reference's speed
            # control (cli/model.py:398-401: F.interpolate before HiFT)
            T = mel.shape[1]
            mel = jax.image.resize(
                mel, (mel.shape[0], int(T / speed), mel.shape[2]), "linear"
            )
        wav, _ = hift_lib.inference(
            self.hift_params, self.hift_cfg, jax.random.PRNGKey(seed + 1), mel
        )
        return np.asarray(wav)[0]

    # -- full zero-shot -------------------------------------------------------

    def frontend_zero_shot(self, prompt_wav: np.ndarray, prompt_sr: int = 16000):
        """Extract (prompt speech tokens, prompt mel, spk embedding) from a
        reference clip.

        Sample-rate contract (reference frontend.py:164-174): the S3 speech
        tokenizer and the CAM++ x-vector consume 16 kHz audio; the flow
        prompt mel is computed on the clip RESAMPLED to the output rate
        (24 kHz for Cosy2), then trimmed to 2 frames per token."""
        from rwkvtts_tpu.utils import audio_io

        if self.speech_tokenizer_fn is None or self.spk_embed_fn is None:
            raise RuntimeError(
                "zero-shot frontend needs speech_tokenizer_fn and spk_embed_fn "
                "(or pass precomputed prompt features to synthesize)"
            )
        wav16 = audio_io.resample(np.asarray(prompt_wav, np.float32), prompt_sr, 16000)
        tokens = np.asarray(self.speech_tokenizer_fn(wav16), np.int64)
        emb = np.asarray(self.spk_embed_fn(wav16), np.float32)
        n_mels = self.flow_cfg.output_size if self.flow_cfg is not None else 80
        wav_out = audio_io.resample(
            np.asarray(prompt_wav, np.float32), prompt_sr, self.sample_rate
        )
        mel = np.asarray(
            dsp.log_mel_hifigan(
                jnp.asarray(wav_out[None]), sample_rate=self.sample_rate,
                n_mels=n_mels,
            )[0],
            np.float32,
        )
        # frontend enforces mel frames == 2 * token count (cli/frontend.py:170-174)
        n = min(mel.shape[0] // 2, len(tokens))
        return tokens[:n], mel[: 2 * n], emb

    def synthesize(
        self,
        text: str,
        prompt_text: str = "",
        prompt_wav: Optional[np.ndarray] = None,
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        seed: int = 0,
        speed: float = 1.0,
        lm_prompt_tokens: Optional[Sequence[int]] = None,
        **gen_kw,
    ) -> CosyTTSResult:
        """Zero-shot synthesis. `lm_prompt_tokens` overrides the prompt
        speech tokens fed to the LM (the flow always gets the full prompt
        condition) — pass [] for the cross-lingual/instruct variants that
        drop the LM speech prompt (frontend.py:185-193,203-207)."""
        if prompt_wav is not None:
            prompt_speech_tokens, prompt_mel, spk_embedding = self.frontend_zero_shot(prompt_wav)
        if lm_prompt_tokens is None:
            lm_prompt_tokens = prompt_speech_tokens
        t0 = time.perf_counter()
        tokens = self.generate_speech_tokens(
            text, prompt_text, lm_prompt_tokens, seed=seed, **gen_kw
        )
        t1 = time.perf_counter()
        wav = self.token2wav(
            tokens, prompt_speech_tokens, prompt_mel, spk_embedding, seed=seed,
            speed=speed,
        )
        # strip the prompt region: flow returns only the generated part, but
        # guard anyway
        t2 = time.perf_counter()
        dur = len(wav) / self.sample_rate
        return CosyTTSResult(
            wav=wav,
            sample_rate=self.sample_rate,
            speech_tokens=tokens,
            rtf=(t2 - t0) / max(dur, 1e-9),
            llm_s=t1 - t0,
            flow_s=t2 - t1,
            vocoder_s=0.0,
        )

    def synthesize_cross_lingual(
        self,
        text: str,
        prompt_wav: Optional[np.ndarray] = None,
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        **kw,
    ) -> CosyTTSResult:
        """Cross-lingual mode (frontend.py:185-193): the LM gets NO prompt
        text and NO prompt speech tokens (so the target language is free),
        while the flow keeps the full prompt condition for voice identity."""
        return self.synthesize(
            text, prompt_text="", prompt_wav=prompt_wav,
            prompt_speech_tokens=prompt_speech_tokens, prompt_mel=prompt_mel,
            spk_embedding=spk_embedding, lm_prompt_tokens=[], **kw,
        )

    def synthesize_instruct(
        self,
        text: str,
        instruct_text: str,
        prompt_wav: Optional[np.ndarray] = None,
        prompt_text: Optional[str] = None,
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        **kw,
    ) -> CosyTTSResult:
        """Instruct2 mode (frontend.py:203-207): the instruction rides as
        LM prompt text terminated by <|endofprompt|>; without a prompt
        transcript the LM speech prompt is dropped (information leakage),
        with one it is kept."""
        if prompt_text is not None:
            lm_text = instruct_text + "<|endofprompt|>" + prompt_text
            lm_tokens = None  # keep the speech prompt
        else:
            lm_text = instruct_text + "<|endofprompt|>"
            lm_tokens = []
        return self.synthesize(
            text, prompt_text=lm_text, prompt_wav=prompt_wav,
            prompt_speech_tokens=prompt_speech_tokens, prompt_mel=prompt_mel,
            spk_embedding=spk_embedding, lm_prompt_tokens=lm_tokens, **kw,
        )

    def voice_convert(
        self,
        source_wav: np.ndarray,
        prompt_wav: Optional[np.ndarray] = None,
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        seed: int = 0,
        speed: float = 1.0,
    ) -> CosyTTSResult:
        """Voice conversion (frontend_vc, frontend.py:212-222 +
        CosyVoiceModel.vc): tokenize the SOURCE speech, then re-synthesize
        those tokens through flow+HiFT conditioned on the PROMPT voice —
        no LM involved."""
        if self.speech_tokenizer_fn is None:
            raise RuntimeError("voice conversion needs the speech tokenizer")
        if prompt_wav is not None:
            prompt_speech_tokens, prompt_mel, spk_embedding = self.frontend_zero_shot(prompt_wav)
        t0 = time.perf_counter()
        source_tokens = np.asarray(self.speech_tokenizer_fn(source_wav), np.int64)
        wav = self.token2wav(
            source_tokens, prompt_speech_tokens, prompt_mel, spk_embedding,
            seed=seed, speed=speed,
        )
        t2 = time.perf_counter()
        dur = len(wav) / self.sample_rate
        return CosyTTSResult(
            wav=wav, sample_rate=self.sample_rate,
            speech_tokens=source_tokens, rtf=(t2 - t0) / max(dur, 1e-9),
            llm_s=0.0, flow_s=t2 - t0, vocoder_s=0.0,
        )

    def synthesize_long(
        self,
        text: str,
        prompt_text: str = "",
        prompt_wav: Optional[np.ndarray] = None,
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        seed: int = 0,
        token_max_n: int = 80,
        **gen_kw,
    ) -> CosyTTSResult:
        """Long-text orchestration (cli/cosyvoice.py:78-99): normalize, split
        into token-budget sentences, synthesize each with the same voice
        condition, concatenate. Per-sentence prefill also realizes the
        reference's cache-reset-past-2048 contract — state never grows
        across sentences."""
        from rwkvtts_tpu.data import text_frontend

        if prompt_wav is not None:
            prompt_speech_tokens, prompt_mel, spk_embedding = self.frontend_zero_shot(prompt_wav)
        norm = text_frontend.basic_normalize(text)
        chunks = text_frontend.split_paragraph(
            norm, self.tok.encode, token_max_n=token_max_n
        ) or [norm]
        wavs, all_tokens = [], []
        t0 = time.perf_counter()
        for i, chunk in enumerate(chunks):
            res = self.synthesize(
                chunk, prompt_text, None, prompt_speech_tokens, prompt_mel,
                spk_embedding, seed=seed + i, **gen_kw,
            )
            wavs.append(res.wav)
            all_tokens.append(res.speech_tokens)
        wav = np.concatenate(wavs) if wavs else np.zeros(0, np.float32)
        dur = len(wav) / self.sample_rate
        total = time.perf_counter() - t0
        return CosyTTSResult(
            wav=wav, sample_rate=self.sample_rate,
            speech_tokens=np.concatenate(all_tokens) if all_tokens else np.zeros(0, np.int64),
            rtf=total / max(dur, 1e-9), llm_s=0.0, flow_s=0.0, vocoder_s=0.0,
        )

    def synthesize_streaming(
        self,
        text: str,
        prompt_text: str = "",
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        hop_tokens: int = 25,
        seed: int = 0,
        max_new_tokens: int = 2048,
        **gen_kw,
    ):
        """Incremental streaming generator: yields wav chunks while the LM
        is still decoding. Unlike the reference's hop loop (which re-runs
        the flow over the whole prefix each hop, cli/model.py:372-434),
        every stage here is O(1) per hop — see infer/streaming.py."""
        from rwkvtts_tpu.infer import streaming

        scfg = streaming.StreamConfig(token_hop_len=hop_tokens)
        yield from streaming.stream_synthesize(
            self, text, prompt_text,
            prompt_speech_tokens=prompt_speech_tokens,
            prompt_mel=prompt_mel, spk_embedding=spk_embedding,
            stream_cfg=scfg, seed=seed, max_new_tokens=max_new_tokens,
            **gen_kw,
        )
