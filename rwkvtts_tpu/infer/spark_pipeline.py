"""End-to-end Spark TTS pipeline: text (+ zero-shot prompt / SPCT voice
properties) -> wav.

Reference call stack parity (SURVEY.md §3.2; test_respark/simple_generate.py):
  bicodec.tokenize(prompt) -> [TAG2|text|TAG0|global|TAG1|prompt_sem] prompt
  -> AR decode (top_k 50, top_p 0.95) -> bicodec.detokenize -> wav.
Voice-design flow (tts_using_webrwkv_osx.py): SPCT properties -> generate 32
global tokens with the designer head -> generate semantics.

All device work is two jitted programs (generate, detokenize); everything
else is host-side token bookkeeping.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.data import spark_collator
from rwkvtts_tpu.data.properties import properties_string
from rwkvtts_tpu.infer import generate as gen
from rwkvtts_tpu.models import spark as spark_model


@dataclasses.dataclass
class SparkTTSResult:
    wav: np.ndarray
    sample_rate: int
    semantic_tokens: np.ndarray
    global_tokens: np.ndarray
    prefill_s: float
    decode_s: float
    tokens_per_s: float


class SparkPipeline:
    def __init__(
        self,
        lm_cfg,
        lm_params,
        text_tokenizer,
        audio_tokenizer=None,  # codecs.spark_tokenizer.SparkAudioTokenizer
        sample_rate: int = 16000,
        prompt_pad_multiple: int = 64,
        quantize_int8: bool = False,
        quantize_int4: bool = False,
        spec_k: int = 0,
        spec_draft: str = "int8",
    ):
        from rwkvtts_tpu.models import rwkv7

        self.cfg = lm_cfg
        # fused decode projections (exact same math, fewer dispatches);
        # opt-in int8 decode weights (quality probe:
        # scripts/measure_int8_quality.py)
        self.params = rwkv7.pack_decode_params(
            lm_params, lm_cfg.backbone, quantize_int8=quantize_int8,
            quantize_int4=quantize_int4,
        )
        # opt-in self-speculative B=1 decode (infer/spec_decode.py): a
        # quantized DRAFT proposes spec_k tokens, one full-precision chunk
        # forward verifies them — exact in distribution w.r.t. plain
        # sampling. The verifier must stay full precision, so spec_k is
        # mutually exclusive with quantize_* (those quantize the draft
        # via spec_draft instead: "int8" | "int4" | "bf16").
        self.spec_k = int(spec_k)
        self.draft_params = None
        if self.spec_k:
            if self.spec_k > 8:
                # the verify forward collects one full state per window
                # position, so memory grows with k; larger windows only
                # cost more verify FLOPs.
                raise ValueError(
                    "spec_k > 8 is not supported: the verify window keeps"
                    " one full decode state per position"
                )
            if quantize_int8 or quantize_int4:
                raise ValueError(
                    "spec_k verifies at full precision; quantization applies"
                    " to the draft — use spec_draft instead of quantize_*"
                )
            if spec_draft not in ("int8", "int4", "bf16"):
                raise ValueError(f"unknown spec_draft {spec_draft!r}")
            draft_src = lm_params
            if spec_draft == "bf16":
                # actually cast the draft (pack_decode_params has no bf16
                # mode) — packing the fp params unchanged would double
                # fused-copy HBM for zero draft speedup
                draft_src = jax.tree.map(
                    lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x,
                    lm_params,
                )
            self.draft_params = rwkv7.pack_decode_params(
                draft_src,
                lm_cfg.backbone,
                quantize_int8=spec_draft == "int8",
                quantize_int4=spec_draft == "int4",
            )
        self.tok = text_tokenizer
        self.codec = audio_tokenizer
        self.sample_rate = sample_rate
        # prompts pad up to a multiple of this so serving traffic compiles
        # one prefill program per 64-token bucket, not per text length
        self.prompt_pad_multiple = prompt_pad_multiple

    # -- prompt construction --------------------------------------------------

    def _prompt_batch(
        self,
        texts: Sequence[str],
        global_tokens: Sequence[Sequence[int]],
        prompt_semantics: Sequence[Sequence[int]],
        properties: Sequence[Optional[str]],
        pad_to: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        samples = [
            spark_collator.build_prompt(
                self.tok.encode(t),
                g,
                prompt_semantic_tokens=s,
                properties=p,
                tokenizer=self.tok,
            )
            for t, g, s, p in zip(texts, global_tokens, prompt_semantics, properties)
        ]
        return spark_collator.pad_prompts_left(
            samples, pad_to=pad_to, pad_multiple=self.prompt_pad_multiple
        )

    # -- public API -----------------------------------------------------------

    def synthesize(
        self,
        text: Union[str, Sequence[str]],
        prompt_wav=None,
        prompt_text: Optional[str] = None,
        properties: Optional[Dict[str, Any]] = None,
        global_tokens: Optional[Sequence[int]] = None,
        max_new_tokens: int = 1024,
        temperature: float = 1.0,
        top_k: int = 50,
        top_p: float = 0.95,
        seed: int = 0,
        pad_to: Optional[int] = None,
    ) -> SparkTTSResult:
        """Zero-shot (prompt_wav [+ prompt_text]) or voice-controlled
        (properties dict / explicit global_tokens) synthesis."""
        texts = [text] if isinstance(text, str) else list(text)
        B = len(texts)

        prompt_sem: List[List[int]] = [[] for _ in texts]
        if prompt_wav is not None:
            if self.codec is None:
                raise RuntimeError("audio tokenizer required for prompt_wav")
            glob, sem = self.codec.tokenize(prompt_wav)
            g = glob.reshape(-1).tolist()
            s = sem.reshape(-1).tolist()
            globals_ = [g] * B
            if prompt_text is not None:
                texts = [prompt_text + t for t in texts]
                prompt_sem = [s] * B
        elif global_tokens is not None:
            globals_ = [list(global_tokens)] * B
        elif properties is not None:
            globals_ = [self.design_voice(properties)] * B
        else:
            raise ValueError("need prompt_wav, global_tokens, or properties")

        props_str = None
        if properties is not None:
            props_str = properties_string(
                properties.get("age", "youth-adult"),
                properties.get("gender", "female"),
                properties.get("emotion", "NEUTRAL"),
                properties.get("pitch", "medium_pitch"),
                properties.get("speed", "medium"),
            )
        batch = self._prompt_batch(
            texts, globals_, prompt_sem, [props_str] * B, pad_to=pad_to
        )

        t0 = time.perf_counter()
        if self.spec_k and B == 1:
            # self-speculative B=1 path: draft spec_k with the quantized
            # tree, verify in one full-precision chunk forward
            from rwkvtts_tpu.infer import spec_decode

            out, _stats = spec_decode.spec_sample_generate(
                self.params,
                self.cfg,
                jnp.asarray(batch["tokens"]),
                jnp.asarray(batch["modality"]),
                jnp.asarray(batch["attention_mask"]),
                key=jax.random.PRNGKey(seed),
                draft_params=self.draft_params,
                k=self.spec_k,
                max_new_tokens=max_new_tokens,
                temperature=temperature,
                top_k=top_k,
                top_p=top_p,
            )
            n = len(out)
            if n and int(out[-1]) == self.cfg.eos_token_id:
                n -= 1
            toks = np.full((1, max(n, 1)), self.cfg.eos_token_id, np.int32)
            toks[0, :n] = out[:n]
            lengths = np.asarray([n])
        else:
            # chunked early-exit decode: a short utterance costs its own
            # length plus at most one chunk, not max_new_tokens scan steps
            toks, lengths = gen.spark_generate_early_exit(
                self.params,
                self.cfg,
                jnp.asarray(batch["tokens"]),
                jnp.asarray(batch["modality"]),
                jnp.asarray(batch["attention_mask"]),
                jax.random.PRNGKey(seed),
                max_new_tokens=max_new_tokens,
                temperature=temperature,
                top_k=top_k,
                top_p=top_p,
            )
            toks = np.asarray(toks)
            lengths = np.asarray(lengths)
        t1 = time.perf_counter()

        results: List[SparkTTSResult] = []
        total_tok = int(lengths.sum())
        for i in range(B):
            n = int(lengths[i])
            semantic = toks[i, :n]
            wav = np.zeros(0, np.float32)
            if self.codec is not None and n > 0:
                g = np.asarray(globals_[i], np.int64)[None, None, :]
                wav = self.codec.detokenize(g, semantic[None].astype(np.int64))[0]
            results.append(
                SparkTTSResult(
                    wav=wav,
                    sample_rate=self.sample_rate,
                    semantic_tokens=semantic,
                    global_tokens=np.asarray(globals_[i]),
                    prefill_s=t1 - t0,
                    decode_s=time.perf_counter() - t1,
                    tokens_per_s=total_tok / max(t1 - t0, 1e-9),
                )
            )
        return results[0] if isinstance(text, str) else results

    def design_voice(
        self,
        properties: Dict[str, Any],
        temperature: float = 1.0,
        top_k: int = 50,
        top_p: float = 0.95,
        seed: int = 0,
    ) -> List[int]:
        """Voice designer: SPCT properties -> 32 global tokens using the
        global-token head path (reference tts_using_webrwkv_osx.py flow)."""
        props = properties_string(
            properties.get("age", "youth-adult"),
            properties.get("gender", "female"),
            properties.get("emotion", "NEUTRAL"),
            properties.get("pitch", "medium_pitch"),
            properties.get("speed", "medium"),
        )
        prop_ids = self.tok.encode(props)
        s = spark_collator.Sample([], [], [])
        s.extend(prop_ids, spark_model.MOD_TEXT, [spark_collator.IGNORE] * len(prop_ids))
        s.extend([spark_model.TAG_GLOBAL], spark_model.MOD_TAG, [spark_collator.IGNORE])
        batch = spark_collator.pad_prompts_left([s])
        toks, _ = gen.spark_global_generate(
            self.params,
            self.cfg,
            jnp.asarray(batch["tokens"]),
            jnp.asarray(batch["modality"]),
            jnp.asarray(batch["attention_mask"]),
            jax.random.PRNGKey(seed),
            num_tokens=32,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
        )
        return np.asarray(toks)[0].tolist()
