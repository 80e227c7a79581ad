"""RWKV-7 ASR model family.

Reference parity (behavior, /root/reference):
  * v1 "discrete": RWKV7ASRModel(audio_lm over audio token ids -> projector
    -> llm), layout [instr][audio][hints][answer] left-aligned-valid,
    labels -100 except answer (model/llm/rwkv_asr.py:16-165)
  * v2 "whisper": frozen Whisper encoder -> projector1 -> audio-adapter
    RWKV (no embedding) -> projector2 -> llm
    (model/llm/rwkv_asr_whisper.py:48-238)
  * v3 is v2 on the from-scratch CUDA stack (rwkv_asr_cuda_whisper.py) —
    subsumed here: same math, our kernels.

Packing: the reference splices per-sample valid segments with a
host Python loop over the batch (rwkv_asr.py:92-130). Here the pack is a
vectorized right-aligned scatter computed inside jit — per-segment cumsum
ranks + one scatter per tensor, static shapes, GSPMD-compatible.

ASR instruction contract (train_scripts/train_rwkv7_asr_jsonl.py:360-366):
  zh: "User: 把以下音频转写为中文。\\n"   en: "User: Convert the audios to English.\\n"
  hints: "\\nAssistant:", EOS id 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from rwkvtts_tpu.models import rwkv7, whisper
from rwkvtts_tpu.ops import loss as loss_ops
from rwkvtts_tpu.ops import sampling

Params = Dict[str, Any]

EOS_ID = 0  # world-vocab <|endoftext|> (rwkv_asr.py:184)


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    llm: rwkv7.RWKV7Config
    adapter: rwkv7.RWKV7Config  # audio LM; with_embedding only for "discrete"
    variant: str = "whisper"  # "whisper" | "discrete"
    whisper: Optional[whisper.WhisperEncoderConfig] = None


def default_config(
    hidden_size=768, num_layers=12, adapter_layers=6, audio_vocab=8193,
    variant="whisper", dtype=jnp.bfloat16, **kw,
) -> ASRConfig:
    llm = rwkv7.RWKV7Config(
        vocab_size=65536, hidden_size=hidden_size, num_layers=num_layers,
        dtype=dtype, **kw,
    )
    adapter = rwkv7.RWKV7Config(
        vocab_size=audio_vocab, hidden_size=hidden_size, num_layers=adapter_layers,
        dtype=dtype, with_head=False, with_embedding=(variant == "discrete"), **kw,
    )
    wcfg = whisper.WhisperEncoderConfig(d_model=hidden_size) if variant == "whisper" else None
    return ASRConfig(llm=llm, adapter=adapter, variant=variant, whisper=wcfg)


def init_params(key, cfg: ASRConfig) -> Params:
    ks = jax.random.split(key, 5)
    C_a = cfg.adapter.hidden_size
    C_l = cfg.llm.hidden_size
    p: Params = {
        "adapter": rwkv7.init_params(ks[0], cfg.adapter),
        "projector": {
            "w": jax.random.normal(ks[1], (C_a, C_l), jnp.float32) * 0.02,
            "b": jnp.zeros((C_l,)),
        },
        "llm": rwkv7.init_params(ks[2], cfg.llm),
    }
    if cfg.variant == "whisper":
        p["whisper"] = whisper.init_params(ks[3], cfg.whisper)
        p["projector1"] = {
            "w": jax.random.normal(ks[4], (cfg.whisper.d_model, C_a), jnp.float32) * 0.02,
            "b": jnp.zeros((C_a,)),
        }
    return p


def _proj(p, x):
    return x @ p["w"].astype(x.dtype) + p["b"].astype(x.dtype)


def audio_embeds(params: Params, cfg: ASRConfig, batch: Dict[str, jax.Array]):
    """Run the audio tower. Returns (embeds (B, Ta, C_llm), mask (B, Ta)).

    whisper variant: batch['mel'] (B, T_mel, n_mels) + batch['mel_mask'];
    discrete variant: batch['audio_ids'] (B, Ta) + batch['audio_mask'].
    """
    if cfg.variant == "whisper":
        enc = whisper.apply(params["whisper"], cfg.whisper, batch["mel"], batch.get("mel_mask"))
        enc = jax.lax.stop_gradient(enc)  # frozen frontend (rwkv_asr_whisper.py:91-93)
        h = _proj(params["projector1"], enc.astype(cfg.adapter.dtype))
        mask = batch.get("mel_mask")
        mask = mask[:, ::2][:, : h.shape[1]] if mask is not None else None
        h = rwkv7.forward(params["adapter"], cfg.adapter, inputs_embeds=h, attention_mask=mask)
    else:
        mask = batch.get("audio_mask")
        h = rwkv7.forward(
            params["adapter"], cfg.adapter, input_ids=batch["audio_ids"], attention_mask=mask
        )
    if mask is None:
        mask = jnp.ones(h.shape[:2], jnp.int32)
    return _proj(params["projector"], h), mask


from rwkvtts_tpu.ops.packing import right_align_pack as _right_align_pack


def forward(
    params: Params,
    cfg: ASRConfig,
    batch: Dict[str, jax.Array],
    l2_wrap: float = 1e-4,
):
    """Training forward -> (loss, n_valid_tokens).

    batch keys: text_ids/text_mask (instruction), mel/mel_mask or
    audio_ids/audio_mask, hints_ids/hints_mask, labels/labels_mask.
    All segments left-padded or right-padded — only the mask matters.
    """
    aud, aud_mask = audio_embeds(params, cfg, batch)
    dt = cfg.llm.dtype
    lut = params["llm"]["embedding"]

    def emb_ids(ids):
        return lut[jnp.clip(ids, 0)].astype(dt)

    text = emb_ids(batch["text_ids"])
    hints = emb_ids(batch["hints_ids"])
    lab_ids = batch["labels"]
    lab_emb = emb_ids(jnp.where(lab_ids == -100, 0, lab_ids))

    T_total = (
        text.shape[1] + aud.shape[1] + hints.shape[1] + lab_emb.shape[1]
    )
    packed, mask, labels = _right_align_pack(
        [
            (text, batch["text_mask"], None),
            (aud.astype(dt), aud_mask, None),
            (hints, batch["hints_mask"], None),
            (lab_emb, batch["labels_mask"], lab_ids),
        ],
        T_total,
    )
    h = rwkv7.forward(params["llm"], cfg.llm, inputs_embeds=packed, attention_mask=mask)
    return loss_ops.fused_linear_cross_entropy(
        h, params["llm"]["head"], labels, shift=True, l2_wrap=l2_wrap
    )


def transcribe(
    params: Params,
    cfg: ASRConfig,
    batch: Dict[str, jax.Array],
    max_new_tokens: int = 128,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    key: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Batched decode (rwkv_asr_cuda_whisper.py:694-717 equivalent): prefill
    [instr][audio][hints], then greedy/sampled AR with persistent state.

    Returns (token_ids (B, max_new), lengths (B,)); EOS-filled after stop.
    """
    aud, aud_mask = audio_embeds(params, cfg, batch)
    dt = cfg.llm.dtype
    lut = params["llm"]["embedding"]
    text = lut[jnp.clip(batch["text_ids"], 0)].astype(dt)
    hints = lut[jnp.clip(batch["hints_ids"], 0)].astype(dt)

    T_total = text.shape[1] + aud.shape[1] + hints.shape[1]
    packed, mask, _ = _right_align_pack(
        [
            (text, batch["text_mask"], None),
            (aud.astype(dt), aud_mask, None),
            (hints, batch["hints_mask"], None),
        ],
        T_total,
    )
    h, state = rwkv7.forward(
        params["llm"], cfg.llm, inputs_embeds=packed, attention_mask=mask,
        return_state=True,
    )
    h_last = h[:, -1]
    B = h_last.shape[0]
    state = rwkv7.pack_decode_state(state, cfg.llm)
    llm_params = rwkv7.layer_decode_views(params["llm"], cfg.llm)
    if key is None:
        key = jax.random.PRNGKey(0)

    def step(carry, step_key):
        h, st, done = carry
        logits = (h @ params["llm"]["head"].astype(dt)).astype(jnp.float32)
        if temperature <= 0.0:
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        else:
            tok = sampling.sample(
                step_key, logits, temperature=temperature, top_k=top_k, top_p=top_p
            )
        tok = jnp.where(done, EOS_ID, tok)
        done = done | (tok == EOS_ID)
        x = lut[tok].astype(dt)
        h2, st2 = rwkv7.decode_step(llm_params, cfg.llm, x, st)
        return (h2[:,] if h2.ndim == 2 else h2, st2, done), tok

    keys = jax.random.split(key, max_new_tokens)
    (_, _, done), toks = jax.lax.scan(
        step, (h_last, state, jnp.zeros((B,), bool)), keys
    )
    toks = toks.T  # (B, max_new)
    lengths = jnp.sum((jnp.cumsum(toks == EOS_ID, axis=1) == 0).astype(jnp.int32), axis=1)
    return toks, lengths
