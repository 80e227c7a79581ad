"""rwkvtts_tpu — an RWKV-7 speech framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of yynil/RWKVTTS:
RWKV-7 speech language models (SparkTTS single-stream, CosyVoice, XY/Higgs
multi-channel), ASR, audio codecs, training (GSPMD data/tensor parallel over a
device mesh), and batched autoregressive serving.

Layering (bottom → top):
  ops/       WKV7 (scan reference, chunked-matmul, decode step), norms,
             sampling, losses
  models/    RWKV-7 core + speech LM heads (functional: config → params → apply)
  data/      prompt-layout collators (token-domain, segment-id packing)
  codecs/    audio token ⇄ waveform stacks (BiCodec, flow/HiFT, XY)
  parallel/  mesh construction + sharding rules + pjit train-step factory
  train/     optimizer groups, LR schedules, checkpointing, loops
  infer/     jitted autoregressive decode loops
  serving/   batched service front-end
"""

__version__ = "0.1.0"
