"""Benchmark: Spark speech-LM decode throughput on the GPU.

Measures generated-audio-token throughput (the reference's headline runtime
print, model/llm/llm.py:268-269 / cosy_llm.py:270-271) with the flagship
decode loop: batched AR generation (infer/generate.spark_generate), every
step on device.

Refuses to run without a GPU. Prints the card (device kind, device count,
nvidia-smi name and power limit) on a line before the result, and the
result as ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
Baseline north-star: 5000 audio tok/s/chip (BASELINE.md).
"""
from __future__ import annotations

import json
import statistics
import sys
import time


def main():
    import jax

    from rwkvtts_tpu.infer.generate import spark_generate
    from rwkvtts_tpu.models import rwkv7, spark
    from rwkvtts_tpu.utils import chip_checks, jit_cache

    chip_checks.require_gpu()
    jit_cache.enable()
    info = chip_checks.device_info()

    # deployed-scale flagship: 0.4B-class (the reference ships 0.19B-1.5B
    # LMs, Inference.md:19-44). decode_state_bf16 carries the WKV state
    # bf16 between steps, as the reference's own decode kernel carries fp16
    # state (cuda/rwkv7_state_fwd_fp16.cu).
    cfg = spark.default_config(
        hidden_size=1024, num_layers=24, decode_state_bf16=True
    )
    # seeded random weights, the zero-initialized matrices filled too so
    # every block does real work; big tables bf16 for the bandwidth-bound
    # decode
    params = chip_checks.spark_params(cfg)
    B, T_prompt, T_new = 64, 128, 256
    tokens, modality, mask = chip_checks.spark_prompts(B, T_prompt)

    # fuse the seven per-block input projections into two matmuls
    pk = rwkv7.pack_decode_params(params, cfg.backbone)

    def run(key):
        toks, _ = spark_generate(
            pk, cfg, tokens, modality, mask, key,
            max_new_tokens=T_new, top_k=50, top_p=0.95, temperature=1.0,
        )
        return jax.block_until_ready(toks)

    run(jax.random.PRNGKey(2))  # compile + warmup
    # median of independent passes, spread to stderr
    times = []
    for i in range(5):
        t0 = time.perf_counter()
        run(jax.random.PRNGKey(3 + i))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)

    toks_per_s = B * T_new / dt
    baseline = 5000.0
    print(
        f"bench.py passes (s): {['%.4f' % t for t in times]} "
        f"median={dt:.4f} min={min(times):.4f} max={max(times):.4f} "
        f"spread={(max(times) - min(times)) / dt:.1%}",
        file=sys.stderr,
    )
    print(
        f"device: platform={info['platform']} kind={info['kind']!r} "
        f"count={info['count']} nvidia-smi: {chip_checks.smi_line()}"
    )
    print(
        json.dumps(
            {
                "metric": "spark_decode_tokens_per_sec_per_chip",
                "value": round(toks_per_s, 1),
                "unit": "audio_tokens/s/chip",
                "vs_baseline": round(toks_per_s / baseline, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
