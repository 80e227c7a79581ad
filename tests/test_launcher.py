"""Production serving boot path: checkpoint file -> build_pipeline ->
ContinuousTTSService -> one request, on CPU with a tiny exported model.
Covers what `rwkvtts-serve` does minus the HTTP listener (that layer is
tested in tests/test_serving.py) — including the new decode knobs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rwkvtts_tpu.convert import export_hf
from rwkvtts_tpu.models import spark
from rwkvtts_tpu.serving import launch, service as svc


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    pytest.importorskip("safetensors")
    cfg = spark.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
        dtype=jnp.float32, wkv_chunk=16, remat=False,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    d = tmp_path_factory.mktemp("ckpt")
    out = export_hf.save_pretrained(params, cfg, str(d), kind="spark")
    return f"{out}/model.safetensors"


def test_launcher_boot_and_serve(ckpt, monkeypatch):
    # the tokenizer file download/lookup is heavyweight; serve with a stub
    class Tok:
        def encode(self, t):
            return [ord(c) % 200 + 1 for c in t]

    monkeypatch.setattr(
        "rwkvtts_tpu.utils.tokenizer.get_world_tokenizer",
        lambda n_spct=0: Tok(),
    )
    pipe = launch.build_pipeline(ckpt, state_bf16=True)
    assert pipe.cfg.backbone.decode_state_bf16
    tts = launch.build_service(
        pipe, continuous=True, n_slots=2, chunk=8, max_new_tokens=16,
        warmup=False,
    )
    try:
        resp = tts.synthesize(
            svc.TTSRequest(text="boot", global_tokens=[1] * 32,
                           max_new_tokens=8),
            timeout=600,
        )
        assert resp.error is None
        assert resp.wav is not None
    finally:
        tts.close()


def test_launcher_packed_bf16_combo(ckpt, monkeypatch):
    class Tok:
        def encode(self, t):
            return [1, 2]

    monkeypatch.setattr(
        "rwkvtts_tpu.utils.tokenizer.get_world_tokenizer",
        lambda n_spct=0: Tok(),
    )
    # --state-bf16: the service builds its slot carry with one bf16
    # (n_slots, H, N, N) wkv leaf per layer (the plain layout; no head-pair
    # packing)
    pipe = launch.build_pipeline(ckpt, state_bf16=True)
    bb = pipe.cfg.backbone
    tts = launch.build_service(pipe, continuous=True, n_slots=2, warmup=False)
    try:
        carry = tts.batcher._carry[1]
        assert len(carry) == bb.num_layers
        for st in carry:
            assert st["wkv"].shape == (2, bb.num_heads, bb.head_size, bb.head_size)
            assert st["wkv"].dtype == jnp.bfloat16
    finally:
        tts.close()


def test_launcher_cosy_family_boot(tmp_path, monkeypatch):
    """--family cosy boot path: Cosy LM checkpoint -> build_cosy_pipeline ->
    CosyTTSService over the shared slot pool -> one request (LM-only: no
    codec dir, so the response wav is empty but error-free)."""
    pytest.importorskip("safetensors")
    from rwkvtts_tpu.models import cosy

    cfg = cosy.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
        dtype=jnp.float32, wkv_chunk=16, remat=False,
    )
    params = cosy.init_params(jax.random.PRNGKey(0), cfg)
    out = export_hf.save_pretrained(params, cfg, str(tmp_path), kind="cosy")

    class Tok:
        def encode(self, t):
            return [ord(c) % 200 + 1 for c in t]

    monkeypatch.setattr(
        "rwkvtts_tpu.utils.tokenizer.get_world_tokenizer",
        lambda n_spct=0: Tok(),
    )
    pipe = launch.build_cosy_pipeline(f"{out}/model.safetensors")
    assert pipe.lm_cfg.backbone.hidden_size == 32
    tts = svc.CosyTTSService(pipe, n_slots=2, chunk=4, max_new_tokens=8)
    try:
        st = tts.stats()
        assert st["mode"] == "cosy_pool" and st["n_slots"] == 2
        # no flow/hift loaded (no --cosy-dir): wav requests error CLEARLY
        resp = tts.synthesize(svc.TTSRequest(text="boot", max_new_tokens=8))
        assert resp.error is not None and "flow.pt" in resp.error
        # named speaker without a voice library is a clear client error too
        from rwkvtts_tpu.codecs import conformer, flow as flow_lib
        from rwkvtts_tpu.codecs import hift as hift_lib

        fcfg = flow_lib.FlowConfig(
            input_size=24, output_size=16, spk_embed_dim=12, vocab_size=6562,
            encoder=conformer.UpsampleConformerConfig(
                input_size=24, output_size=24, attention_heads=2,
                linear_units=48, num_blocks=1, num_up_blocks=1,
            ),
            estimator=flow_lib.EstimatorConfig(
                in_channels=16 * 4, out_channels=16, channels=(16,),
                n_blocks=1, num_mid_blocks=1, num_heads=2,
                attention_head_dim=8, causal=True, static_chunk_size=2,
            ),
            n_timesteps=2,
        )
        pipe.flow_cfg = fcfg
        pipe.flow_params = flow_lib.init_params(jax.random.PRNGKey(1), fcfg)
        hcfg = hift_lib.HiFTConfig(
            in_channels=16, base_channels=32, nb_harmonics=2,
            upsample_rates=(4, 3), upsample_kernel_sizes=(8, 7),
            istft_n_fft=16, istft_hop_len=4,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
            source_resblock_kernel_sizes=(7, 7),
            source_resblock_dilation_sizes=((1, 2), (1, 2)),
            f0_cond_channels=16,
        )
        pipe.hift_cfg = hcfg
        pipe.hift_params = hift_lib.init_params(jax.random.PRNGKey(2), hcfg)
        resp = tts.synthesize(svc.TTSRequest(text="boot", max_new_tokens=8))
        assert resp.error is None
        bad = tts.synthesize(svc.TTSRequest(text="x", speaker="nope"))
        assert bad.error is not None
    finally:
        tts.close()
