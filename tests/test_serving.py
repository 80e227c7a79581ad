"""Service tests: batched dispatcher groups same-voice requests, HTTP
endpoints round-trip wav, speaker library caching."""
import base64
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from rwkvtts_tpu.serving import http_server, service as svc
from rwkvtts_tpu.utils import audio_io


class FakeResult:
    def __init__(self, n):
        self.wav = np.zeros(n, np.float32)
        self.sample_rate = 16000


class FakePipeline:
    """Records batch sizes; returns one short wav per text."""

    def __init__(self):
        self.calls = []
        self.design_calls = []

    def synthesize(self, texts, **kw):
        if isinstance(texts, str):
            texts = [texts]
        self.calls.append((list(texts), kw))
        return [FakeResult(100 + len(t)) for t in texts]

    def design_voice(self, properties, seed=0, **kw):
        self.design_calls.append((dict(properties), seed))
        return [seed + i for i in range(32)]


def test_batched_dispatch_groups_same_speaker():
    pipe = FakePipeline()
    lib = svc.SpeakerLibrary(None)
    lib.register("alice", list(range(32)))
    tts = svc.BatchedTTSService(pipe, lib, max_batch=4, max_wait_ms=200)

    results = [None] * 3

    def call(i):
        results[i] = tts.synthesize(svc.TTSRequest(text=f"t{i}", speaker="alice"))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tts.close()

    assert all(r is not None and r.error is None for r in results)
    # at least one call should have batched >1 request
    batch_sizes = [len(texts) for texts, _ in pipe.calls]
    assert sum(batch_sizes) == 3
    assert max(batch_sizes) >= 2
    # global tokens resolved from the library
    assert pipe.calls[0][1]["global_tokens"] == list(range(32))


def test_http_endpoints(tmp_path):
    pipe = FakePipeline()
    lib = svc.SpeakerLibrary(None)
    lib.register("bob", [1] * 32)
    tts = svc.BatchedTTSService(pipe, lib, max_batch=1, max_wait_ms=1)
    server, port = http_server.start_background(tts)
    base = f"http://127.0.0.1:{port}"

    # registered (designed/cached) speakers are listed alongside demo dirs
    with urllib.request.urlopen(f"{base}/api/speakers") as r:
        assert json.loads(r.read()) == {"speakers": ["bob"]}

    body = json.dumps({"text": "hello", "speaker": "bob"}).encode()
    req = urllib.request.Request(
        f"{base}/api/rwkv_tts", data=body, headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        wav_bytes = r.read()
    assert wav_bytes[:4] == b"RIFF"

    # instruct endpoint with properties
    body = json.dumps({"text": "hi", "properties": {"gender": "male"}}).encode()
    req = urllib.request.Request(
        f"{base}/api/rwkv_tts_instruct", data=body,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req) as r:
        assert r.read()[:4] == b"RIFF"

    # error paths
    req = urllib.request.Request(
        f"{base}/api/rwkv_tts", data=b"{}", headers={"Content-Type": "application/json"}
    )
    try:
        urllib.request.urlopen(req)
        assert False
    except urllib.error.HTTPError as e:
        assert e.code == 400

    # observability endpoint (grouped dispatcher reports its queue depth)
    with urllib.request.urlopen(f"{base}/api/stats") as r:
        st = json.loads(r.read())
    assert st["mode"] == "grouped" and "queued" in st

    server.shutdown()
    tts.close()


def _post(base, path, obj):
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
    )
    return urllib.request.urlopen(req)


def test_voice_design_endpoints():
    """Voice-designer flow parity (gradio/tts_gui_simple.py:289-427 /
    tts_using_webrwkv_osx.py): properties -> 32 global tokens -> save as a
    named speaker -> synthesize with it or with raw tokens."""
    pipe = FakePipeline()
    tts = svc.BatchedTTSService(pipe, svc.SpeakerLibrary(None), max_batch=1, max_wait_ms=1)
    server, port = http_server.start_background(tts)
    base = f"http://127.0.0.1:{port}"

    # SPCT dropdown vocabularies
    with urllib.request.urlopen(f"{base}/api/properties") as r:
        props = json.loads(r.read())
    assert props["gender"] == ["female", "male"]
    assert "NEUTRAL" in props["emotion"] and len(props["emotion"]) == 25
    assert set(props) == {"age", "gender", "emotion", "pitch", "speed"}

    # design
    with _post(base, "/api/voice_design", {
        "properties": {"gender": "male", "pitch": "low_pitch"}, "seed": 5,
    }) as r:
        d = json.loads(r.read())
    assert d["global_tokens"] == [5 + i for i in range(32)]
    assert pipe.design_calls == [({"gender": "male", "pitch": "low_pitch"}, 5)]

    # save under a name (verbatim tokens, no re-design)
    with _post(base, "/api/voice_design", {
        "properties": {}, "name": "designed1", "global_tokens": d["global_tokens"],
    }) as r:
        assert json.loads(r.read())["name"] == "designed1"
    assert len(pipe.design_calls) == 1
    with urllib.request.urlopen(f"{base}/api/speakers") as r:
        assert "designed1" in json.loads(r.read())["speakers"]

    # synthesize with the saved speaker
    with _post(base, "/api/rwkv_tts", {"text": "hi", "speaker": "designed1"}) as r:
        assert r.read()[:4] == b"RIFF"
    assert pipe.calls[-1][1]["global_tokens"] == d["global_tokens"]

    # synthesize with raw designed tokens (unsaved voice)
    with _post(base, "/api/rwkv_tts", {
        "text": "hi", "global_tokens": d["global_tokens"], "temperature": 0.8,
        "top_k": 40, "top_p": 0.9, "max_new_tokens": 100,
    }) as r:
        assert r.read()[:4] == b"RIFF"
    kw = pipe.calls[-1][1]
    assert kw["global_tokens"] == d["global_tokens"]
    assert (kw["temperature"], kw["top_k"], kw["top_p"]) == (0.8, 40, 0.9)
    # per-request cap reaches the pipeline (64-bucketed by the dispatcher)
    assert kw["max_new_tokens"] == 128

    # error: design without properties
    try:
        _post(base, "/api/voice_design", {"seed": 1})
        assert False
    except urllib.error.HTTPError as e:
        assert e.code == 400

    server.shutdown()
    tts.close()


def test_gui_page_served():
    pipe = FakePipeline()
    tts = svc.BatchedTTSService(pipe, svc.SpeakerLibrary(None), max_batch=1, max_wait_ms=1)
    server, port = http_server.start_background(tts)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/") as r:
        page = r.read().decode()
    # the studio page carries the full voice-design flow
    for needle in ("Voice designer", "voice_design", "api/properties",
                   "Zero-shot prompt", "temperature", "History"):
        assert needle in page
    server.shutdown()
    tts.close()


def test_streaming_endpoint():
    """Chunked streaming WAV: header + PCM16 chunks as the pipeline yields."""

    class StreamPipe(FakePipeline):
        sample_rate = 24000

        def synthesize_streaming(self, text, prompt_text="", **kw):
            for i in range(3):
                yield np.full(480, 0.25 * (i + 1), np.float32)

    tts = svc.BatchedTTSService(StreamPipe(), svc.SpeakerLibrary(None), max_batch=1, max_wait_ms=1)
    server, port = http_server.start_background(tts)
    base = f"http://127.0.0.1:{port}"
    with _post(base, "/api/rwkv_tts_stream", {"text": "hi"}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        data = r.read()  # urllib de-chunks
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    header = svc.stream_wav_header(24000)
    pcm = np.frombuffer(data[len(header):], "<i2")
    assert len(pcm) == 3 * 480
    np.testing.assert_allclose(pcm[:480] / 32767.0, 0.25, atol=1e-3)

    # pipelines without a streaming path -> 501
    tts2 = svc.BatchedTTSService(FakePipeline(), svc.SpeakerLibrary(None), max_batch=1, max_wait_ms=1)
    server2, port2 = http_server.start_background(tts2)
    try:
        _post(f"http://127.0.0.1:{port2}", "/api/rwkv_tts_stream", {"text": "x"})
        assert False
    except urllib.error.HTTPError as e:
        assert e.code == 501
    server.shutdown(); server2.shutdown()
    tts.close(); tts2.close()


def test_audio_b64_roundtrip(tmp_path):
    wav = np.sin(np.linspace(0, 50, 8000)).astype(np.float32) * 0.3
    p = tmp_path / "a.wav"
    audio_io.save_wav(p, wav, 16000)
    b64 = base64.b64encode(open(p, "rb").read()).decode()
    out = svc.decode_audio_b64(b64)
    assert abs(len(out) - 8000) < 4
    np.testing.assert_allclose(out[:100], wav[:100], atol=1e-3)


# -- continuous-batcher serving path (VERDICT r2 #4) -------------------------


class TinyCodec:
    """detokenize: 10 samples per semantic token, amplitude = first global
    token (lets the test verify per-request voice routing)."""

    def tokenize(self, wav):
        import numpy as np

        return np.full((1, 1, 4), 7, np.int64), np.arange(3)[None]

    def detokenize(self, g, sem):
        import numpy as np

        n = sem.shape[-1] * 10
        return np.full((1, n), float(g.reshape(-1)[0]), np.float32)


def _tiny_spark_pipeline():
    import jax
    import jax.numpy as jnp

    from rwkvtts_tpu.infer.spark_pipeline import SparkPipeline
    from rwkvtts_tpu.models import spark

    class FakeTok:
        def encode(self, text):
            return [ord(c) % 200 + 1 for c in text][:12]

    cfg = spark.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
        dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    return SparkPipeline(cfg, params, FakeTok(), audio_tokenizer=TinyCodec())


def test_continuous_service_serves_concurrent_mixed_voices():
    """Concurrent requests with DIFFERENT voices are all served through
    slot admission in one batcher (the grouped dispatcher would have run
    them as separate single-voice batches)."""
    pipe = _tiny_spark_pipeline()
    lib = svc.SpeakerLibrary(None)
    lib.register("alice", [5] * 4)
    tts = svc.ContinuousTTSService(
        pipe, lib, n_slots=4, chunk=4, prompt_cap=32, max_new_tokens=6,
        top_k=1,
    )
    reqs = [
        svc.TTSRequest(text="one", speaker="alice"),
        svc.TTSRequest(text="two", global_tokens=[9] * 4),
        svc.TTSRequest(text="three", global_tokens=[3] * 4),
        svc.TTSRequest(text="four", speaker="alice"),
        svc.TTSRequest(text="five", global_tokens=[9] * 4),
    ]
    results = [None] * len(reqs)

    def call(i):
        results[i] = tts.synthesize(reqs[i], timeout=120)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tts.close()
    for i, r in enumerate(results):
        assert r is not None and r.error is None, (i, r and r.error)
        assert len(r.wav) > 0
    # the TinyCodec amplitude proves each request got ITS OWN voice
    assert results[0].wav[0] == 5.0 and results[3].wav[0] == 5.0
    assert results[1].wav[0] == 9.0 and results[4].wav[0] == 9.0
    assert results[2].wav[0] == 3.0
    # a request with no voice errors cleanly instead of hanging
    bad = svc.ContinuousTTSService(
        _tiny_spark_pipeline(), None, n_slots=2, chunk=4, prompt_cap=32,
        max_new_tokens=4, top_k=1,
    )
    r = bad.synthesize(svc.TTSRequest(text="x"), timeout=30)
    assert r.error and "need speaker" in r.error
    bad.close()


def test_continuous_service_http_level():
    """End-to-end over HTTP: concurrent mixed-voice POSTs against the
    continuous service all round-trip wav."""
    pipe = _tiny_spark_pipeline()
    lib = svc.SpeakerLibrary(None)
    lib.register("bob", [2] * 4)
    tts = svc.ContinuousTTSService(
        pipe, lib, n_slots=4, chunk=4, prompt_cap=32, max_new_tokens=6,
        top_k=1,
    )
    server, port = http_server.start_background(tts)
    base = f"http://127.0.0.1:{port}"

    payloads = [
        {"text": "hello", "speaker": "bob"},
        {"text": "goodbye", "global_tokens": [8] * 4},
        {"text": "third", "global_tokens": [1] * 4},
    ]
    outs = [None] * len(payloads)

    def post(i):
        body = json.dumps(payloads[i]).encode()
        req = urllib.request.Request(
            f"{base}/api/rwkv_tts", body,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            outs[i] = (r.status, r.read())

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    server.shutdown()
    tts.close()
    for status, body in outs:
        assert status == 200
        assert body[:4] == b"RIFF" and len(body) > 44
