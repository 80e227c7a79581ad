"""Webdataset tar reading + extraction pipeline tests."""
import io
import json
import os
import tarfile

import numpy as np
import pytest

from rwkvtts_tpu.data import extract, webdataset
from rwkvtts_tpu.utils import audio_io


def _make_tar(path, n=3, sr=16000):
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            wav = (np.sin(np.linspace(0, 40 + i, sr // 4)) * 0.3).astype(np.float32)
            import tempfile

            with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                audio_io.save_wav(f.name, wav, sr)
                tf.add(f.name, arcname=f"utt{i}.wav")
            meta = json.dumps({"text": f"sample {i}"}).encode()
            info = tarfile.TarInfo(f"utt{i}.json")
            info.size = len(meta)
            tf.addfile(info, io.BytesIO(meta))


def test_tar_samples(tmp_path):
    p = str(tmp_path / "d.tar")
    _make_tar(p)
    samples = list(webdataset.iter_tar_samples(p))
    assert len(samples) == 3
    assert samples[0]["text"] == "sample 0"
    assert samples[0]["audio"].dtype == np.float32
    assert len(samples[0]["audio"]) == 4000


def test_multiple_webdataset_shuffle_and_verify(tmp_path):
    p1, p2 = str(tmp_path / "a.tar"), str(tmp_path / "b.tar")
    _make_tar(p1, 2)
    _make_tar(p2, 2)
    bad = str(tmp_path / "bad.tar")
    open(bad, "wb").write(b"not a tar")
    ds = webdataset.MultipleWebDataset([p1, p2, bad], seed=1)
    assert len(ds) == 4
    assert not webdataset.check_tar(bad)


def test_stream_tars_sharding(tmp_path):
    paths = []
    for i in range(4):
        p = str(tmp_path / f"t{i}.tar")
        _make_tar(p, 1)
        paths.append(p)
    s0 = list(webdataset.stream_tars(paths, shard_index=0, num_shards=2))
    s1 = list(webdataset.stream_tars(paths, shard_index=1, num_shards=2))
    assert len(s0) == 2 and len(s1) == 2


class FakeSparkTokenizer:
    def tokenize(self, wav):
        return np.ones((1, 1, 32), np.int64), np.arange(len(wav) // 320)[None]


def test_extract_spark_tokens(tmp_path):
    out = str(tmp_path / "rows.jsonl")
    samples = [
        {"audio": np.zeros(3200, np.float32), "text": "hi"},
        {"audio": np.zeros(6400, np.float32), "text": "yo"},
    ]
    n = extract.extract_spark_tokens(
        samples, FakeSparkTokenizer(), out,
        properties_fn=lambda s: {"gender": "female"},
    )
    assert n == 2
    rows = [json.loads(l) for l in open(out)]
    assert rows[0]["text"] == "hi"
    assert len(rows[0]["global_tokens"]) == 32
    assert len(rows[0]["semantic_tokens"]) == 10
    assert rows[0]["gender"] == "female"


def test_extract_cosy_tokens(tmp_path):
    out = str(tmp_path / "cosy.jsonl")
    n = extract.extract_cosy_tokens(
        [{"audio": np.zeros(1600, np.float32), "text": "t"}],
        speech_tokenizer_fn=lambda w: [1, 2, 3],
        out_path=out,
    )
    assert n == 1
    row = json.loads(open(out).read())
    assert row["tts_speech_tokens"] == [1, 2, 3]
    assert "llm_prompt_speech_token" in row


def test_run_sharded_single(tmp_path):
    shards = []
    for i in range(2):
        p = str(tmp_path / f"s{i}.txt")
        open(p, "w").write("x")
        shards.append(p)

    def worker(shard, out):
        open(out, "w").write("1\n")
        return 1

    total = extract.run_sharded(shards, worker, str(tmp_path / "out"))
    assert total == 2
    assert len(os.listdir(tmp_path / "out")) == 2


@pytest.mark.parametrize(
    "num_workers,gpus,want",
    [
        (4, [], [None] * 4),  # CPU host: the count stands
        (4, ["0", "1"], ["0", "1"]),  # never more workers than cards
        (2, ["0", "1", "2", "3"], ["0", "1"]),  # one card each
        (0, ["3"], ["3"]),
    ],
)
def test_assign_workers_one_card_each(num_workers, gpus, want):
    assert extract.assign_workers(num_workers, gpus) == want


def test_visible_gpus_from_env(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2, 5")
    assert extract.visible_gpus() == ["2", "5"]
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert extract.visible_gpus() == []


def test_pin_worker_card_sets_cuda_visible_devices(monkeypatch):
    import queue

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    q = queue.Queue()
    q.put("3")
    extract._pin_worker_card(q)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "3"
