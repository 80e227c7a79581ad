"""End-to-end trainer test: tiny spark model on synthetic jsonl data,
loss decreases, checkpoint save + resume restores exactly."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rwkvtts_tpu.data import jsonl_dataset, spark_collator
from rwkvtts_tpu.models import spark
from rwkvtts_tpu.train import checkpoint as ckpt_lib
from rwkvtts_tpu.train import trainer as trainer_lib


class FakeTok:
    def encode(self, text):
        return [ord(c) % 200 + 1 for c in text][:12]


def _rows(n=16):
    rng = np.random.default_rng(0)
    return [
        {
            "text": "hello world %d" % i,
            "global_tokens": rng.integers(0, 4096, 4).tolist(),
            "semantic_tokens": rng.integers(0, 100, 20).tolist(),
        }
        for i in range(n)
    ]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = spark.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
        dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    run_dir = str(tmp_path_factory.mktemp("run"))
    tcfg = trainer_lib.TrainerConfig(
        run_dir=run_dir, epochs=1, save_steps=2, log_every=1,
        peak_lr=1e-3, final_lr=1e-4, warmup_steps=2, total_steps=20,
        mesh_shape={"dp": 1},
    )
    return cfg, params, tcfg


def _dataset():
    import functools

    collate = functools.partial(
        spark_collator.collate_plain, tokenizer=FakeTok(), eos_id=8192, pad_to=48
    )
    return jsonl_dataset.JsonlDataset(_rows(), collate, batch_size=4, seed=0)


def test_fit_and_resume(setup):
    cfg, params, tcfg = setup
    tr = trainer_lib.Trainer(cfg, params, trainer_lib.spark_loss, tcfg)
    ds = _dataset()
    state = tr.fit(ds)
    assert int(state.step) == 4  # 16 rows / batch 4 = 4 steps

    # metrics file written
    mpath = os.path.join(tcfg.run_dir, "metrics.jsonl")
    recs = [json.loads(l) for l in open(mpath)]
    assert len(recs) >= 4
    assert all(np.isfinite(r["loss"]) for r in recs)
    # loss should drop from step 1 to step 4 on this memorizable set
    assert recs[-1]["loss"] < recs[0]["loss"] + 1.0

    # checkpoints rotated: only the newest `keep` remain
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(tr.ckpt_dir) if d.startswith("step_")
    )
    assert len(steps) <= tcfg.keep_checkpoints
    assert steps[-1] == 4

    # resume restores the exact state (fresh params: the originals were
    # donated to the jitted step)
    params2 = spark.init_params(jax.random.PRNGKey(7), cfg)
    tr2 = trainer_lib.Trainer(cfg, params2, trainer_lib.spark_loss, tcfg)
    assert tr2.maybe_resume()
    assert int(tr2.state.step) == 4
    l1 = jax.tree_util.tree_leaves(state.params)
    l2 = jax.tree_util.tree_leaves(tr2.state.params)
    for a, b in zip(l1, l2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_token_budget_clamp():
    collate = lambda rows: {"n": np.array(len(rows))}
    rows = _rows(8)
    ds = jsonl_dataset.JsonlDataset(rows, collate, batch_size=4, seed=0, max_tokens=30)
    batches = list(ds.epoch(0))
    # each row costs ~20 semantic tokens + text: budget 30 forces shrink to 1
    assert all(int(b["n"]) == 1 for b in batches)


def test_jsonl_loader_sharding(tmp_path):
    path = tmp_path / "d.jsonl"
    with open(path, "w") as f:
        for i in range(10):
            f.write(json.dumps({"i": i}) + "\n")
    r0 = jsonl_dataset.load_jsonl_rows([str(path)], 0, 2)
    r1 = jsonl_dataset.load_jsonl_rows([str(path)], 1, 2)
    assert [r["i"] for r in r0] == [0, 2, 4, 6, 8]
    assert [r["i"] for r in r1] == [1, 3, 5, 7, 9]


def test_static_batch_metadata_reaches_loss(setup):
    """'_'-prefixed collator metadata must reach the loss as static python
    values and specialize the trace (regression: s2s _is_text was silently
    dropped, training the text head on audio batches)."""
    cfg, _, tcfg = setup
    # fresh params: the fixture's were donated to the first test's step_fn
    params = spark.init_params(jax.random.PRNGKey(3), cfg)
    seen = []

    def probe_loss(params, cfg, batch, rng):
        seen.append(bool(batch.get("_is_text", True)))
        loss, n = trainer_lib.spark_loss(params, cfg, batch, rng)
        return loss, n

    tr = trainer_lib.Trainer(cfg, params, probe_loss, tcfg)

    class TwoModeDataset:
        def epoch(self, epoch, start_batch=0):
            base = _dataset()
            for i, b in enumerate(base.epoch(epoch, start_batch)):
                b = dict(b)
                b["_is_text"] = i % 2 == 0
                yield b
                if i == 1:
                    return

    tcfg.save_steps = 0
    tr.fit(TwoModeDataset())
    # one trace per metadata value, each observing its own static bool
    assert True in seen and False in seen
    assert len(tr._step_cache) >= 2


@pytest.mark.parametrize("mode", ["mu_bf16", "adafactor"])
def test_low_memory_optimizer_steps(setup, mode):
    """Low-memory optimizer modes (single-host answer to the reference's
    ZeRO-3 CPU-offload for its 1.5B LM, train_..._properties.py:377-387)
    must keep the group policy, shrink the state, and still learn."""
    from rwkvtts_tpu.parallel import train_step as ts
    from rwkvtts_tpu.train import optimizer as opt_lib

    cfg, _, _ = setup
    params = spark.init_params(jax.random.PRNGKey(4), cfg)
    tx = opt_lib.build_optimizer(
        params, peak_lr=1e-3, warmup_steps=1, total_steps=10,
        low_memory=mode,
    )
    state = ts.init_train_state(params, tx)

    leaves = jax.tree_util.tree_leaves(state.opt_state)
    if mode == "adafactor":
        # factoring engages only for dims >= optax's min_dim_size_to_factor
        # (128) — the tiny test model never factors, so check the state
        # shrinkage on a realistically-shaped tree instead
        big = {"w": jnp.zeros((1024, 4096))}
        tx_big = opt_lib.build_optimizer(
            big, peak_lr=1e-3, warmup_steps=1, total_steps=10,
            low_memory=mode,
        )
        st_big = tx_big.init(big)
        fp32_state = sum(
            l.size * 4 for l in jax.tree_util.tree_leaves(st_big)
            if hasattr(l, "dtype") and l.dtype == jnp.float32
        )
        # factored second moment: O(rows+cols) << one fp32 param copy
        assert fp32_state < 0.05 * big["w"].size * 4
    else:
        # mu stored bf16: the first moment must not be fp32
        assert any(
            hasattr(l, "dtype") and l.dtype == jnp.bfloat16 for l in leaves
        )

    step = ts.make_train_step(cfg, tx, donate=False)
    b = _dataset()
    batch = next(iter(b.epoch(0)))
    batch = {k: v for k, v in batch.items() if not k.startswith("_")}
    losses = []
    for i in range(4):
        state, metrics = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]  # same batch repeated: must descend


def test_preemption_checkpoint_and_resume(tmp_path):
    """SIGTERM-style preemption (the spot-reclaim path): the trainer
    checkpoints the mid-epoch position at the next step boundary, exits
    fit() cleanly, and --resume continues from the NEXT batch."""
    import os as _os
    import signal
    import threading

    cfg = spark.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
        dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0,
    )
    params = spark.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = trainer_lib.TrainerConfig(
        run_dir=str(tmp_path), epochs=1, save_steps=0, log_every=100,
        peak_lr=1e-3, final_lr=1e-4, warmup_steps=2, total_steps=20,
        mesh_shape={"dp": 1},
    )
    tr = trainer_lib.Trainer(cfg, params, trainer_lib.spark_loss, tcfg)
    tr.install_preemption_handler()
    # deliver a real SIGTERM once the first step has run (the handler only
    # sets a flag, so delivery timing is safe anywhere in the loop)
    threading.Timer(
        0.01, lambda: _os.kill(_os.getpid(), signal.SIGTERM)
    ).start()
    state = tr.fit(_dataset())
    assert state is not None
    saved_step = int(state.step)
    assert 1 <= saved_step < 4  # stopped early, after a whole step

    params2 = spark.init_params(jax.random.PRNGKey(7), cfg)
    tr2 = trainer_lib.Trainer(cfg, params2, trainer_lib.spark_loss, tcfg)
    assert tr2.maybe_resume()
    assert int(tr2.state.step) == saved_step
    final = tr2.fit(_dataset())
    assert int(final.step) == 4  # completes the epoch from the saved batch


def test_checkpoint_npz_roundtrip_and_rotation(tmp_path):
    """Checkpoints are numpy .npz + meta json: bf16, fp32 and int leaves
    come back bit-exact in their dtypes, sharded leaves keep the sharding
    of the abstract state, and only the newest `keep` steps remain."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rwkvtts_tpu.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(dp=2)
    sh = NamedSharding(mesh, P("dp"))
    state = {
        "w": jax.device_put(
            jnp.arange(8, dtype=jnp.float32).reshape(4, 2) / 3, sh),
        "b": jnp.linspace(-1, 1, 5).astype(jnp.bfloat16),
        "step": jnp.int32(7),
    }
    for step in (1, 2, 3):
        ckpt_lib.save(str(tmp_path), step, state, meta={"epoch": step}, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    assert ckpt_lib.latest_step(str(tmp_path)) == 3
    like = jax.tree.map(jnp.zeros_like, state)
    like["w"] = jax.device_put(like["w"], sh)
    got, meta = ckpt_lib.restore(str(tmp_path), like)
    assert meta == {"epoch": 3}
    for k in state:
        assert got[k].dtype == state[k].dtype
        np.testing.assert_array_equal(
            np.asarray(got[k], np.float32), np.asarray(state[k], np.float32)
        )
    assert got["w"].sharding == sh
    with pytest.raises(ValueError, match="shape"):
        ckpt_lib.restore(str(tmp_path), {**like, "b": jnp.zeros(4, jnp.bfloat16)})
