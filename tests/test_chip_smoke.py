"""The CPU-testable parts of chip_smoke.py and its helpers
(rwkvtts_tpu/utils/chip_checks.py): the device check, the result line, the
nvidia-smi parser, the compile-cache directory, the four-card comparisons
on the virtual mesh, and every phase rehearsed at a tiny size."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from rwkvtts_tpu.utils import chip_checks, jit_cache, profiling

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- device facts and the result line ---------------------------------------


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_checks.require_gpu()
    with pytest.raises(RuntimeError, match="'cpu'"):
        chip_checks.require_gpu("cpu")
    chip_checks.require_gpu("gpu")


def test_result_line_schema():
    line = chip_checks.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    )
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    obj = json.loads(line)
    assert set(obj) == {"ok", "device"}
    assert set(obj["device"]) == {"platform", "kind", "count"}


def test_parse_smi():
    text = "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 400.00 W\n"
    assert chip_checks.parse_smi(text) == [
        ("NVIDIA H100 80GB HBM3", 700.0), ("NVIDIA H100 80GB HBM3", 400.0),
    ]


@pytest.mark.parametrize("bad", ["NVIDIA H100 80GB HBM3", "H100, [N/A]", ""])
def test_parse_smi_rejects(bad):
    if bad:
        with pytest.raises(ValueError):
            chip_checks.parse_smi(bad)
    else:
        assert chip_checks.parse_smi(bad) == []


def test_check_close_reports_tolerance():
    tol = chip_checks.Tolerance(1e-3, "why")
    assert chip_checks.check_close("x", [1.0, 2.0], [1.0, 2.0], tol) == 0.0
    with pytest.raises(AssertionError, match=r"> 0.001 \(why\)"):
        chip_checks.check_close("x", [1.0, 2.1], [1.0, 2.0], tol)
    with pytest.raises(AssertionError, match="non-finite"):
        chip_checks.check_close("x", [np.nan, 2.0], [1.0, 2.0], tol)


def test_busy_ns_is_interval_union():
    assert profiling.busy_ns([]) == 0
    assert profiling.busy_ns([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25


# -- compile cache ------------------------------------------------------------


def test_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jit_cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jit_cache.cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_cache_dir_never_temporary(monkeypatch):
    """The default is a fixed path in the checkout: no temp dir, pid or
    time in it, so a later process finds the same cache."""
    import tempfile

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = jit_cache.cache_dir()
    assert not d.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in d
    assert d == jit_cache.cache_dir()


def test_cache_disabled_on_cpu():
    assert jit_cache.enable() is None
    assert not jax.config.jax_enable_compilation_cache


# -- the script itself refuses to run without a GPU or without the repo --------


def _run_script(cwd, env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _no_result(proc):
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    return proc.returncode != 0 and '"ok"' not in last


def test_script_fails_on_cpu():
    assert _no_result(_run_script(ROOT, {"JAX_PLATFORMS": "cpu"}))


def test_script_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert _no_result(proc)
    assert "rwkvtts_tpu" in proc.stderr


# -- four-card comparisons on the virtual mesh -----------------------------------


@pytest.mark.parametrize("shape", [{"dp": 2, "fsdp": 2}, {"fsdp": 2, "tp": 2}],
                         ids=["dp2xfsdp2", "fsdp2xtp2"])
def test_sharded_train_step_matches_one_device(cs, shape):
    """The --four train-step comparison, at a tiny width: a sharded step's
    loss and weight update agree with the one-device step within the
    tolerances chip_smoke.py states, and the mesh uses four distinct
    devices."""
    from rwkvtts_tpu.models import spark
    from rwkvtts_tpu.parallel import mesh as mesh_lib

    cfg = spark.default_config(hidden_size=64, num_layers=2, wkv_chunk=16)
    params = chip_checks.spark_params(cfg, bf16_tables=False)
    batch = chip_checks.spark_packed_batch(4, 256)
    key = jax.random.PRNGKey(3)
    tol = cs.four_tolerances()
    loss0, _, p0 = chip_checks.train_step_once(cfg, params, batch, key)
    mesh = mesh_lib.make_mesh(**shape)
    assert len({d.id for d in mesh.devices.flat}) == 4
    loss, _, p = chip_checks.train_step_once(cfg, params, batch, key, mesh=mesh)
    chip_checks.check_close("loss", np.float64(loss), np.float64(loss0), tol["loss"])
    old = jax.tree.map(np.asarray, params)
    d = lambda q: jax.tree.map(lambda n, o: n - o, q, old)
    assert any(np.any(x != 0) for x in jax.tree.leaves(d(p0)))
    assert chip_checks.tree_rel_err(d(p), d(p0)) <= tol["update"].rel


# -- the phases, rehearsed at a tiny size -------------------------------------


def test_phase_decode_rehearsal(cs, capsys):
    tps = cs.phase_decode(hidden=64, layers=2, batch=4, prompt=16, new=8,
                          reps=1, steps=4, rows=2)
    assert tps > 0
    out = capsys.readouterr().out
    assert out.count("decode parity") == 4  # logits + wkv, two carries


def test_phase_serving_rehearsal(cs, capsys):
    import golden_configs

    cs.phase_serving(hidden=64, layers=2, n_slots=4, caps=(3, 5, 6, 9),
                     codec_cfg=golden_configs.bicodec_config())
    assert capsys.readouterr().out.count("served:") == 4


def test_phase_train_rehearsal(cs, capsys):
    cs.phase_train(hidden=64, layers=2, batch=2, seq=256, steps=2)
    out = capsys.readouterr().out
    assert "train:" in out and "docs=" in out


def test_peak_table_keyed_by_device_kind():
    assert chip_checks.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(KeyError, match="no bf16 peak"):
        chip_checks.peak_bf16_flops("Some Other Accelerator")
