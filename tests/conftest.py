"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-card hardware is not available to the test suite; sharding logic is
validated against XLA's host-platform device virtualization instead (the
same GSPMD partitioner runs either way). Tests that need a GPU carry the
`gpu` marker and skip here (see `gpu_only`).
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
# XLA:CPU executables reloaded from a persistent cache are not portable
# across hosts; tests always compile fresh
jax.config.update("jax_enable_compilation_cache", False)

import gc  # noqa: E402

import pytest  # noqa: E402


# Fast-lane modules (pytest -m fast): data/frontend/tooling
# tests with little or no XLA compilation — the <5-min tier a session runs
# after every change. Everything else is implicitly the nightly tier
# (pytest -m "not fast" or the plain full run).
_FAST_MODULES = frozenset({
    "test_tokenizer", "test_text_frontend", "test_zh_tn", "test_instructions",
    "test_corpus_tools", "test_misc_tools", "test_native_tar",
    "test_native_tokenizer", "test_webdataset_extract", "test_sfm_collator",
    "test_mp3", "test_onnx_profiling", "test_eval",
})


def pytest_collection_modifyitems(config, items):
    """Auto-mark the fast lane."""
    for item in items:
        name = item.fspath.purebasename
        item.add_marker(
            pytest.mark.fast if name in _FAST_MODULES else pytest.mark.nightly
        )


@pytest.fixture
def gpu_only():
    """Skip unless JAX sees a GPU; tests marked `gpu` request it.
    Decided inside the fixture, never at import or collection time, so
    every xdist worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card through chip_smoke.py)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables + traced jaxprs after each test module.

    The full 47-file suite accumulates every module's compiled CPU
    programs; late modules' XLA:CPU compiles then die in LLVM under memory
    pressure (segfault in backend_compile_and_load). Per-module clearing
    keeps the process bounded; individual files are unaffected."""
    yield
    jax.clear_caches()
    gc.collect()
