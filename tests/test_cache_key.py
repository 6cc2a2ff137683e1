"""Persistent-cache policy: GPU runs cache compiled executables under the
fixed ``<repo>/.cache/xla``; the CPU keeps none; a directory named by
``JAX_COMPILATION_CACHE_DIR`` is used as it is, and nothing else is set."""

import os

import jax

import hpddm_tpu
from hpddm_tpu import _cache_location, _enable_persistent_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(hpddm_tpu.__file__)))


def test_cache_disabled_on_cpu_backend():
    # The test suite runs on the CPU backend (conftest): hpddm_tpu must NOT
    # have pointed jax at a persistent cache there — XLA:CPU entries are
    # host-specific machine code.
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # user opted in explicitly
    assert jax.default_backend() == "cpu"
    loc = jax.config.jax_compilation_cache_dir
    assert not loc, loc


def test_cache_location_policy():
    assert _cache_location("cpu") is None
    assert _cache_location("gpu") == os.path.join(REPO, ".cache", "xla")


def _enable_with(monkeypatch, env_dir):
    """Run the import-time hook as on a GPU, with or without
    JAX_COMPILATION_CACHE_DIR; returns the directory jax ends up with."""
    import hpddm_tpu.device as device
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    before = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    try:
        _enable_persistent_compile_cache()
        return jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_gpu_uses_fixed_repo_cache(monkeypatch):
    assert _enable_with(monkeypatch, None) == \
        os.path.join(REPO, ".cache", "xla")


def test_env_cache_dir_is_left_alone(tmp_path, monkeypatch):
    # the variable is jax's own: the program sets no other directory
    assert _enable_with(monkeypatch, str(tmp_path)) is None
