"""Utilities: the compile-cache location and the GPU marker's fixture."""

import pathlib

import jax
import pytest

from chowdsp_fft_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    path = pathlib.Path(compile_cache.cache_dir())
    assert path == REPO / ".jax_cache"
    assert compile_cache.cache_dir() == str(path)  # no temp/pid/time part
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored, ".jax_cache must be listed in .gitignore"


def test_enable_sets_the_env_directory(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.gpu
def test_default_backend_is_gpu(gpu_only):
    """On the card, JAX's default backend is the GPU and the xla engine
    compiles for it."""
    import numpy as np

    import chowdsp_fft_tpu as cf

    assert jax.default_backend() == "gpu"
    x = np.random.default_rng(0).standard_normal((4, 4096)).astype(np.float32)
    back = np.asarray(jax.jit(lambda v: cf.irfft(cf.rfft(v)))(x)) / 4096
    assert np.abs(back - x).max() < 2e-7 * 4096
