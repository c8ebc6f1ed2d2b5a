"""Where the persistent compilation cache lands."""

import os

import jax
import pytest

from cpecan_tpu.utils import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert jaxcache.cache_dir() == str(tmp_path)
    assert jaxcache.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing here overrides it
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("platform", ["gpu", "cuda"])
def test_cache_dir_fixed_in_checkout(monkeypatch, platform):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jaxcache, "_configured_platform", lambda: platform)
    expect = os.path.join(REPO, ".jax_cache")
    assert jaxcache.cache_dir() == expect
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        assert jaxcache.enable_compilation_cache() == expect
        assert jax.config.jax_compilation_cache_dir == expect
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old_min)


def test_cache_off_on_cpu(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jaxcache, "_configured_platform", lambda: "cpu")
    assert jaxcache.enable_compilation_cache() is None
