"""Persistent compilation cache placement (tpusolve.runtime)."""

import os

import jax
import pytest

from tpusolve import runtime


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_variable_wins(monkeypatch, tmp_path, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    # neither the CLI key nor the default may replace it
    assert runtime.enable_compile_cache("/elsewhere") == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_inside_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = runtime.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_cli_key_used_without_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.enable_compile_cache(str(tmp_path)) == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
