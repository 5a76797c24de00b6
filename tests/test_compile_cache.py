"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR wins untouched;
otherwise a fixed, git-ignored directory inside the checkout."""
import os

import jax

from mcpt import compile_cache

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_default_cache_is_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_env_cache_dir_is_left_to_jax(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set
