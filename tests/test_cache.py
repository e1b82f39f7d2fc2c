"""Persistent compilation cache location (utils/cache.py)."""

from pathlib import Path

import jax

from singlecarrier_tpu.utils import cache


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: that directory is the cache and
    the code sets no other."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.append((k, v)))
    assert cache.compilation_cache_dir() == str(tmp_path)
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in dict(seen)


def test_cache_dir_defaults_inside_checkout(monkeypatch):
    """Unset: the fixed path <repo>/.jax_cache, which git ignores."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.append((k, v)))
    repo = Path(__file__).resolve().parents[1]
    want = str(repo / ".jax_cache")
    assert cache.compilation_cache_dir() == want
    assert cache.enable_compilation_cache() == want
    assert dict(seen)["jax_compilation_cache_dir"] == want
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()
