"""The one persistent-compile-cache location every entry point uses."""

from pathlib import Path

from cheeta_mpc.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def test_env_var_wins_and_nothing_is_set(monkeypatch):
    import jax
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert compile_cache.compile_cache_dir("sub") == "/some/cache"
    assert compile_cache.enable_compile_cache("sub", 0.0) == "/some/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_and_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.compile_cache_dir()
    assert first == compile_cache.compile_cache_dir()
    assert Path(first) == REPO / ".jax_cache"
    assert compile_cache.compile_cache_dir("cpu_x") == str(
        REPO / ".jax_cache" / "cpu_x")
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
