"""The persistent compilation cache: where it goes, and when it is set."""

import jax
import pytest

from chromosight_tpu import config


@pytest.fixture()
def cache_state(monkeypatch):
    """Record jax.config updates instead of applying them."""
    updates = {}
    monkeypatch.setattr(jax.config, "update", updates.__setitem__)
    return updates


def test_default_dir_is_one_fixed_path_in_the_checkout():
    import pathlib

    repo = pathlib.Path(config.__file__).resolve().parents[1]
    assert config.DEFAULT_CACHE_DIR == repo / ".jax_cache"
    assert config.DEFAULT_CACHE_DIR == config.DEFAULT_CACHE_DIR.resolve()


def test_env_dir_is_honoured_and_never_overridden(
    cache_state, monkeypatch, tmp_path
):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    config.init_compilation_cache()
    assert "jax_compilation_cache_dir" not in cache_state


def test_unset_env_uses_the_default_dir_on_an_accelerator(
    cache_state, monkeypatch, tmp_path
):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(config, "DEFAULT_CACHE_DIR", tmp_path / ".jax_cache")
    config.init_compilation_cache()
    assert cache_state["jax_compilation_cache_dir"] == str(tmp_path / ".jax_cache")
    assert (tmp_path / ".jax_cache").is_dir()


def test_unset_env_on_cpu_sets_no_cache(cache_state, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    config.init_compilation_cache()
    assert "jax_compilation_cache_dir" not in cache_state


def test_uncreatable_cache_dir_is_reported(
    cache_state, monkeypatch, tmp_path, capsys
):
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(config, "DEFAULT_CACHE_DIR", blocker / ".jax_cache")
    config.init_compilation_cache()
    assert "jax_compilation_cache_dir" not in cache_state
    assert "no compilation cache" in capsys.readouterr().err
