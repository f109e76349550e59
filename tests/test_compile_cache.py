"""The persistent compilation cache location (utils/compile_cache.py)."""
from pathlib import Path

import jax
import pytest

import bowtie2_server_tpu
from bowtie2_server_tpu.utils import compile_cache


@pytest.fixture
def cache_config():
    """Restore JAX's cache-dir setting after the test."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_set_means_untouched(monkeypatch, tmp_path, cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "elsewhere"))
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir is None
    assert not (tmp_path / "elsewhere").exists()


@pytest.mark.parametrize("cwd", ["tmp_path", "root"])
def test_unset_means_checkout_tmp_from_any_cwd(monkeypatch, tmp_path, cwd,
                                               cache_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.chdir(tmp_path if cwd == "tmp_path" else "/")
    checkout = Path(bowtie2_server_tpu.__file__).resolve().parent.parent
    expected = checkout / "tmp" / "jax_cache"
    assert compile_cache.default_cache_dir() == expected
    assert compile_cache.enable_compile_cache() == expected
    assert jax.config.jax_compilation_cache_dir == str(expected)
    assert expected.is_dir()
    assert not (tmp_path / "tmp").exists()


def test_uncreatable_dir_is_reported(monkeypatch, tmp_path, capsys,
                                     cache_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setattr(compile_cache, "default_cache_dir",
                        lambda: blocker / "jax_cache")
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir is None
    assert "compilation cache disabled" in capsys.readouterr().err
