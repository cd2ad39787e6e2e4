"""Where the persistent compilation cache resolves (``compile_cache``)."""

import os

import jax
import pytest

from weatherbenchx_tpu import compile_cache

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
  before = jax.config.jax_compilation_cache_dir
  yield
  jax.config.update('jax_compilation_cache_dir', before)


def test_default_is_inside_the_checkout(monkeypatch):
  monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
  assert compile_cache.cache_dir() == os.path.join(CHECKOUT, '.jax_cache')


def test_explicit_directory_applies_without_the_variable(monkeypatch,
                                                          tmp_path):
  monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
  assert compile_cache.cache_dir(str(tmp_path)) == str(tmp_path)


@pytest.mark.parametrize('explicit', [None, 'elsewhere'])
def test_environment_variable_wins(monkeypatch, tmp_path, explicit):
  monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
  assert compile_cache.cache_dir(explicit) == str(tmp_path)


def test_enable_sets_jax_config_only_without_the_variable(
    monkeypatch, tmp_path, restore_cache_dir):
  monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
  assert compile_cache.enable(str(tmp_path)) == str(tmp_path)
  assert jax.config.jax_compilation_cache_dir == str(tmp_path)
  jax.config.update('jax_compilation_cache_dir', None)
  monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / 'env'))
  assert compile_cache.enable('ignored') == str(tmp_path / 'env')
  assert jax.config.jax_compilation_cache_dir is None
