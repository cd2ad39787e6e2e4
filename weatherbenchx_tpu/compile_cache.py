"""Where the persistent XLA compilation cache lives.

One rule for every entry point (the CLIs, ``bench.py``, ``chip_smoke.py``
and the tools): ``JAX_COMPILATION_CACHE_DIR``, when set, wins and JAX reads
it itself; otherwise an explicit directory, if the caller has one;
otherwise ``<checkout>/.jax_cache``. A fixed path matters because the path
is part of the cache's key: a directory that moves never hits.
"""

import os
from typing import Optional

ENV_VAR = 'JAX_COMPILATION_CACHE_DIR'
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), '.jax_cache')


def cache_dir(explicit: Optional[str] = None) -> str:
  """The directory the cache resolves to under the rule above."""
  return os.environ.get(ENV_VAR) or explicit or DEFAULT_DIR


def enable(explicit: Optional[str] = None) -> str:
  """Points JAX's persistent compilation cache at :func:`cache_dir`.

  Call before the first compilation. Sets nothing when the environment
  variable is set, since JAX already uses it. Returns the directory.
  """
  import jax

  path = cache_dir(explicit)
  if not os.environ.get(ENV_VAR):
    jax.config.update('jax_compilation_cache_dir', path)
  return path
