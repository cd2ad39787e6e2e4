"""Regenerates docs/api.md from package docstrings.

Usage: python tools/gen_api_doc.py
"""

import importlib
import inspect
import io
import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), '..')))

import jax

MODULES = [
    'weatherbenchx_tpu.darray',
    'weatherbenchx_tpu.time_chunks',
    'weatherbenchx_tpu.tree',
    'weatherbenchx_tpu.io',
    'weatherbenchx_tpu.lazy',
    'weatherbenchx_tpu.zarr_io',
    'weatherbenchx_tpu.codecs',
    'weatherbenchx_tpu.netcdf_io',
    'weatherbenchx_tpu.fileio',
    'weatherbenchx_tpu.aggregation',
    'weatherbenchx_tpu.weighting',
    'weatherbenchx_tpu.binning',
    'weatherbenchx_tpu.interpolations',
    'weatherbenchx_tpu.metrics.base',
    'weatherbenchx_tpu.metrics.deterministic',
    'weatherbenchx_tpu.metrics.probabilistic',
    'weatherbenchx_tpu.metrics.categorical',
    'weatherbenchx_tpu.metrics.spatial',
    'weatherbenchx_tpu.metrics.wrappers',
    'weatherbenchx_tpu.data.base',
    'weatherbenchx_tpu.data.loaders',
    'weatherbenchx_tpu.data.sparse_parquet',
    'weatherbenchx_tpu.data.latency_wrappers',
    'weatherbenchx_tpu.parallel.evaluator',
    'weatherbenchx_tpu.parallel.pipeline',
    'weatherbenchx_tpu.parallel.unaggregated',
    'weatherbenchx_tpu.inference.base',
    'weatherbenchx_tpu.inference.autodiff',
    'weatherbenchx_tpu.inference.t_test',
    'weatherbenchx_tpu.inference.bootstrap',
    'weatherbenchx_tpu.inference.block_length',
    'weatherbenchx_tpu.inference.baseline_comparison',
    'weatherbenchx_tpu.ops.conv',
    'weatherbenchx_tpu.ops.interp',
    'weatherbenchx_tpu.ops.ensemble_stats',
    'weatherbenchx_tpu.native',
    'weatherbenchx_tpu.observability',
    'weatherbenchx_tpu.compile_cache',
    'weatherbenchx_tpu.datetimes',
    'weatherbenchx_tpu.test_utils',
]


def _first_line(obj) -> str:
  doc = inspect.getdoc(obj) or ''
  return doc.split('\n')[0].strip()


def main() -> None:
  jax.config.update('jax_platforms', 'cpu')
  out = io.StringIO()
  out.write('# API reference\n\n')
  out.write('One line per public symbol, generated from docstrings '
            '(`python tools/gen_api_doc.py`). The analogue of the '
            "reference's `docs/source/api/*.md` pages.\n")
  for name in MODULES:
    module = importlib.import_module(name)
    out.write(f'\n## `{name}`\n\n')
    module_doc = inspect.getdoc(module)
    if module_doc:
      out.write(module_doc.split('\n')[0].strip() + '\n\n')
    rows = []
    for sym in sorted(vars(module)):
      if sym.startswith('_'):
        continue
      obj = vars(module)[sym]
      if inspect.ismodule(obj):
        continue
      if getattr(obj, '__module__', None) != name:
        continue
      if inspect.isclass(obj):
        rows.append((f'`{sym}`', 'class', _first_line(obj)))
      elif inspect.isfunction(obj):
        rows.append((f'`{sym}`', 'fn', _first_line(obj)))
    if rows:
      out.write('| Symbol | Kind | Summary |\n|---|---|---|\n')
      for sym, kind, summary in rows:
        out.write(f"| {sym} | {kind} | {summary.replace('|', chr(92) + '|')} |\n")
  path = os.path.join(os.path.dirname(__file__), '..', 'docs', 'api.md')
  with open(os.path.abspath(path), 'w') as f:
    f.write(out.getvalue())
  print(f'Wrote docs/api.md ({len(out.getvalue())} bytes)')


if __name__ == '__main__':
  main()
