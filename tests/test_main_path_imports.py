"""The evaluation CLI runs with only JAX, numpy and scipy installed.

The card's host is only sure to have numpy, scipy, optax, chex, einops,
pytest and hypothesis beside JAX. A child process blocks the optional
packages with a ``sys.meta_path`` finder and runs the benchmark CLI on the
demo fixtures (``tools/gen_demo_fixtures.py``); their analytic values are
RMSE = sqrt(2) and ACC = 0.5.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('pandas', 'pyarrow', 'h5py', 'fsspec', 'xarray')

CHILD = textwrap.dedent('''
    import sys

    BLOCKED = {blocked!r}

    class Blocker:
      def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
          raise ImportError(f'{{name}} is blocked in this test')
        return None

    sys.meta_path.insert(0, Blocker())
    sys.path.insert(0, {checkout!r})
    from weatherbenchx_tpu.apps import run_benchmark_evaluation
    run_benchmark_evaluation.main({argv!r})
    loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    assert not loaded, loaded
''')


def test_cli_runs_without_optional_packages(tmp_path):
  sys.path.insert(0, os.path.join(CHECKOUT, 'tools'))
  try:
    import gen_demo_fixtures
  finally:
    sys.path.pop(0)
  gen_demo_fixtures.main(str(tmp_path))
  out = tmp_path / 'out'
  argv = [
      '--prediction=hres', f'--prediction_path={tmp_path}/hres.npz',
      f'--target_path={tmp_path}/era5.npz',
      f'--climatology_path={tmp_path}/clim.npz', '--resolution=64x32',
      '--year=2020', '--init_time_start=2020-01-01',
      '--init_time_stop=2020-01-03', '--lead_time_stop_days=2',
      '--variables=geopotential,2m_temperature', '--levels=500,850',
      f'--compilation_cache_dir={tmp_path}/cache', f'--output_dir={out}']
  env = dict(os.environ, JAX_PLATFORMS='cpu')
  env.pop('JAX_COMPILATION_CACHE_DIR', None)
  proc = subprocess.run(
      [sys.executable, '-c', CHILD.format(blocked=BLOCKED, checkout=CHECKOUT,
                                          argv=argv)],
      env=env, capture_output=True, text=True, timeout=600)
  assert proc.returncode == 0, proc.stderr[-3000:]

  from weatherbenchx_tpu import io as io_lib
  (name,) = os.listdir(out)
  results = io_lib.load_dataset(str(out / name))
  for v in ('geopotential', '2m_temperature'):
    rmse = np.asarray(results[f'rmse.{v}'].sel(region='global').values)
    acc = np.asarray(results[f'acc.{v}'].sel(region='global').values)
    # 4 inits x 2048 gridpoints per lead: a few percent of sampling error.
    np.testing.assert_allclose(rmse, np.sqrt(2), rtol=0.15)
    np.testing.assert_allclose(acc, 0.5, atol=0.12)
