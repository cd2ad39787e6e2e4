"""The fused ensemble-statistics kernel against XLA's plain form, on a GPU.

Two layers, each timed as the median of individually dispatched calls
ended by ``block_until_ready``, the two forms alternating (plain, kernel,
kernel, plain) inside one process:

* ``op``: the four statistics alone on an (M, 1, 4, 721, 1440) float32
  ensemble — the kernel, against the jnp form XLA compiles (member-last
  transpose, sort, order-statistic sum, then the skill and the moments).
* ``step``: the probabilistic scorecard's jitted evaluation step (CRPS,
  unbiased spread/skill, unbiased ensemble-mean RMSE; 34 region bins,
  area weights, masked), with the kernel and with ``kernel_for``
  returning None, which is what every other backend runs.

It also times the two ensemble forms that have no kernel (``plain``): the
standalone CRPS spread (sort form, outside a fused compute pass) on the
same ensemble, and the two-ensemble CRPS skill at (M/2, M/2, 1, 4, 721,
1440).

Usage:
  python tools/ensemble_stats_bench.py [--members 50] [--reps 20]
Prints one JSON line.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _median_ms(fn, *args, reps):
  import jax
  jax.block_until_ready(fn(*args))
  times = []
  for _ in range(reps):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    times.append(time.perf_counter() - t0)
  return float(np.median(times)) * 1e3


def plain_stats(x, y):
  """The four statistics as XLA compiles them without the kernel."""
  import jax.numpy as jnp
  m = x.shape[0]
  ordered = jnp.sort(jnp.moveaxis(x, 0, -1), axis=-1)
  coeff = (2 * jnp.arange(1, m + 1) - m - 1).astype(x.dtype)
  mean = x.mean(0)
  return (2 * jnp.sum(coeff * ordered, -1), jnp.abs(x - y).sum(0), mean,
          ((x - mean) ** 2).sum(0))


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument('--members', type=int, default=50)
  ap.add_argument('--reps', type=int, default=20)
  args = ap.parse_args()

  import jax
  if jax.default_backend() != 'gpu':
    sys.exit(f'no GPU (JAX backend {jax.default_backend()!r})')
  from weatherbenchx_tpu import aggregation, binning, compile_cache
  from weatherbenchx_tpu import weighting
  from weatherbenchx_tpu.apps import configs
  from weatherbenchx_tpu.darray import DimArray
  from weatherbenchx_tpu.metrics import probabilistic
  from weatherbenchx_tpu.ops import ensemble_stats
  from weatherbenchx_tpu.parallel import evaluator as evaluator_lib
  compile_cache.enable()

  m, shape = args.members, (1, 4, 721, 1440)
  rng = np.random.default_rng(0)
  x = rng.standard_normal((m,) + shape, dtype=np.float32) * 5 + 288
  y = rng.standard_normal(shape, dtype=np.float32) * 5 + 288
  xd, yd = jax.device_put(x), jax.device_put(y)
  kernel = jax.jit(ensemble_stats.fused_ensemble_stats)
  plain = jax.jit(plain_stats)
  op = {'plain_ms': [], 'kernel_ms': []}
  for name in ('plain_ms', 'kernel_ms', 'kernel_ms', 'plain_ms'):
    fn = plain if name == 'plain_ms' else kernel
    op[name].append(_median_ms(fn, xd, yd, reps=args.reps))
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  ens_dims = ('number',) + dims

  def spread_only(x, y):
    return probabilistic.CRPSSpread(use_sort=True)._compute_per_variable(
        DimArray(x, ens_dims), DimArray(y, dims)).data

  def cross_skill(x, y):
    return probabilistic.CRPSSkill()._compute_per_variable(
        DimArray(x, ens_dims), DimArray(y, ens_dims)).data

  half = m // 2
  plain_forms = {
      'spread_sort_ms': _median_ms(jax.jit(spread_only), xd, yd,
                                   reps=args.reps),
      'cross_skill_ms': _median_ms(jax.jit(cross_skill), xd[:half],
                                   xd[half:2 * half], reps=args.reps),
  }
  del xd, yd

  lats = np.linspace(-90, 90, 721)
  lons = np.linspace(0, 360, 1440, endpoint=False)
  coords = {'init_time': np.array(['2020-01-03'], 'datetime64[ns]'),
            'lead_time': (np.arange(4) * np.timedelta64(6, 'h')
                          ).astype('timedelta64[ns]'),
            'latitude': lats, 'longitude': lons}
  preds = {'t2m': DimArray(x, ('number',) + dims,
                           dict(coords, number=np.arange(m)))}
  tgts = {'t2m': DimArray(y, dims, coords)}
  yy, xx = np.meshgrid(np.deg2rad(lats), np.deg2rad(lons), indexing='ij')
  land = DimArray(np.sin(3 * yy) * np.cos(4 * xx) > 0.1,
                  ('latitude', 'longitude'),
                  {'latitude': lats, 'longitude': lons})
  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      bin_by=[binning.Regions(configs.REGIONS, land_sea_mask=land)],
      weigh_by=[weighting.GridAreaWeighting()], masked=True)
  metrics = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
  }

  def step_fn(with_kernel):
    """A jitted step traced with or without the kernel."""
    chosen = ensemble_stats.kernel_for
    if not with_kernel:
      ensemble_stats.kernel_for = lambda backend: None
    try:
      ev = evaluator_lib.ChunkEvaluator(metrics=metrics, aggregator=agg)
      p = jax.device_put(evaluator_lib.prepare_chunk(
          preds, ev._clim_stats, is_predictions=True))
      t = jax.device_put(evaluator_lib.prepare_chunk(tgts))
      args_ = (p, t, ev.operands_for(p, t), ev.resources())
      fn = jax.jit(ev._eval_fn).lower(*args_).compile()
    finally:
      ensemble_stats.kernel_for = chosen
    return functools.partial(fn, *args_)

  steps = {'plain_ms': step_fn(False), 'kernel_ms': step_fn(True)}
  step = {'plain_ms': [], 'kernel_ms': []}
  for name in ('plain_ms', 'kernel_ms', 'kernel_ms', 'plain_ms'):
    step[name].append(_median_ms(steps[name], reps=args.reps))

  dev = jax.devices()[0]
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True)
  print(json.dumps({
      'shape': [m, *shape], 'op': op, 'step': step,
      'plain_forms': plain_forms,
      'peak_bytes_in_use':
          (dev.memory_stats() or {}).get('peak_bytes_in_use'),
      'device': {'platform': dev.platform, 'kind': dev.device_kind,
                 'count': len(jax.devices()),
                 'nvidia_smi': smi.stdout.strip()}}))


if __name__ == '__main__':
  main()
