"""Randomized reference-parity sweep on the attached backend.

The CI parity suite (``tests/test_reference_parity.py``) is pinned to the
CPU by ``tests/conftest.py``, so it never sees the accelerator's own
numerics (matmul precision, kernel accumulation order, reduction order).
This tool runs seeded randomized checks on whatever backend
``jax.default_backend()`` resolves to. Two kinds of family:

* ``config``, ``seeps``, ``spatial_rank`` and ``wrappers`` compare random
  metric subset × reduce dims × binning stack × weighting × skipna × NaN
  pattern configurations against the upstream WeatherBench-X code through
  ``tools/refshim``. They need the upstream source tree, which is not part
  of this repository: point ``WBX_REFERENCE_ROOT`` at a checkout. Without
  it these families are skipped and reported as such.
* ``large_k`` needs nothing outside this repository: it runs the real
  Aggregator at 0.25° (K = 721×1440) against a float64 numpy contraction.

Keep running this after any change to device-side numerics (kernels,
aggregation, interpolation).

Usage:
  python tools/parity_fuzz.py --seeds 200
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'tests'))


def _large_k_config(seed: int) -> None:
  """Production-K aggregation parity vs a float64 oracle.

  The refshim fuzz fixtures are 10°-grid (K of a few thousand). This
  family runs the real Aggregator at K = 721x1440 with several
  same-layout statistics on whatever backend is active, and checks every
  aggregated sum against a float64 numpy contraction at the reference's
  1e-5 envelope, so the einsum-HIGHEST lowering is validated on the
  device's own arithmetic, not CPU emulation.
  """
  import numpy as np

  from weatherbenchx_tpu import aggregation, binning, weighting
  from weatherbenchx_tpu.darray import DimArray

  rng = np.random.default_rng(10_000 + seed)
  nlat, nlon = 721, 1440
  n_lead = int(rng.integers(2, 5))
  n_stats = int(rng.integers(3, 6))  # 2*n_stats statlikes: rows >= 12
  lats = np.linspace(-90, 90, nlat)
  lons = np.linspace(0, 360, nlon, endpoint=False)
  coords = {'latitude': lats, 'longitude': lons}
  n_regions = int(rng.integers(6, 18))
  edges = np.sort(rng.uniform(-90, 90, 2 * n_regions)).reshape(-1, 2)
  regions = {f'r{i}': ((float(a), float(b)), (0.0, 360.0))
             for i, (a, b) in enumerate(edges)}
  land = DimArray(rng.random((nlat, nlon)) > 0.5,
                  ('latitude', 'longitude'), coords)
  agg = aggregation.Aggregator(
      reduce_dims=['latitude', 'longitude'],
      bin_by=[binning.Regions(regions, land_sea_mask=land)],
      weigh_by=[weighting.GridAreaWeighting()])
  stats = {
      f's{i}': {'v': DimArray(
          rng.standard_normal((n_lead, nlat, nlon)).astype(np.float32),
          ('lead_time', 'latitude', 'longitude'), coords)}
      for i in range(n_stats)}
  state = agg.aggregate_statistics(stats)

  # Float64 oracle: same sin-bounds weights and bin masks, f64 einsum.
  any_stat = stats['s0']['v']
  w64 = np.ones((nlat, nlon))
  masks = None
  for op in agg.aggregation_operands(any_stat):
    arr = np.asarray(op.data)
    if arr.dtype == np.bool_ and op.dims[0] not in any_stat.dims:
      masks = arr
    else:
      w64 = w64 * arr.astype(np.float64).reshape(
          arr.shape + (1,) * (2 - arr.ndim) if arr.ndim < 2 else arr.shape)
  assert masks is not None
  wm = w64 * np.ones((nlat, nlon))
  worst = 0.0
  for i in range(n_stats):
    got = np.asarray(state.sum_weighted_statistics[f's{i}']['v'].data,
                     np.float64)
    s64 = np.asarray(stats[f's{i}']['v'].data, np.float64)
    want = np.einsum('lij,bij->lb', s64 * wm, masks.astype(np.float64))
    # Error at each bin sum, measured against max(|bin sum|, row RMS):
    # the bin sums of a random-sign statistic are random walks, so a
    # near-cancelling bin's PURE relative error is unbounded for any
    # f32-grade contraction (the reference's f32 np.einsum included —
    # it measures 1.3e-5 on this shape by the same yardstick).
    scale = np.maximum(np.abs(want),
                       np.sqrt(np.mean(want ** 2, axis=-1, keepdims=True)))
    worst = max(worst, float(np.max(np.abs(got - want) / scale)))
  if worst > 2e-5:  # f32 grade: reference np.einsum measures 1.3e-5 here
    raise AssertionError(f'large-K aggregation off by {worst:.3e} '
                         f'(rows={2 * n_stats * n_lead}, bins={masks.shape[0]})')


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--seeds', type=int, default=200)
  p.add_argument('--max_report', type=int, default=5)
  p.add_argument('--large_k_seeds', type=int, default=None,
                 help='seeds for the production-K family '
                      '(default: min(seeds, 20) — each seed moves ~400 MB)')
  args = p.parse_args()

  import jax
  import test_reference_parity as parity

  t0 = time.perf_counter()
  failures = []
  n_large = (args.large_k_seeds if args.large_k_seeds is not None
             else min(args.seeds, 20))
  upstream_families = (
      [] if not os.path.isdir(parity.REFERENCE_ROOT) else [
          ('config', 'test_random_config'),
          ('seeps', 'test_random_seeps_config'),
          ('spatial_rank', 'test_random_spatial_rank_config'),
          ('wrappers', 'test_random_wrapper_config')])
  if upstream_families:
    ref = parity._import_reference()
    fuzz = parity.TestRandomizedConfigParity()
  else:
    print(f'upstream tree {parity.REFERENCE_ROOT} not found: only the '
          'large_k family runs', file=sys.stderr)
  for family, name in upstream_families:
    fn = getattr(fuzz, name)
    for seed in range(args.seeds):
      try:
        fn(ref, seed)
      except Exception as e:  # noqa: BLE001 — collect, report, exit nonzero
        failures.append({'family': family, 'seed': seed,
                         'error': f'{type(e).__name__}: ' + str(e)[:300]})
  for seed in range(n_large):
    try:
      _large_k_config(seed)
    except Exception as e:  # noqa: BLE001
      failures.append({'family': 'large_k', 'seed': seed,
                       'error': f'{type(e).__name__}: ' + str(e)[:300]})
  print(json.dumps({
      'metric': 'parity_fuzz',
      'backend': jax.default_backend(),
      'device_kind': jax.devices()[0].device_kind,
      'families': [f for f, _ in upstream_families] + ['large_k'],
      'seeds': args.seeds,
      'failures': len(failures),
      'wall_s': round(time.perf_counter() - t0, 1),
      'first_failures': failures[:args.max_report],
  }))
  sys.exit(1 if failures else 0)


if __name__ == '__main__':
  main()
