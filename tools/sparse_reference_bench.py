"""Times the ACTUAL reference sparse path on the sparse_scale_demo fixture.

VERDICT r3 item 4: the repo's sparse throughput (131-139 k obs/s on the
4.37 M-row METAR-shaped month, tools/sparse_scale_demo.py) had no
reference-side number. This tool runs the unmodified upstream code
(`/root/reference/weatherbenchX/data_loaders/sparse_parquet.py:72-524`,
via the tools/refshim numpy/pandas xarray shim) over the SAME parquet
fixture with the SAME evaluation semantics:

  METARFromParquet targets (QC NaNing, closest-duplicate removal) →
  PredictionsFromXarray + GridToSparseWithAltitudeAdjustment gather →
  RMSE+Bias statistics → masked aggregation with BySets network bins
  (+complements +global) and ByExactCoord lead bins → summed
  AggregationState over the same TimeChunks grid.

and reports wall time + obs/s with the same normalization (total parquet
rows / wall seconds). Run tools/sparse_scale_demo.py first (or with the
same --workdir) so the fixture exists and both sides read identical bytes.

Per-phase stage timers (targets parquet load+dedup, grid→sparse interp,
statistics, aggregation, state sum) always print, and ``--profile`` runs
the chunk walk under cProfile and attributes self-time by module family
(refshim / upstream weatherbenchX / pandas / pyarrow / numpy / other) —
the honest error bar on the repo-vs-reference ratio: time inside the
refshim's python xarray stand-in is NOT genuine upstream cost (real
xarray may be faster or slower there), while pandas/pyarrow/numpy time
is identical work either install would do (VERDICT r4 item 6).

Usage:
  python tools/sparse_scale_demo.py --stations 6000 --days 31
  python tools/sparse_reference_bench.py --stations 6000 --days 31
"""

import argparse
import cProfile
import json
import os
import pstats
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

REFERENCE_ROOT = os.environ.get('WBX_REFERENCE_ROOT', '/root/reference')


def import_reference():
  sys.path.insert(0, os.path.join(_REPO, 'tools', 'refshim'))
  sys.path.insert(0, REFERENCE_ROOT)
  import xarray as xr
  assert 'wbx-refshim' in xr.__version__
  import types
  from weatherbenchX import aggregation, binning, interpolations, time_chunks
  from weatherbenchX.data_loaders import sparse_parquet, xarray_loaders
  from weatherbenchX.metrics import base as metrics_base
  from weatherbenchX.metrics import deterministic
  return types.SimpleNamespace(
      xr=xr, aggregation=aggregation, binning=binning,
      interpolations=interpolations, time_chunks=time_chunks,
      sparse_parquet=sparse_parquet, xarray_loaders=xarray_loaders,
      metrics_base=metrics_base, deterministic=deterministic)


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--stations', type=int, default=6000)
  p.add_argument('--days', type=int, default=31)
  p.add_argument('--obs_freq_h', type=int, default=1)
  p.add_argument('--grid', default='240x121')
  p.add_argument('--init_freq_h', type=int, default=12)
  p.add_argument('--leads_h', default='6,12,24,48')
  p.add_argument('--max_chunks', type=int, default=0,
                 help='bound the walk for quick runs (0 = all chunks, '
                 'obs/s extrapolates from rows actually covered)')
  p.add_argument('--workdir', default=os.path.join(
      os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
      '.stores', 'sparse_demo'))
  p.add_argument('--profile', action='store_true',
                 help='cProfile the chunk walk and attribute self-time '
                 'by module family (refshim vs upstream vs pandas/'
                 'pyarrow/numpy) — the shim-overhead error bar')
  args = p.parse_args()

  from sparse_scale_demo import generate_parquet_month

  ns = import_reference()
  xr = ns.xr

  obs_root = os.path.join(
      args.workdir, f'obs_{args.stations}_{args.days}_{args.obs_freq_h}')
  marker = os.path.join(obs_root, 'done.json')
  if os.path.exists(marker):
    with open(marker) as f:
      names, n_rows = json.load(f)
    names = np.asarray(names)
  else:
    names, n_rows = generate_parquet_month(
        obs_root, args.stations, args.days, args.obs_freq_h)
    with open(marker, 'w') as f:
      json.dump([list(names), n_rows], f)

  nlon, nlat = map(int, args.grid.split('x'))
  lats = np.linspace(-90, 90, nlat)
  lons = np.linspace(0, 360, nlon, endpoint=False)
  init_times = np.arange(
      np.datetime64('2020-01-01'),
      np.datetime64('2020-01-01') + np.timedelta64(args.days - 3, 'D'),
      np.timedelta64(args.init_freq_h, 'h')).astype('datetime64[ns]')
  lead_times = np.array([int(h) for h in args.leads_h.split(',')],
                        dtype='timedelta64[h]').astype('timedelta64[ns]')
  rng = np.random.default_rng(1)
  pred = (288 + 3 * rng.standard_normal(
      (len(init_times), len(lead_times), nlat, nlon))).astype(np.float32)
  pred_ds = xr.Dataset({'2m_temperature': xr.DataArray(
      pred, dims=('init_time', 'lead_time', 'latitude', 'longitude'),
      coords={'init_time': init_times, 'lead_time': lead_times,
              'latitude': lats, 'longitude': lons})})
  grid_elevation = xr.DataArray(
      np.abs(200 + 300 * np.sin(np.deg2rad(lats))[:, None]
             * np.cos(3 * np.deg2rad(lons))[None, :]).astype(np.float32),
      dims=('latitude', 'longitude'),
      coords={'latitude': lats, 'longitude': lons})

  targets_loader = ns.sparse_parquet.METARFromParquet(
      path=obs_root, variables=['2m_temperature'], time_dim='timeNominal',
      partitioned_by='month',
      tolerance=np.timedelta64(90, 'm'),
      remove_duplicates=True, pick_closest_duplicate_by='timeNominal',
      add_nan_mask=True)
  predictions_loader = ns.xarray_loaders.PredictionsFromXarray(
      ds=pred_ds, rename_dimensions=None,
      interpolation=ns.interpolations.GridToSparseWithAltitudeAdjustment(
          'linear', grid_elevation=grid_elevation, wrap_longitude=True))

  networks = {'even': [n for i, n in enumerate(names) if i % 2 == 0]}
  aggregator = ns.aggregation.Aggregator(
      reduce_dims=['index'], masked=True,
      bin_by=[ns.binning.BySets(
          networks, coord_name='stationName', bin_dim_name='network',
          add_set_complements=True, add_global_bin=True),
          ns.binning.ByExactCoord('lead_time')])

  metrics = {'rmse': ns.deterministic.RMSE(), 'bias': ns.deterministic.Bias()}
  times = ns.time_chunks.TimeChunks(
      init_times, lead_times, init_time_chunk_size=2, lead_time_chunk_size=4)
  chunk_list = list(times)
  if args.max_chunks:
    chunk_list = chunk_list[:args.max_chunks]
  frac = len(chunk_list) / len(list(times))

  phases = {'targets_load': 0.0, 'interp_gather': 0.0,
            'statistics': 0.0, 'aggregate': 0.0, 'state_sum': 0.0}

  def run_walk():
    total = None
    for init_c, lead_c in chunk_list:
      t = time.perf_counter()
      targets = targets_loader.load_chunk(init_c, lead_c)
      phases['targets_load'] += time.perf_counter() - t
      t = time.perf_counter()
      preds = predictions_loader.load_chunk(init_c, lead_c,
                                            reference=targets)
      phases['interp_gather'] += time.perf_counter() - t
      t = time.perf_counter()
      stats = ns.metrics_base.compute_unique_statistics_for_all_metrics(
          metrics, preds, targets)
      phases['statistics'] += time.perf_counter() - t
      t = time.perf_counter()
      state = aggregator.aggregate_statistics(stats)
      phases['aggregate'] += time.perf_counter() - t
      t = time.perf_counter()
      total = state if total is None else total + state
      phases['state_sum'] += time.perf_counter() - t
    return total

  t0 = time.perf_counter()
  if args.profile:
    prof = cProfile.Profile()
    total = prof.runcall(run_walk)
  else:
    total = run_walk()
  values = total.metric_values(metrics)
  wall = time.perf_counter() - t0
  rows_covered = n_rows * frac
  rmse = values['rmse.2m_temperature']
  out = {
      'metric': 'sparse_metar_month_reference',
      'stations': args.stations, 'days': args.days,
      'obs_rows': n_rows, 'chunks': len(chunk_list),
      'chunk_fraction': round(frac, 3),
      'wall_s': round(wall, 1),
      'obs_per_sec': round(rows_covered / wall),
      'rmse_global': round(float(np.asarray(
          rmse.sel(network='global').values)[0]), 4),
      'phase_s': {k: round(v, 1) for k, v in phases.items()},
  }
  if args.profile:
    out['self_time_shares'] = _module_attribution(prof)
  print(json.dumps(out))


_FAMILIES = (  # (label, path fragment); first match wins
    ('refshim', os.sep + 'refshim' + os.sep),
    ('upstream', os.sep + 'weatherbenchX' + os.sep),
    ('pandas', os.sep + 'pandas' + os.sep),
    ('pyarrow', os.sep + 'pyarrow' + os.sep),
    ('numpy', os.sep + 'numpy' + os.sep),
)


def _module_attribution(prof: cProfile.Profile) -> dict:
  """Self-time (tottime) shares per module family + the top functions.

  Self time sums to the profiled wall, so the shares partition the run:
  'refshim' is the shim-attributable fraction (work real xarray would do
  differently), 'pandas'/'pyarrow'/'numpy' is identical-bytes work any
  xarray install delegates, 'upstream' is the reference's own python.
  C extensions called from a family accrue to the builtin bucket of the
  CALLER's frame only when profiled; pyarrow/pandas natives show as
  builtins under 'other' — reported separately, not misattributed.
  """
  stats = pstats.Stats(prof)
  fam_tot: dict[str, float] = {}
  rows = []
  for (filename, lineno, funcname), (cc, nc, tottime, cumtime,
                                     callers) in stats.stats.items():
    fam = 'other'
    for label, frag in _FAMILIES:
      if frag in filename:
        fam = label
        break
    if filename.startswith('~') or filename == '<built-in>':
      fam = 'builtin'
    fam_tot[fam] = fam_tot.get(fam, 0.0) + tottime
    rows.append((tottime, f'{os.path.basename(filename)}:{lineno}'
                 f'({funcname})', fam))
  total = sum(fam_tot.values()) or 1.0
  rows.sort(reverse=True)
  return {
      'profiled_s': round(total, 1),
      'shares': {k: round(v / total, 3)
                 for k, v in sorted(fam_tot.items(),
                                    key=lambda kv: -kv[1])},
      'seconds': {k: round(v, 1)
                  for k, v in sorted(fam_tot.items(),
                                     key=lambda kv: -kv[1])},
      'top_functions': [
          {'self_s': round(t, 1), 'fn': fn, 'family': fam}
          for t, fn, fam in rows[:12]],
  }


if __name__ == '__main__':
  main()
