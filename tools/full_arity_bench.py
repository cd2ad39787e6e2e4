"""Production-arity end-to-end benchmark.

The WB2 production evaluation scores ~6 upper-air variables x 13 pressure
levels + 5 surface + 2 precipitation variables with the full deterministic
metric set (RMSE/MSE/bias/ACC/activity + wind-vector RMSE + SEEPS), 17
ECMWF regions land-augmented to 34 bins, area-weighted masked aggregation
(reference ``public_benchmark/run_benchmark_evaluation.py:301-354`` and
``public_configs.py:18-45``). This tool builds synthetic stores at exactly
that arity and drives the REAL CLI (`apps/run_benchmark_evaluation.py`)
end-to-end on the attached device, recording wall-clock, per-stage timers
and device memory footprint. ``chip_smoke.py`` builds its 0.25-degree
stores with :func:`make_store`.

Construction is the analytic demo recipe (tools/gen_demo_fixtures.py):
  target(valid)    = clim(doy, hour) + z_common(valid) + z_t(valid)
  prediction(i, l) = clim(doy, hour) + z_common(i + l) + z_p(i, l)
so RMSE = sqrt(2), ACC = 1/2, prediction_activity = sqrt(2) analytically —
the run checks its own correctness at full width.

At this arity the dayofyear/hour climatology is ~14 GB at 240x121 (and
~200 GB at 0.25 degrees): far past the resident-resource budget, so the
evaluator's host-gather fallback engages on the largest arrays — this run
is the proof of the resource-registry + operand-dedup story at real width.

Usage:
  python tools/full_arity_bench.py --make_store --resolution=240x121
  python tools/full_arity_bench.py --run --resolution=240x121
  # 0.25-degree per-chunk-rate segment (2 inits, 4 leads):
  python tools/full_arity_bench.py --make_store --resolution=1440x721 \
      --n_init=2 --n_lead=4
  python tools/full_arity_bench.py --run --resolution=1440x721 --n_lead=4
"""

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

UPPER = ['geopotential', 'temperature', 'u_component_of_wind',
         'v_component_of_wind', 'wind_speed', 'specific_humidity']
SURFACE = ['2m_temperature', 'mean_sea_level_pressure',
           '10m_u_component_of_wind', '10m_v_component_of_wind',
           '10m_wind_speed']
PRECIP = ['total_precipitation_6hr', 'total_precipitation_24hr']
LEVELS = [50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000]

GRIDS = {'64x32': (32, 64), '240x121': (121, 240), '1440x721': (721, 1440)}
STORE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), '.stores', 'full_arity')


def _grid(res):
  nlat, nlon = GRIDS[res]
  return (np.linspace(-90, 90, nlat),
          np.linspace(0, 360, nlon, endpoint=False))


def store_paths(res, store_dir=STORE_DIR):
  """(predictions, targets, climatology) zarr paths for ``res``."""
  d = os.path.join(store_dir, res)
  return (os.path.join(d, 'pred.zarr'), os.path.join(d, 'era5.zarr'),
          os.path.join(d, 'clim.zarr'))


def make_store(res: str, n_init: int, init_freq_h: int, n_lead: int,
               lead_freq_h: int, store_dir: str = STORE_DIR) -> None:
  """Writes the seeded prediction, target and climatology zarr stores.

  Cells are uncompressed, so the standard library decodes them. Data is
  drawn from a fixed seed; see the module docstring for the construction.
  """
  from weatherbenchx_tpu.darray import DimArray

  ppath, tpath, cpath = store_paths(res, store_dir)
  os.makedirs(os.path.dirname(ppath), exist_ok=True)
  lats, lons = _grid(res)
  nlat, nlon = len(lats), len(lons)
  rng = np.random.default_rng(2020)

  init = (np.datetime64('2020-01-01', 'ns')
          + np.arange(n_init) * np.timedelta64(init_freq_h, 'h'))
  lead = (np.arange(n_lead) * np.timedelta64(lead_freq_h, 'h')
          ).astype('timedelta64[ns]')
  # Valid slots on the lead-frequency lattice covering every init+lead.
  span_h = ((init[-1] - init[0]) / np.timedelta64(1, 'h')
            + (n_lead - 1) * lead_freq_h)
  n_valid = int(span_h // lead_freq_h) + 1
  valid = init[0] + np.arange(n_valid) * np.timedelta64(lead_freq_h, 'h')

  # Climatology time lattice. At 240x121 the store carries the production
  # shape — all 366 days (a real WB2 climatology store is full-year; its
  # ~14 GB at this arity is what trips the evaluator's resident-resource
  # budget and engages host-gather). At 0.25 degrees a full-year store
  # would be ~200 GB, so only the touched dayofyear window is generated
  # (the user-side .sel() posture).
  from weatherbenchx_tpu.datetimes import datetime_field
  valid_doy = datetime_field(valid, 'dayofyear')
  if res == '240x121':
    doys = np.arange(1, 367)
  else:
    doys = np.arange(int(valid_doy.min()), int(valid_doy.max()) + 1)
  hours = np.unique(datetime_field(valid, 'hour'))
  doy_pos = {int(d): i for i, d in enumerate(doys)}
  hour_pos = {int(h): i for i, h in enumerate(hours)}

  def clim_slot(times):
    d = np.vectorize(doy_pos.get)(datetime_field(times, 'dayofyear'))
    h = np.vectorize(hour_pos.get)(datetime_field(times, 'hour'))
    return d * len(hours) + h

  vt_pairs = init[:, None] + lead[None, :]
  slot_pred = clim_slot(vt_pairs)            # (n_init, n_lead)
  slot_tgt = clim_slot(valid)                # (n_valid,)
  pos_pred = ((vt_pairs - valid[0]) // np.timedelta64(lead_freq_h, 'h')
              ).astype(np.int64)

  tdims4 = ('dayofyear', 'hour', 'latitude', 'longitude')
  tdims5 = ('dayofyear', 'hour', 'level', 'latitude', 'longitude')
  ccoords = {'dayofyear': doys, 'hour': hours,
             'latitude': lats, 'longitude': lons}
  lev = np.array(LEVELS)

  pred_ds, tgt_ds, clim_ds = {}, {}, {}
  t0 = time.time()
  for name in UPPER + SURFACE + PRECIP:
    has_level = name in UPPER
    fshape = ((len(LEVELS), nlat, nlon) if has_level else (nlat, nlon))

    def rand(*lead_shape):
      return rng.standard_normal(lead_shape + fshape, dtype=np.float32)

    clim = rand(len(doys), len(hours))
    zc = rand(n_valid)
    clim_flat = clim.reshape((-1,) + fshape)
    tgt = clim_flat[slot_tgt] + zc + rand(n_valid)
    pred = (clim_flat[slot_pred.reshape(-1)].reshape(
        (n_init, n_lead) + fshape)
        + zc[pos_pred.reshape(-1)].reshape((n_init, n_lead) + fshape)
        + rand(n_init, n_lead))
    if name in PRECIP:
      # Positive values on a SEEPS-plausible scale (meters); keep the
      # additive structure so RMSE stays analytic but shift/scale it.
      tgt = np.abs(tgt) * 1e-3
      pred = np.abs(pred) * 1e-3

    if has_level:
      tgt_ds[name] = DimArray(
          tgt, ('time', 'level', 'latitude', 'longitude'),
          {'time': valid, 'level': lev, 'latitude': lats,
           'longitude': lons})
      pred_ds[name] = DimArray(
          pred, ('time', 'prediction_timedelta', 'level', 'latitude',
                 'longitude'),
          {'time': init, 'prediction_timedelta': lead, 'level': lev,
           'latitude': lats, 'longitude': lons})
      clim_ds[name] = DimArray(clim, tdims5, {**ccoords, 'level': lev})
    else:
      tgt_ds[name] = DimArray(
          tgt, ('time', 'latitude', 'longitude'),
          {'time': valid, 'latitude': lats, 'longitude': lons})
      pred_ds[name] = DimArray(
          pred, ('time', 'prediction_timedelta', 'latitude', 'longitude'),
          {'time': init, 'prediction_timedelta': lead,
           'latitude': lats, 'longitude': lons})
      clim_ds[name] = DimArray(clim, tdims4, dict(ccoords))
    print(f'  built {name} ({time.time() - t0:.0f}s)', flush=True)

  for v in PRECIP:
    clim_ds[f'{v}_seeps_threshold'] = DimArray(
        np.full((len(doys), len(hours), nlat, nlon), 3e-3, np.float32)
        + rng.standard_normal(
            (len(doys), len(hours), nlat, nlon)).astype(np.float32) * 2e-4,
        tdims4, dict(ccoords))
    clim_ds[f'{v}_seeps_dry_fraction'] = DimArray(
        np.full((len(doys), len(hours), nlat, nlon), 0.4, np.float32),
        tdims4, dict(ccoords))
  tgt_ds['land_sea_mask'] = DimArray(
      (rng.random((nlat, nlon)) > 0.3).astype(np.float32),
      ('latitude', 'longitude'), {'latitude': lats, 'longitude': lons})

  from weatherbenchx_tpu import zarr_io
  for path, ds, chunks in (
      (ppath, pred_ds, {'time': 1}),
      (tpath, tgt_ds, {'time': 4}),
      (cpath, clim_ds, {'dayofyear': 4}),
  ):
    t1 = time.time()
    zarr_io.save_dataset_zarr(path, ds, chunks=chunks)
    gb = sum(getattr(da.data, 'nbytes', 0) for da in ds.values()) / 2**30
    print(f'wrote {path}: {gb:.1f} GB raw in {time.time() - t1:.0f}s',
          flush=True)


def run(res: str, n_init, init_freq_h, n_lead, lead_freq_h, lead_chunk,
        resource_bytes, chunks_per_dispatch) -> None:
  if resource_bytes:
    os.environ['WBX_RESOURCE_BYTES'] = str(resource_bytes)
  import logging
  logging.basicConfig(level=logging.INFO, format='%(asctime)s %(message)s')
  import jax
  from weatherbenchx_tpu import io as io_lib
  from weatherbenchx_tpu import observability
  from weatherbenchx_tpu.apps import run_benchmark_evaluation

  ppath, tpath, cpath = store_paths(res)
  outdir = os.path.join(STORE_DIR, res, 'results')
  variables = UPPER + SURFACE + PRECIP
  init_stop = (np.datetime64('2020-01-01')
               + n_init * np.timedelta64(init_freq_h, 'h'))
  argv = [
      '--prediction', 'synthetic_full_arity', '--target', 'era5',
      '--resolution', res, '--year', '2020',
      '--variables', ','.join(variables),
      '--levels', ','.join(str(l) for l in LEVELS),
      '--time_frequency', str(init_freq_h),
      '--init_time_start', '2020-01-01',
      '--init_time_stop', str(init_stop),
      '--lead_time_stop_days', str(n_lead * lead_freq_h // 24),
      '--lead_time_frequency', str(lead_freq_h),
      '--init_time_chunk_size', '1',
      '--lead_time_chunk_size', str(lead_chunk or n_lead),
      '--chunks_per_dispatch', str(chunks_per_dispatch),
      '--output_dir', outdir,
      '--prediction_path', ppath, '--target_path', tpath,
      '--climatology_path', cpath,
  ]
  dev = jax.devices()[0]
  print(f'device: {dev}', flush=True)
  t0 = time.time()
  run_benchmark_evaluation.main(argv)
  wall = time.time() - t0

  obs = observability.default_metrics
  mem = {}
  try:
    stats = dev.memory_stats() or {}
    mem = {k: stats[k] for k in ('bytes_in_use', 'peak_bytes_in_use',
                                 'bytes_limit') if k in stats}
  except Exception:
    pass
  rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20

  # Analytic self-check: RMSE = sqrt(2), ACC = 0.5 for every non-precip
  # variable (precip is |.|-transformed, breaking the closed form).
  out_file = os.path.join(
      outdir, f'synthetic_full_arity_vs_era5_{res}_2020-init'
      f'{init_freq_h}h.npz')
  results = io_lib.load_dataset(out_file)
  checks = {'n_metric_vars': len(results)}
  fails = []
  for v in UPPER + SURFACE:
    rmse = float(np.mean(np.asarray(
        results[f'rmse.{v}'].sel(region='global').values)))
    acc = float(np.mean(np.asarray(
        results[f'acc.{v}'].sel(region='global').values)))
    if abs(rmse - np.sqrt(2)) > 0.05 * np.sqrt(2):
      fails.append(f'rmse.{v}={rmse:.4f}')
    if abs(acc - 0.5) > 0.03:
      fails.append(f'acc.{v}={acc:.4f}')
  for v in PRECIP:
    s = np.asarray(results[f'seeps.{v}'].sel(region='global').values)
    if not np.isfinite(s).all():
      fails.append(f'seeps.{v} non-finite')
  checks['analytic_ok'] = not fails
  checks['failures'] = fails

  timings = {k: {'mean_s': round(d.mean, 3), 'count': d.count,
                 'total_s': round(d.mean * d.count, 1)}
             for k, d in obs.timings.items()}
  report = {
      'metric': 'full_arity_eval',
      'resolution': res,
      'variables': len(variables),
      'field_levels': len(UPPER) * len(LEVELS) + len(SURFACE) + len(PRECIP),
      'n_init': n_init, 'n_lead': n_lead,
      'wall_s': round(wall, 1),
      'stage_timings': timings,
      'counters': dict(obs.counters),
      'device_memory': mem,
      'host_peak_rss_gb': round(rss_gb, 2),
      'checks': checks,
  }
  print(json.dumps(report), flush=True)
  if fails:
    sys.exit(1)


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument('--make_store', action='store_true')
  ap.add_argument('--run', action='store_true')
  ap.add_argument('--resolution', default='240x121', choices=list(GRIDS))
  ap.add_argument('--n_init', type=int, default=None,
                  help='default: 62 at 240x121 (a month at 12h), '
                       '2 at 1440x721')
  ap.add_argument('--init_freq_h', type=int, default=12)
  ap.add_argument('--n_lead', type=int, default=None,
                  help='default: 40 (10 days at 6h) at 240x121, '
                       '4 at 1440x721')
  ap.add_argument('--lead_freq_h', type=int, default=6)
  ap.add_argument('--lead_chunk', type=int, default=None,
                  help='lead_time_chunk_size (default: all leads)')
  ap.add_argument('--resource_bytes', type=int, default=None,
                  help='override the resident-resource device-memory budget')
  ap.add_argument('--chunks_per_dispatch', type=int, default=1)
  args = ap.parse_args()
  n_init = args.n_init or (62 if args.resolution == '240x121' else 2)
  n_lead = args.n_lead or (40 if args.resolution == '240x121' else 4)
  if args.make_store:
    make_store(args.resolution, n_init, args.init_freq_h, n_lead,
               args.lead_freq_h)
  if args.run:
    run(args.resolution, n_init, args.init_freq_h, n_lead,
        args.lead_freq_h, args.lead_chunk, args.resource_bytes,
        args.chunks_per_dispatch)
  if not (args.make_store or args.run):
    print('nothing to do: pass --make_store and/or --run')


if __name__ == '__main__':
  main()
