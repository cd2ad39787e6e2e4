"""Smoke test of the scorecard pipeline on NVIDIA GPUs.

Drives the production evaluation path at 0.25° through the CLI a user
calls (``weatherbenchx_tpu.apps.run_benchmark_evaluation``) on seeded
zarr stores, and checks every result against a float64 numpy reference.

  python3 chip_smoke.py               # phases 1 and 2, on one card
  python3 chip_smoke.py --four_cards  # phase 3 alone, on four cards

1. Deterministic scorecard: 1440×721, 85 field-levels, 2 inits × 4 leads,
   RMSE/MSE/bias/ACC/activity, wind-vector RMSE and SEEPS, 34 region bins,
   area weights, masked aggregation.
2. Probabilistic scorecard: a 50-member ensemble, 2 variables, 1 init ×
   4 leads (830 MB per field-level per chunk), CRPS, unbiased spread/skill
   and ensemble-mean RMSE; then the fused ensemble-statistics kernel
   called directly at (50, 1, 4, 721, 1440).
3. ``--four_cards``: phase 2's metric set over 4 inits through
   ``pipeline.evaluate`` on a (batch=2, space=2) mesh, against the same
   run on one card in the same process.

Prints the card's name and power limit, each check's error beside its
tolerance, and wall times (information only); the last line is one JSON
object. Exits non-zero, printing no result, when JAX finds no GPU, when
the package is not beside this script, or when any check fails.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, '.stores', 'chip_smoke')
RES = '1440x721'
MEMBERS = 50
ENS_VARIABLES = ('2m_temperature', 'mean_sea_level_pressure')
# Float32 statistics, summed over ~10^6 gridpoints per lead in float32
# (einsum at HIGHEST precision, no TF32), against float64 sums of the same
# inputs: each f32 partial sum carries ~2^-24 relative rounding per add,
# and the reduction trees keep the accumulated error near 1e-6.
RTOL_AGG = 1e-5
# The kernel sums 50 members in float32 (~50 * 2^-24 = 3e-6 relative); the
# order-statistic spread is summed on rows centred on their mean.
RTOL_KERNEL = 1e-5


class CheckFailed(Exception):
  pass


def log(msg: str) -> None:
  print(msg, flush=True)


def check(label: str, err: float, tol: float, reason: str) -> None:
  ok = bool(np.isfinite(err)) and err <= tol
  log(f'  {label}: max rel err {err:.3e} (tol {tol:g}: {reason}) '
      f'{"ok" if ok else "FAIL"}')
  if not ok:
    raise CheckFailed(f'{label}: {err:.3e} > {tol:g}')


def max_rel(got, want) -> float:
  """max |got − want| / max(|want|, 1e-3·max|want|), NaNs must agree."""
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  if got.shape != want.shape or not np.array_equal(np.isnan(got),
                                                   np.isnan(want)):
    return float('inf')
  ok = ~np.isnan(want)
  if not ok.any():
    return 0.0
  floor = 1e-3 * np.max(np.abs(want[ok]))
  return float(np.max(np.abs(got[ok] - want[ok])
                      / np.maximum(np.abs(want[ok]), floor)))


def area_weights(lats: np.ndarray) -> np.ndarray:
  """Cell areas between latitude midpoints (clamped at the poles), f64."""
  rad = np.deg2rad(np.asarray(lats, np.float64))
  mid = (rad[:-1] + rad[1:]) / 2
  bounds = np.concatenate([[max(rad[0] - (rad[1] - rad[0]) / 2, -np.pi / 2)],
                           mid,
                           [min(rad[-1] + (rad[-1] - rad[-2]) / 2, np.pi / 2)]])
  return np.diff(np.sin(bounds))


def wmean(stat: np.ndarray, w_lat: np.ndarray) -> np.ndarray:
  """Area-weighted mean over (init, lat, lon) of an (init, lead, lat, lon)
  array, per lead."""
  w = w_lat[None, None, :, None]
  return (stat * w).sum((0, 2, 3)) / (np.broadcast_to(w, stat.shape)
                                      .sum((0, 2, 3)))


def load_results(out_dir: str) -> dict:
  from weatherbenchx_tpu import io as io_lib
  (name,) = [f for f in os.listdir(out_dir) if f.endswith('.npz')]
  return io_lib.load_dataset(os.path.join(out_dir, name))


def global_values(results, key, **sel):
  da = results[key].sel(region='global', **sel)
  return np.asarray(da.transpose('lead_time').values, np.float64)


# -- phase 1 ------------------------------------------------------------------


def deterministic_scorecard(res: str = RES) -> None:
  sys.path.insert(0, os.path.join(ROOT, 'tools'))
  import full_arity_bench as fab
  from weatherbenchx_tpu import io as io_lib
  from weatherbenchx_tpu.apps import run_benchmark_evaluation
  from weatherbenchx_tpu.datetimes import datetime_field

  store_dir = os.path.join(WORK, 'deterministic')
  out_dir = os.path.join(WORK, 'deterministic_out')
  shutil.rmtree(store_dir, ignore_errors=True)
  shutil.rmtree(out_dir, ignore_errors=True)
  n_init, init_h, n_lead, lead_h = 2, 12, 4, 6
  t0 = time.time()
  fab.make_store(res, n_init, init_h, n_lead, lead_h, store_dir=store_dir)
  log(f'  stores written in {time.time() - t0:.1f}s (information only)')
  ppath, tpath, cpath = fab.store_paths(res, store_dir)
  variables = fab.UPPER + fab.SURFACE + fab.PRECIP
  field_levels = len(fab.UPPER) * len(fab.LEVELS) + len(fab.SURFACE) + len(
      fab.PRECIP)
  argv = [
      '--prediction', 'synthetic_full_arity', '--target', 'era5',
      '--resolution', res, '--year', '2020',
      '--variables', ','.join(variables),
      '--levels', ','.join(str(l) for l in fab.LEVELS),
      '--time_frequency', str(init_h),
      '--init_time_start', '2020-01-01',
      '--init_time_stop', str(np.datetime64('2020-01-01T00')
                              + n_init * np.timedelta64(init_h, 'h')),
      '--lead_time_stop_days', '1', '--lead_time_frequency', str(lead_h),
      '--lead_time_chunk_size', str(n_lead),
      '--output_dir', out_dir,
      '--prediction_path', ppath, '--target_path', tpath,
      '--climatology_path', cpath,
  ]
  t0 = time.time()
  run_benchmark_evaluation.main(argv)
  log(f'  CLI: {field_levels} field-levels, {n_init} inits x {n_lead} leads '
      f'in {time.time() - t0:.1f}s (information only, compile included)')
  results = load_results(out_dir)
  regions = results['rmse.2m_temperature'].sizes['region']
  log(f'  region bins: {regions}')
  if regions != 34:
    raise CheckFailed(f'expected 34 region bins, got {regions}')

  # Analytic values of the construction (tools/full_arity_bench.py).
  worst_rmse = worst_acc = 0.0
  for v in fab.UPPER + fab.SURFACE:
    rmse, acc = (np.asarray(results[f'{k}.{v}'].sel(region='global').values,
                            np.float64) for k in ('rmse', 'acc'))
    worst_rmse = max(worst_rmse, float(np.max(np.abs(rmse / np.sqrt(2) - 1))))
    worst_acc = max(worst_acc, float(np.max(np.abs(acc - 0.5))))
  # One standard error of either sample estimate is below 0.75/sqrt(n)
  # for n gridpoints per lead; the bound leaves 6 of them for the max over
  # 77 field-levels x 4 leads.
  n = n_init * np.prod(fab.GRIDS[res])
  check('analytic RMSE = sqrt(2), all non-precip field-levels', worst_rmse,
        4.5 / np.sqrt(n), '6 standard errors of the seeded sample')
  check('analytic ACC = 0.5 (absolute error)', worst_acc, 4.5 / np.sqrt(n),
        '6 standard errors of the seeded sample')
  for v in fab.PRECIP + ['wind', '10m_wind']:
    key = f'seeps.{v}' if v in fab.PRECIP else f'vector_rmse.{v}'
    vals = np.asarray(results[key].values, np.float64)
    if not np.isfinite(vals).all():
      raise CheckFailed(f'{key} is not finite')
  log('  SEEPS and wind-vector RMSE finite: ok')

  # Float64 numpy reference of the same weighted means, 3 field-levels.
  pred_ds = io_lib.open_dataset_auto(ppath)
  tgt_ds = io_lib.open_dataset_auto(tpath)
  clim_ds = io_lib.open_dataset_auto(cpath)
  lats = np.asarray(pred_ds['2m_temperature'].coord_values('latitude'))
  w_lat = area_weights(lats)
  init = np.asarray(pred_ds['2m_temperature'].coord_values('time'))
  lead = np.asarray(
      pred_ds['2m_temperature'].coord_values('prediction_timedelta'))
  valid = init[:, None] + lead[None, :]
  tgt_time = np.asarray(tgt_ds['2m_temperature'].coord_values('time'))
  t_idx = np.searchsorted(tgt_time, valid)
  doys = np.asarray(clim_ds['2m_temperature'].coord_values('dayofyear'))
  hours = np.asarray(clim_ds['2m_temperature'].coord_values('hour'))
  d_idx = np.searchsorted(doys, datetime_field(valid, 'dayofyear'))
  h_idx = np.searchsorted(hours, datetime_field(valid, 'hour'))
  for v, level in (('geopotential', 500), ('temperature', 850),
                   ('2m_temperature', None)):
    def field(ds, dims):
      da = ds[v]
      if level is not None:
        da = da.sel(level=level)
      return np.asarray(da.transpose(*dims).values, np.float64)
    p = field(pred_ds, ('time', 'prediction_timedelta', 'latitude',
                        'longitude'))
    t = field(tgt_ds, ('time', 'latitude', 'longitude'))[t_idx]
    c = field(clim_ds, ('dayofyear', 'hour', 'latitude', 'longitude'))[
        d_idx, h_idx]
    pa, ta = p - c, t - c
    want_rmse = np.sqrt(wmean((p - t) ** 2, w_lat))
    want_acc = wmean(pa * ta, w_lat) / np.sqrt(
        wmean(pa ** 2, w_lat) * wmean(ta ** 2, w_lat))
    sel = {} if level is None else {'level': level}
    name = v if level is None else f'{v}@{level}'
    check(f'{name} global RMSE vs float64', max_rel(
        global_values(results, f'rmse.{v}', **sel), want_rmse), RTOL_AGG,
          'float32 weighted sums over ~2e6 gridpoints per lead')
    check(f'{name} global ACC vs float64', max_rel(
        global_values(results, f'acc.{v}', **sel), want_acc), RTOL_AGG,
          'same float32 weighted sums, three per ratio')
  shutil.rmtree(store_dir, ignore_errors=True)


# -- phase 2 ------------------------------------------------------------------


def make_ensemble_store(path_pred: str, path_tgt: str, nlat: int, nlon: int,
                        members: int, n_init: int, n_lead: int,
                        seed: int = 2020) -> None:
  """Seeded 50-member forecast and target zarr stores (uncompressed).

  Members and targets are iid normals around a per-variable offset, so the
  float32 moment sums see a realistic |mean| >> std (2 m temperature ~
  288 K).
  """
  from weatherbenchx_tpu import zarr_io
  from weatherbenchx_tpu.darray import DimArray

  rng = np.random.default_rng(seed)
  lats = np.linspace(-90, 90, nlat)
  lons = np.linspace(0, 360, nlon, endpoint=False)
  init = (np.datetime64('2020-01-01', 'ns')
          + np.arange(n_init) * np.timedelta64(12, 'h'))
  lead = (np.arange(n_lead) * np.timedelta64(6, 'h')).astype(
      'timedelta64[ns]')
  valid = np.unique((init[:, None] + lead[None, :]).reshape(-1))
  pred, tgt = {}, {}
  for v, (offset, scale) in zip(ENS_VARIABLES, ((288.0, 5.0), (1e5, 1e3))):
    x = rng.standard_normal((members, n_init, n_lead, nlat, nlon),
                            dtype=np.float32)
    pred[v] = DimArray(
        (x * np.float32(scale) + np.float32(offset)),
        ('number', 'time', 'prediction_timedelta', 'latitude', 'longitude'),
        {'number': np.arange(members), 'time': init,
         'prediction_timedelta': lead, 'latitude': lats, 'longitude': lons})
    y = rng.standard_normal((len(valid), nlat, nlon), dtype=np.float32)
    tgt[v] = DimArray(y * np.float32(scale) + np.float32(offset),
                      ('time', 'latitude', 'longitude'),
                      {'time': valid, 'latitude': lats, 'longitude': lons})
  zarr_io.save_dataset_zarr(path_pred, pred, chunks={'time': 1})
  zarr_io.save_dataset_zarr(path_tgt, tgt, chunks={'time': 4})


def ensemble_reference(path_pred: str, path_tgt: str, variable: str) -> dict:
  """Float64 numpy values of the probabilistic metric set, global region."""
  from weatherbenchx_tpu import io as io_lib
  from weatherbenchx_tpu import test_utils

  pda = io_lib.open_dataset_auto(path_pred)[variable]
  tda = io_lib.open_dataset_auto(path_tgt)[variable]
  x = np.asarray(pda.transpose('number', 'time', 'prediction_timedelta',
                               'latitude', 'longitude').values)
  valid = (np.asarray(pda.coord_values('time'))[:, None]
           + np.asarray(pda.coord_values('prediction_timedelta'))[None, :])
  y = np.asarray(tda.transpose('time', 'latitude', 'longitude').values)[
      np.searchsorted(np.asarray(tda.coord_values('time')), valid)]
  w_lat = area_weights(np.asarray(pda.coord_values('latitude')))
  m = x.shape[0]
  spread, skill, mean, sqdev = test_utils.reference_ensemble_stats(x, y)
  var = sqdev / (m - 1)
  umse = (mean - y) ** 2 - var / m
  return {
      'crps': wmean(skill / m, w_lat)
              - 0.5 * wmean(spread / (m * (m - 1)), w_lat),
      'unbiased_spread_skill': np.sqrt(wmean(var, w_lat)
                                       / wmean(umse, w_lat)),
      'unbiased_mean_rmse': np.sqrt(wmean(umse, w_lat)),
      'mean_rmse': np.sqrt(wmean((mean - y) ** 2, w_lat)),
  }


def cross_form_memory() -> None:
  """Two-ensemble CRPS skill at (25, 25, 4, 721, 1440): the broadcast form
  must not materialize the (Mx, My, …) product."""
  import jax
  from weatherbenchx_tpu.darray import DimArray
  from weatherbenchx_tpu.metrics import probabilistic

  shape = (25, 4, 721, 1440)
  dims = ('number', 'lead_time', 'latitude', 'longitude')
  key_x, key_y = jax.random.split(jax.random.key(0))
  x = jax.random.normal(key_x, shape)
  y = jax.random.normal(key_y, shape)

  def skill(x, y):
    out = probabilistic.CRPSSkill().compute({'v': DimArray(x, dims)},
                                            {'v': DimArray(y, dims)})
    return out['v'].data

  fn = jax.jit(skill)
  compiled = fn.lower(x, y).compile()
  temp = compiled.memory_analysis().temp_size_in_bytes
  out = jax.block_until_ready(fn(x, y))
  product = 25 * 25 * 4 * 721 * 1440 * 4
  peak = jax.devices()[0].memory_stats().get('peak_bytes_in_use', -1)
  log(f'  cross form (25, 25, 4, 721, 1440): temp {temp / 1e9:.3f} GB, '
      f'peak_bytes_in_use {peak / 1e9:.3f} GB, product {product / 1e9:.1f} '
      'GB')
  if not (temp < product / 10 and 0 < peak < product / 2):
    raise CheckFailed('cross form materializes the member product')
  xs = np.asarray(x[:, :, :64, :64], np.float64)
  ys = np.asarray(y[:, :, :64, :64], np.float64)
  want = np.abs(xs[:, None] - ys[None]).mean((0, 1))
  check('cross form vs float64 brute force (64x64 corner)',
        max_rel(np.asarray(out)[:, :64, :64], want), RTOL_KERNEL,
        'float32 mean of 625 absolute differences')


def probabilistic_scorecard(res: str = RES) -> None:
  from weatherbenchx_tpu.apps import configs, run_benchmark_evaluation

  nlat, nlon = (int(n) for n in reversed(res.split('x')))
  if configs.RESOLUTIONS.index(res) == len(configs.RESOLUTIONS) - 1:
    cross_form_memory()
  store_dir = os.path.join(WORK, 'ensemble')
  out_dir = os.path.join(WORK, 'ensemble_out')
  shutil.rmtree(store_dir, ignore_errors=True)
  shutil.rmtree(out_dir, ignore_errors=True)
  os.makedirs(store_dir)
  ppath = os.path.join(store_dir, 'ens.zarr')
  tpath = os.path.join(store_dir, 'era5.zarr')
  t0 = time.time()
  make_ensemble_store(ppath, tpath, nlat, nlon, MEMBERS, 1, 4)
  log(f'  stores written in {time.time() - t0:.1f}s (information only)')
  argv = ['--prediction', 'ens', '--resolution', res, '--year', '2020',
          '--variables', ','.join(ENS_VARIABLES),
          '--init_time_start', '2020-01-01',
          '--init_time_stop', '2020-01-01T12',
          '--lead_time_stop_days', '1', '--lead_time_frequency', '6',
          '--lead_time_chunk_size', '4', '--output_dir', out_dir,
          '--prediction_path', ppath, '--target_path', tpath]
  t0 = time.time()
  run_benchmark_evaluation.main(argv)
  log(f'  CLI: {MEMBERS} members, {len(ENS_VARIABLES)} variables, 1 init x '
      f'4 leads in {time.time() - t0:.1f}s (information only, compile '
      'included)')
  results = load_results(out_dir)
  for v in ENS_VARIABLES:
    want = ensemble_reference(ppath, tpath, v)
    for metric, ref in want.items():
      check(f'{metric}.{v} global vs float64',
            max_rel(global_values(results, f'{metric}.{v}'), ref), RTOL_AGG,
            'float32 weighted sums over ~1e6 gridpoints per lead')

  shutil.rmtree(store_dir, ignore_errors=True)
  kernel_at_width((MEMBERS, 1, 4, nlat, nlon))


def kernel_at_width(shape) -> None:
  """The fused ensemble-statistics kernel alone on one chunk's ensemble."""
  import jax
  from weatherbenchx_tpu import test_utils
  from weatherbenchx_tpu.ops import ensemble_stats

  rng = np.random.default_rng(7)
  x = (rng.standard_normal(shape, dtype=np.float32) * np.float32(5)
       + np.float32(288))
  y = (rng.standard_normal(shape[1:], dtype=np.float32) * np.float32(5)
       + np.float32(288))
  x[17, 0, 2, 10, 20] = np.nan
  xd, yd = jax.device_put(x), jax.device_put(y)
  kernel = jax.jit(ensemble_stats.kernel_for(jax.default_backend()))
  t0 = time.time()
  got = jax.block_until_ready(kernel(xd, yd))
  log(f'  kernel compile + first call {time.time() - t0:.2f}s '
      '(information only)')
  times = []
  for _ in range(10):
    t0 = time.perf_counter()
    jax.block_until_ready(kernel(xd, yd))
    times.append(time.perf_counter() - t0)
  log(f'  kernel at {shape} f32: median '
      f'{np.median(times) * 1e3:.3f} ms over 10 calls (information only)')
  want = test_utils.reference_ensemble_stats(x, y)
  for name, g, w in zip(('spread_sum', 'skill_sum', 'mean', 'sq_dev_sum'),
                        got, want):
    check(f'kernel {name} vs float64', max_rel(g, w), RTOL_KERNEL,
          'float32 sums of 50 members')


# -- phase 3 ------------------------------------------------------------------


def four_cards(nlat: int = 721, nlon: int = 1440, members: int = MEMBERS,
               rtol: float = 1e-5) -> None:
  """Phase 2's metric set on a (batch=2, space=2) mesh vs one card."""
  import jax
  from weatherbenchx_tpu import aggregation, binning, time_chunks, weighting
  from weatherbenchx_tpu.apps import configs
  from weatherbenchx_tpu.data import loaders
  from weatherbenchx_tpu.metrics import deterministic, probabilistic
  from weatherbenchx_tpu.metrics import wrappers
  from weatherbenchx_tpu.parallel import pipeline

  if len(jax.devices()) < 4:
    raise CheckFailed(f'need 4 devices, found {len(jax.devices())}')
  store_dir = os.path.join(WORK, 'four_cards')
  shutil.rmtree(store_dir, ignore_errors=True)
  os.makedirs(store_dir)
  ppath = os.path.join(store_dir, 'ens.zarr')
  tpath = os.path.join(store_dir, 'era5.zarr')
  n_init = 4
  make_ensemble_store(ppath, tpath, nlat, nlon, members, n_init, 4)
  init = (np.datetime64('2020-01-01', 'ns')
          + np.arange(n_init) * np.timedelta64(12, 'h'))
  lead = (np.arange(4) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
  times = time_chunks.TimeChunks(init, lead, init_time_chunk_size=n_init,
                                 lead_time_chunk_size=4)
  metrics = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'unbiased_spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
      'mean_rmse': wrappers.WrappedMetric(
          deterministic.RMSE(), [wrappers.EnsembleMean(which='predictions')]),
  }
  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions(configs.REGIONS)], masked=True)

  def run(**kwargs):
    t0 = time.time()
    values = pipeline.evaluate(
        metrics, agg,
        loaders.PredictionsFromDataset(path=ppath,
                                       variables=list(ENS_VARIABLES)),
        loaders.TargetsFromDataset(path=tpath, variables=list(ENS_VARIABLES)),
        times, **kwargs)
    return values, time.time() - t0

  mesh = jax.make_mesh((2, 2), ('batch', 'space'))
  sharded, t_mesh = run(mesh=mesh, dim_to_axis={'init_time': 'batch',
                                                'longitude': 'space'})
  single, t_one = run()
  log(f'  4 inits x 4 leads x {members} members: mesh {dict(mesh.shape)} '
      f'{t_mesh:.1f}s, one card {t_one:.1f}s (information only, compile '
      'included)')
  if set(sharded) != set(single):
    raise CheckFailed(f'metric sets differ: {sorted(sharded)} vs '
                      f'{sorted(single)}')
  worst = max(max_rel(sharded[k].transpose(*single[k].dims).values,
                      single[k].values) for k in single)
  check(f'sharded == one card, {len(single)} metric variables', worst, rtol,
        'the all-reduce sums partial sums in another order')
  shutil.rmtree(store_dir, ignore_errors=True)


# -- driver -------------------------------------------------------------------


def main() -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument('--four_cards', action='store_true',
                  help='run only phase 3, on a 2x2 mesh of four cards')
  args = ap.parse_args()

  import jax
  if jax.default_backend() != 'gpu':
    print(f'chip_smoke: no GPU (JAX backend {jax.default_backend()!r})',
          file=sys.stderr)
    return 2
  try:
    from weatherbenchx_tpu import compile_cache, native
  except ImportError as e:
    print(f'chip_smoke: the weatherbenchx_tpu package is not beside this '
          f'script ({e})', file=sys.stderr)
    return 2
  log(f'cache: {compile_cache.enable()}')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True)
  log(smi.stdout.strip())
  log(f'devices: {jax.devices()}')
  log('zarr decoder: '
      + ('native' if native.zarrcodec_available() else 'pure Python'))
  phases = ([('phase 3: four cards', four_cards)] if args.four_cards else
            [('phase 2: probabilistic scorecard', probabilistic_scorecard),
             ('phase 1: deterministic scorecard', deterministic_scorecard)])
  for label, fn in phases:
    log(label)
    t0 = time.time()
    try:
      fn()
    except CheckFailed as e:
      print(f'chip_smoke: {label} failed: {e}', file=sys.stderr)
      return 1
    log(f'  {label} passed in {time.time() - t0:.1f}s')
  dev = jax.devices()[0]
  print(json.dumps({'ok': True, 'device': {
      'platform': dev.platform, 'kind': dev.device_kind,
      'count': len(jax.devices())}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
