"""Benchmark: per-device evaluation throughput on the production workload shape.

Workload (mirrors the reference's production benchmark config,
``public_benchmark/run_benchmark_evaluation.py:96-101,341-354``): 0.25°
grid (1440×721), chunked evaluation with area weighting; deterministic
RMSE/MAE/Bias on a single-member forecast plus — once the probabilistic
suite is present — fair CRPS (sort-based) on an ensemble.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "gridpoint_stats_per_sec",
   "vs_baseline": N, "device": {...}}
vs_baseline is the ratio against a single-process numpy implementation of
the same chunk evaluation (a stand-in for one Beam-on-CPU worker, the
reference's execution model). Step times are medians of individually
dispatched steps, each ended by ``block_until_ready``. Runs on a GPU only:
it exits non-zero, printing no result, when JAX finds none.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def _make_data(n_lead, nlat, nlon, ens=None, dtype=np.float32, seed=0):
  rng = np.random.default_rng(seed)
  lats = np.linspace(-90, 90, nlat)
  lons = np.linspace(0, 360, nlon, endpoint=False)
  shape = (1, n_lead, nlat, nlon)
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  if ens:
    shape = (ens,) + shape
    dims = ('number',) + dims
  pred = rng.standard_normal(shape).astype(dtype)
  tgt = rng.standard_normal((1, n_lead, nlat, nlon)).astype(dtype)
  return pred, tgt, dims, lats, lons


def _numpy_baseline_time(pred, tgt, w, ens, iters=3):
  """Single-process numpy version of the same statistics (Beam-worker model)."""
  times = []
  for _ in range(iters):
    t0 = time.perf_counter()
    if ens:
      # CRPS skill + spread via the sort/rank form (reference
      # probabilistic.py:214-247) plus ensemble-mean MSE.
      m = pred.shape[0]
      skill = np.abs(pred - tgt[None]).mean(axis=0)
      sorted_pred = np.sort(pred, axis=0)
      ranks = np.arange(1, m + 1).reshape((m,) + (1,) * (pred.ndim - 1))
      spread = 2 * ((2 * ranks - m - 1) * sorted_pred).sum(axis=0) / (
          m * (m - 1))
      se = (pred.mean(axis=0) - tgt) ** 2
      # Aggregate the same THREE statistics the JAX path aggregates
      # (CRPSSkill, CRPSSpread, UnbiasedEnsembleMeanSquaredError) so the
      # per-stat normalization is identical on both sides of the ratio.
      stats = [skill, spread, se]
    else:
      err = pred - tgt
      stats = [err, np.abs(err), err ** 2]
    for s in stats:
      _ = (s * w).sum()
      _ = (np.ones_like(s) * w).sum()
    times.append(time.perf_counter() - t0)
  return min(times), len(stats)


def step_seconds(fn, *args, reps: int = 20) -> float:
  """Median wall time of one dispatched call, ended by block_until_ready.

  The first call (compilation) is not timed.
  """
  import jax
  jax.block_until_ready(fn(*args))
  times = []
  for _ in range(reps):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    times.append(time.perf_counter() - t0)
  return float(np.median(times))


def device_info() -> dict:
  import jax
  dev = jax.devices()[0]
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True)
  return {'platform': dev.platform, 'kind': dev.device_kind,
          'count': len(jax.devices()), 'nvidia_smi': smi.stdout.strip()}


def main():
  import jax
  if jax.default_backend() != 'gpu':
    print(f'bench.py: no GPU (JAX backend {jax.default_backend()!r})',
          file=sys.stderr)
    sys.exit(2)
  from weatherbenchx_tpu import compile_cache
  compile_cache.enable()
  from weatherbenchx_tpu import aggregation, weighting
  from weatherbenchx_tpu.darray import DimArray
  from weatherbenchx_tpu.metrics import deterministic
  from weatherbenchx_tpu.parallel import evaluator as evaluator_lib

  try:
    from weatherbenchx_tpu.metrics import probabilistic
    has_prob = True
  except ImportError:
    has_prob = False

  if os.environ.get('WBX_BENCH_HEADLINE', '1') == '0':
    # Skip the headline and run (a subset of) the full suite.
    print(json.dumps({'full_suite': full_suite(), 'device': device_info()}))
    return

  n_lead, nlat, nlon = 4, 721, 1440
  ens = 50 if has_prob else None
  pred_np, tgt_np, dims, lats, lons = _make_data(n_lead, nlat, nlon, ens)
  coords = {
      'init_time': np.array(['2020-01-01'], dtype='datetime64[ns]'),
      'lead_time': (np.arange(n_lead) * np.timedelta64(6, 'h')
                    ).astype('timedelta64[ns]'),
      'latitude': lats, 'longitude': lons,
  }
  if ens:
    coords['number'] = np.arange(ens)
  preds = {'z500': DimArray(pred_np, dims, coords)}
  tgts = {'z500': DimArray(tgt_np, dims[-4:],
                           {k: coords[k] for k in dims[-4:]})}

  if has_prob:
    metrics = {
        'crps': probabilistic.CRPSEnsemble(use_sort=True),
        'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
    }
    n_stats = 3  # CRPSSkill, CRPSSpread, UnbiasedEnsembleMeanSquaredError
  else:
    metrics = {'rmse': deterministic.RMSE(), 'mae': deterministic.MAE(),
               'bias': deterministic.Bias()}
    n_stats = 3

  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()])
  ev = evaluator_lib.ChunkEvaluator(metrics=metrics, aggregator=agg)
  p = evaluator_lib.prepare_chunk(preds, is_predictions=True)
  t = evaluator_lib.prepare_chunk(tgts)
  # Stage inputs on device once: the production pipeline overlaps H2D with
  # compute, so steady-state throughput is the compiled step itself.
  p = jax.device_put(p)
  t = jax.device_put(t)

  # Aggregation operands (weights/bins) and statistic resources
  # (climatologies) enter the program as ARGUMENTS, as in the pipeline.
  bench_ops = ev.operands_for(p, t)
  bench_res = ev.resources()
  dt = step_seconds(jax.jit(ev._eval_fn), p, t, bench_ops, bench_res)

  gridpoints = n_lead * nlat * nlon
  value = gridpoints * n_stats / dt

  # Numpy single-process baseline on a smaller slice, scaled.
  frac = 4  # evaluate 1/frac of the leads to keep the baseline quick
  base_dt, base_nstats = _numpy_baseline_time(
      pred_np[..., :n_lead // frac, :, :] if ens else
      pred_np[:, :n_lead // frac], tgt_np[:, :n_lead // frac],
      np.cos(np.deg2rad(lats))[:, None].astype(np.float32), ens)
  base_value = (gridpoints // frac) * base_nstats / base_dt

  result = {
      'metric': ('crps+rmse_0.25deg_50ens' if has_prob
                 else 'rmse_mae_bias_0.25deg'),
      'value': round(value / 1e6, 3),
      'unit': 'M_gridpoint_stats_per_sec',
      'vs_baseline': round(value / base_value, 2),
      'step_ms': dt * 1e3,
      'device': device_info(),
  }
  if os.environ.get('WBX_BENCH_FULL', '1') != '0':
    try:
      result['full_suite'] = full_suite()
    except Exception as e:  # never lose the headline to a full-suite failure
      result['full_suite_error'] = f'{type(e).__name__}: {e}'
  print(json.dumps(result))


def full_suite(time_budget_s=240.0):
  """Per-family ms/step at 0.25° with the PRODUCTION aggregation shape.

  Every family runs with the benchmark CLI's aggregator
  (``apps/run_benchmark_evaluation.py:213-226``): 17 ECMWF regions
  land-augmented to 34 bins, exact sin-bounds area weighting, masked
  aggregation. Families cover the surfaces the headline bench misses:
  SEEPS climatology gathers, FSS convolutions, REV threshold fan-out,
  rank histogram, vector RMSE.

  Returns {family: {'ms_per_step': x, 'stats_per_step': n}} plus meta.
  Families past ``time_budget_s`` are reported as 'skipped' so a slow
  run degrades coverage, not the whole bench.
  """
  import gc

  import jax

  from weatherbenchx_tpu import aggregation, binning, weighting
  from weatherbenchx_tpu.apps import configs as configs_lib
  from weatherbenchx_tpu.darray import DimArray
  from weatherbenchx_tpu.metrics import (categorical, deterministic,
                                         probabilistic, spatial)
  from weatherbenchx_tpu.parallel import evaluator as evaluator_lib

  t_start = time.perf_counter()
  n_lead, nlat, nlon = 4, 721, 1440
  lats = np.linspace(-90, 90, nlat)
  lons = np.linspace(0, 360, nlon, endpoint=False)
  init = np.array(['2020-01-03'], dtype='datetime64[ns]')
  leads = (np.arange(n_lead) * np.timedelta64(6, 'h')
           ).astype('timedelta64[ns]')
  base_coords = {'init_time': init, 'lead_time': leads,
                 'latitude': lats, 'longitude': lons}
  gdims = ('init_time', 'lead_time', 'latitude', 'longitude')
  gshape = (1, n_lead, nlat, nlon)
  rng = np.random.default_rng(0)

  # Production aggregator: 17 regions + land bins = 34, masked, weighted.
  yy, xx = np.meshgrid(np.deg2rad(lats), np.deg2rad(lons), indexing='ij')
  land = (np.sin(3 * yy) * np.cos(4 * xx) > 0.1)
  land_da = DimArray(land, ('latitude', 'longitude'),
                     {'latitude': lats, 'longitude': lons})
  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      bin_by=[binning.Regions(configs_lib.REGIONS, land_sea_mask=land_da)],
      weigh_by=[weighting.GridAreaWeighting()],
      masked=True)

  def grid(seed, ens=None, positive=False, scale=1.0, boolean=False):
    r = np.random.default_rng(seed)
    shape = ((ens,) + gshape) if ens else gshape
    a = r.random(shape, dtype=np.float32)
    if positive:
      a = (-np.log(a + 1e-6) * scale).astype(np.float32)
    elif boolean:
      return a > 0.5
    coords = dict(base_coords)
    dims = gdims
    if ens:
      coords['number'] = np.arange(ens)
      dims = ('number',) + gdims
    return DimArray(a, dims, coords)

  clim_hours = np.array([0, 6, 12, 18])
  clim_doys = np.arange(1, 11)

  def clim(seed, lo=0.0, hi=1.0):
    r = np.random.default_rng(seed)
    a = r.uniform(lo, hi, (len(clim_hours), len(clim_doys), nlat, nlon)
                  ).astype(np.float32)
    return DimArray(a, ('hour', 'dayofyear', 'latitude', 'longitude'),
                    {'hour': clim_hours, 'dayofyear': clim_doys,
                     'latitude': lats, 'longitude': lons})

  def measure(metrics, preds, tgts, n_stats, min_bytes=None):
    ev = evaluator_lib.ChunkEvaluator(metrics=metrics, aggregator=agg)
    p = jax.device_put(
        evaluator_lib.prepare_chunk(preds, ev._clim_stats,
                                    is_predictions=True))
    t = jax.device_put(evaluator_lib.prepare_chunk(tgts))
    ops = ev.operands_for(p, t)
    res = ev.resources()
    fn = jax.jit(ev._eval_fn)
    dt = step_seconds(fn, p, t, ops, res)
    gridpoints = n_lead * nlat * nlon
    out = {'ms_per_step': dt * 1e3,
           'gridpoint_stats_per_sec_M': gridpoints * n_stats / dt / 1e6}
    if min_bytes is not None:
      # Every input array and aggregation operand read exactly once: the
      # traffic of a perfectly fused step, over the measured step time.
      out['min_io_MB'] = min_bytes / 1e6
      out['min_io_GBps'] = min_bytes / dt / 1e9
    ca = fn.lower(p, t, ops, res).compile().cost_analysis()
    if isinstance(ca, list):
      ca = ca[0] if ca else {}
    # XLA's cost model counts operands once per consuming op (an upper
    # envelope of traffic), and custom calls such as Pallas kernels count
    # zero flops.
    out['xla_cost_flops_G'] = float(ca.get('flops', 0.0)) / 1e9
    out['xla_cost_bytes_MB'] = float(ca.get('bytes accessed', 0.0)) / 1e6
    return out

  # Analytic minimum device-memory traffic: every input read exactly once.
  var_bytes = n_lead * nlat * nlon * 4          # one (1,L,lat,lon) f32 var
  mask_bytes = 34 * nlat * nlon * 4             # 34-bin region mask stack

  def fam_det():
    preds = {'geopotential': grid(1), '2m_temperature': grid(2)}
    tgts = {'geopotential': grid(3), '2m_temperature': grid(4)}
    c = {'geopotential': clim(5), '2m_temperature': clim(6)}
    metrics = {
        'rmse': deterministic.RMSE(), 'mse': deterministic.MSE(),
        'bias': deterministic.Bias(),
        'acc': deterministic.ACC(climatology=c),
        'activity': deterministic.PredictionActivity(climatology=c),
    }
    # unique stats: Error, SquaredError, SqPredAnom, SqTgtAnom, AnomCov ×2var
    # min IO: 2 preds + 2 tgts + 2 gathered clim slices + the mask stack
    return measure(metrics, preds, tgts, n_stats=10,
                   min_bytes=6 * var_bytes + mask_bytes)

  def fam_vector():
    preds = {'u': grid(7), 'v': grid(8)}
    tgts = {'u': grid(9), 'v': grid(10)}
    metrics = {'vector_rmse': deterministic.WindVectorRMSE(
        u_name='u', v_name='v', vector_name='wind')}
    return measure(metrics, preds, tgts, n_stats=1,
                   min_bytes=4 * var_bytes + mask_bytes)

  def fam_seeps():
    preds = {'total_precipitation_24hr': grid(11, positive=True,
                                              scale=0.002)}
    tgts = {'total_precipitation_24hr': grid(12, positive=True,
                                             scale=0.002)}
    c = {'total_precipitation_24hr_seeps_threshold': clim(13, 0.001, 0.003),
         'total_precipitation_24hr_seeps_dry_fraction': clim(14, 0.05, 0.95)}
    metrics = {'seeps': categorical.SEEPS(
        variables=['total_precipitation_24hr'], climatology=c)}
    # preds + tgts + 2 gathered clim fields + mask stack
    return measure(metrics, preds, tgts, n_stats=1,
                   min_bytes=4 * var_bytes + mask_bytes)

  def fam_fss():
    preds = {'precip': DimArray(grid(15, boolean=True), gdims, base_coords)}
    tgts = {'precip': DimArray(grid(16, boolean=True), gdims, base_coords)}
    metrics = {'fss': spatial.FSS(neighborhood_size_in_pixels=[3],
                                  wrap_longitude=True)}
    # bool inputs (1 B/elt) + mask stack
    return measure(metrics, preds, tgts, n_stats=3,
                   min_bytes=2 * (var_bytes // 4) + mask_bytes)

  def fam_prob():
    m = 50
    preds = {'2m_temperature': grid(17, ens=m)}
    tgts = {'2m_temperature': grid(18)}
    metrics = {
        'crps': probabilistic.CRPSEnsemble(use_sort=True),
        'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
        'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
    }

    # 50-member ensemble + target + mask stack, each read once
    return measure(metrics, preds, tgts, n_stats=4,
                   min_bytes=(m + 1) * var_bytes + mask_bytes)

  def fam_rank_histogram():
    preds = {'2m_temperature': grid(19, ens=50)}
    tgts = {'2m_temperature': grid(20)}
    metrics = {'rank_histogram': probabilistic.RankHistogram()}
    return measure(metrics, preds, tgts, n_stats=51,
                   min_bytes=51 * var_bytes + mask_bytes)

  def fam_rev():
    ens_frac = np.random.default_rng(21).random(
        (8,) + gshape, dtype=np.float32)
    prob = (ens_frac > 0.5).mean(axis=0).astype(np.float32)
    preds = {'2m_temperature': DimArray(prob, gdims, base_coords)}
    tgts = {'2m_temperature': DimArray(grid(22, boolean=True), gdims,
                                       base_coords)}
    metrics = {'rev': probabilistic.RelativeEconomicValue(
        probability_thresholds=(np.arange(8) + 0.5) / 8,
        statistic_suffix='bench8',
        cost_loss_ratios=np.geomspace(0.01, 1, 9)[:-1])}
    # probability field + bool target + mask stack
    return measure(metrics, preds, tgts, n_stats=24,
                   min_bytes=var_bytes + var_bytes // 4 + mask_bytes)

  families = [
      ('deterministic_acc_activity', fam_det),
      ('probabilistic_crps_spread', fam_prob),
      ('seeps', fam_seeps),
      ('fss', fam_fss),
      ('rank_histogram', fam_rank_histogram),
      ('rev', fam_rev),
      ('vector_rmse', fam_vector),
  ]
  out = {'bins': 34, 'grid': '0.25deg', 'n_lead': n_lead, 'masked': True}
  only = os.environ.get('WBX_BENCH_FAMILIES')  # comma list, for A/B runs
  if only:
    wanted = {f.strip() for f in only.split(',')}
    families = [(n, f) for n, f in families if n in wanted]
  for name, fn in families:
    if time.perf_counter() - t_start > time_budget_s:
      out[name] = 'skipped_time_budget'
      continue
    t_fam = time.perf_counter()
    try:
      out[name] = fn()
    except Exception as e:
      out[name] = f'error: {type(e).__name__}: {e}'
    print(f'# full_suite {name}: {time.perf_counter() - t_fam:.1f}s '
          f'-> {out[name]}', file=sys.stderr, flush=True)
    gc.collect()
  return out


if __name__ == '__main__':
  main()
