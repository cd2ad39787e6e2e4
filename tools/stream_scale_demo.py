"""Year-scale 0.25-degree streaming-evaluation demo.

Validates the lazy windowed-read path at production scale: a full-year
6-hourly 0.25-degree store (18 GB on disk: 12 GB predictions + 6 GB
targets) evaluates chunk-by-chunk with bounded RSS — the process never
holds more than a few prefetched chunks, regardless of store size.
(The reference achieves this with lazy Zarr + per-chunk compute,
``data_loaders/base.py:146-153``; here it's LazyArray windowed preads.)

Usage:
  python tools/stream_scale_demo.py --make_store [--format=wbx|zarr
      --compressor=none|zstd|blosc]            # writes <checkout>/.stores/stream
  python tools/stream_scale_demo.py --run [--backend=cpu|gpu] [--chunk=32
      --format=wbx|zarr]

The zarr variant exercises the production-shaped path: a chunked v2 store
(optionally blosc-lz4/zstd compressed, like real ERA5 mirrors) streamed
through the native parallel cell decoder.

Run --make_store and --run as separate invocations so store generation
doesn't pollute the evaluation's peak-RSS measurement.
"""

import argparse
import json
import os
import resource
import time

import numpy as np
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

STORE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), '.stores', 'stream')
N_INIT = 1460  # 1 year, 6-hourly (deterministic mode)
N_LEAD = 2
NLAT, NLON = 721, 1440
ENS_N_INIT = 31  # ensemble mode: 1 month daily, north-star metric set
ENS_MEMBERS = 50


def _store_paths(fmt, ens=False):
  tag = 'ens_' if ens else ''
  return (f'{STORE_DIR}/{tag}era5.{fmt}', f'{STORE_DIR}/{tag}preds.{fmt}')


def make_ens_store(fmt: str = 'zarr', compressor='blosc'):
  """Month-scale 0.25-degree 50-member store: the north-star workload shape
  (full-year 0.25-degree ERA5 vs 50-member ENS CRPS+RMSE) at month scale
  so a single card can stream it end to end."""
  from weatherbenchx_tpu import zarr_io
  from weatherbenchx_tpu.darray import DimArray

  os.makedirs(STORE_DIR, exist_ok=True)
  rng = np.random.default_rng(1)
  init_times = (np.datetime64('2020-01-01', 'ns')
                + np.arange(ENS_N_INIT) * np.timedelta64(24, 'h'))
  lead_times = np.array([np.timedelta64(24, 'h')], 'timedelta64[ns]')
  valid_times = init_times + lead_times[0]
  lats = np.linspace(90, -90, NLAT)
  lons = np.linspace(0, 360, NLON, endpoint=False)
  tile = rng.standard_normal((8, NLAT, NLON)).astype(np.float32)

  def filled(shape):
    out = np.empty(shape + (NLAT, NLON), np.float32)
    flat = out.reshape(-1, NLAT, NLON)
    for i in range(flat.shape[0]):
      flat[i] = tile[i % 8]
      flat[i, 0, 0] = i
    return out

  tgt_path, pred_path = _store_paths(fmt, ens=True)
  tgt = {'2m_temperature': DimArray(
      filled((ENS_N_INIT,)), ('valid_time', 'latitude', 'longitude'),
      {'valid_time': valid_times, 'latitude': lats, 'longitude': lons})}
  if fmt == 'zarr':
    zarr_io.save_dataset_zarr(tgt_path, tgt, chunks={'valid_time': 4},
                              compressor=compressor)
  else:
    from weatherbenchx_tpu import io as io_lib
    io_lib.save_dataset(tgt_path, tgt)
  del tgt
  pred = {'2m_temperature': DimArray(
      filled((ENS_MEMBERS, ENS_N_INIT, 1)),
      ('number', 'init_time', 'lead_time', 'latitude', 'longitude'),
      {'number': np.arange(ENS_MEMBERS), 'init_time': init_times,
       'lead_time': lead_times, 'latitude': lats, 'longitude': lons})}
  if fmt == 'zarr':
    zarr_io.save_dataset_zarr(
        pred_path, pred, chunks={'init_time': 4, 'number': ENS_MEMBERS},
        compressor=compressor)
  else:
    from weatherbenchx_tpu import io as io_lib
    io_lib.save_dataset(pred_path, pred)
  gb = _store_gb(fmt, ens=True)
  print(f'wrote ensemble store ({fmt}, {compressor}): {gb:.1f} GB')


def run_ens(backend: str, chunk: int, fmt: str = 'zarr'):
  """CRPS(sort) + unbiased spread/skill + ens-mean RMSE streaming eval —
  the production probabilistic metric set (reference
  run_benchmark_evaluation.py:341-354) on the 0.25-degree ensemble store."""
  import jax
  if backend == 'cpu':
    jax.config.update('jax_platforms', 'cpu')
  from weatherbenchx_tpu import compile_cache
  compile_cache.enable()

  from weatherbenchx_tpu import aggregation, weighting
  from weatherbenchx_tpu import time_chunks as time_chunks_lib
  from weatherbenchx_tpu.data import loaders
  from weatherbenchx_tpu.metrics import probabilistic, wrappers, deterministic
  from weatherbenchx_tpu.parallel import pipeline as pipeline_lib

  init_times = (np.datetime64('2020-01-01', 'ns')
                + np.arange(ENS_N_INIT) * np.timedelta64(24, 'h'))
  lead_times = np.array([np.timedelta64(24, 'h')], 'timedelta64[ns]')
  metrics = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'mean_rmse': wrappers.WrappedMetric(
          deterministic.RMSE(), [wrappers.EnsembleMean(
              which='predictions', ensemble_dim='number')]),
  }
  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()])
  sort_lat = lambda ds: {
      k: (v.sortby('latitude') if 'latitude' in v.dims else v)
      for k, v in ds.items()}
  tgt_path, pred_path = _store_paths(fmt, ens=True)
  pipe = pipeline_lib.EvaluationPipeline(
      metrics=metrics, aggregator=agg,
      predictions_loader=loaders.PredictionsFromDataset(
          path=pred_path, rename_dimensions=None,
          preprocessing_fn=sort_lat),
      targets_loader=loaders.TargetsFromDataset(
          path=tgt_path, rename_dimensions=None,
          preprocessing_fn=sort_lat),
      times=time_chunks_lib.TimeChunks(
          init_times, lead_times, init_time_chunk_size=chunk),
      prefetch=2)
  t0 = time.monotonic()
  values = pipe.run().metric_values(metrics)
  crps = float(np.asarray(values['crps.2m_temperature'].values).ravel()[0])
  ssr = float(np.asarray(
      values['spread_skill.2m_temperature'].values).ravel()[0])
  wall = time.monotonic() - t0
  store_gb = _store_gb(fmt, ens=True)
  peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
  pts = ENS_N_INIT * NLAT * NLON
  print(json.dumps({
      'mode': 'ensemble', 'backend': backend, 'format': fmt,
      'wall_seconds': round(wall, 1), 'store_gb': round(store_gb, 2),
      'peak_rss_gb': round(peak_gb, 2),
      'ens_gridpoints_per_second': round(pts * ENS_MEMBERS / wall),
      'chunks': int(np.ceil(ENS_N_INIT / chunk)),
      'crps_global': round(crps, 5), 'spread_skill': round(ssr, 5),
  }))


def make_store(fmt: str = 'wbx', compressor=None):
  from weatherbenchx_tpu import io as io_lib
  from weatherbenchx_tpu.darray import DimArray

  os.makedirs(STORE_DIR, exist_ok=True)
  rng = np.random.default_rng(0)
  init_times = (np.datetime64('2020-01-01', 'ns')
                + np.arange(N_INIT) * np.timedelta64(6, 'h'))
  lead_times = (np.arange(N_LEAD) * np.timedelta64(6, 'h')
                ).astype('timedelta64[ns]')
  valid_times = (np.datetime64('2020-01-01', 'ns')
                 + np.arange(N_INIT + N_LEAD) * np.timedelta64(6, 'h'))
  lats = np.linspace(90, -90, NLAT)  # descending, like real ERA5 stores
  lons = np.linspace(0, 360, NLON, endpoint=False)

  # Fill from a small random tile: full-entropy content at memcpy speed.
  tile = rng.standard_normal((8, NLAT, NLON)).astype(np.float32)

  def filled(n_outer, extra_shape=()):
    out = np.empty((n_outer,) + extra_shape + (NLAT, NLON), np.float32)
    flat = out.reshape(-1, NLAT, NLON)
    for i in range(flat.shape[0]):
      flat[i] = tile[i % tile.shape[0]]
      flat[i, 0, 0] = i  # every slab distinct
    return out

  tgt = {'2m_temperature': DimArray(
      filled(N_INIT + N_LEAD), ('valid_time', 'latitude', 'longitude'),
      {'valid_time': valid_times, 'latitude': lats, 'longitude': lons})}
  tgt_path, pred_path = _store_paths(fmt)
  if fmt == 'zarr':
    from weatherbenchx_tpu import zarr_io
    zarr_io.save_dataset_zarr(tgt_path, tgt, chunks={'valid_time': 8},
                              compressor=compressor)
  else:
    io_lib.save_dataset(tgt_path, tgt)
  del tgt

  pred = {'2m_temperature': DimArray(
      filled(N_INIT, (N_LEAD,)),
      ('init_time', 'lead_time', 'latitude', 'longitude'),
      {'init_time': init_times, 'lead_time': lead_times,
       'latitude': lats, 'longitude': lons})}
  if fmt == 'zarr':
    from weatherbenchx_tpu import zarr_io
    zarr_io.save_dataset_zarr(pred_path, pred, chunks={'init_time': 8},
                              compressor=compressor)
  else:
    io_lib.save_dataset(pred_path, pred)
  gb = _store_gb(fmt)
  print(f'wrote {STORE_DIR} ({fmt}, {compressor}): {gb:.1f} GB')


def _store_gb(fmt, ens=False):
  total = 0
  for p in _store_paths(fmt, ens=ens):
    if os.path.isdir(p):
      total += sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _, fs in os.walk(p) for f in fs)
    else:
      total += os.path.getsize(p)
  return total / 1e9


def run(backend: str, chunk: int, fmt: str = 'wbx'):
  import jax
  if backend == 'cpu':
    jax.config.update('jax_platforms', 'cpu')
  from weatherbenchx_tpu import compile_cache
  compile_cache.enable()

  from weatherbenchx_tpu import aggregation, binning, weighting
  from weatherbenchx_tpu import time_chunks as time_chunks_lib
  from weatherbenchx_tpu.data import loaders
  from weatherbenchx_tpu.metrics import deterministic
  from weatherbenchx_tpu.parallel import pipeline as pipeline_lib

  init_times = (np.datetime64('2020-01-01', 'ns')
                + np.arange(N_INIT) * np.timedelta64(6, 'h'))
  lead_times = (np.arange(N_LEAD) * np.timedelta64(6, 'h')
                ).astype('timedelta64[ns]')

  metrics = {'rmse': deterministic.RMSE(), 'mse': deterministic.MSE()}
  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions({'global': ((-90, 90), (0, 360)),
                               'nh': ((20, 90), (0, 360))})])
  sort_lat = lambda ds: {
      k: (v.sortby('latitude') if 'latitude' in v.dims else v)
      for k, v in ds.items()}
  pipe = pipeline_lib.EvaluationPipeline(
      metrics=metrics, aggregator=agg,
      predictions_loader=loaders.PredictionsFromDataset(
          path=_store_paths(fmt)[1], rename_dimensions=None,
          preprocessing_fn=sort_lat),
      targets_loader=loaders.TargetsFromDataset(
          path=_store_paths(fmt)[0], rename_dimensions=None,
          preprocessing_fn=sort_lat),
      times=time_chunks_lib.TimeChunks(
          init_times, lead_times, init_time_chunk_size=chunk),
      prefetch=2)

  t0 = time.monotonic()
  values = pipe.run().metric_values(metrics)
  rmse = float(np.asarray(values['rmse.2m_temperature'].values).ravel()[0])
  wall = time.monotonic() - t0
  store_gb = _store_gb(fmt)
  peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
  pts = N_INIT * N_LEAD * NLAT * NLON
  print(json.dumps({
      'backend': backend, 'format': fmt, 'wall_seconds': round(wall, 1),
      'store_gb': round(store_gb, 2), 'peak_rss_gb': round(peak_gb, 2),
      'gridpoints': pts, 'gridpoints_per_second': round(pts / wall),
      'chunks': int(np.ceil(N_INIT / chunk)), 'rmse_global': round(rmse, 5),
  }))
  if backend == 'cpu':
    # Boundedness is asserted on the CPU backend, where host RSS also
    # counts the arrays the device holds; on the GPU it is only reported.
    assert peak_gb < store_gb / 3, (
        f'RSS {peak_gb:.1f} GB not bounded vs store {store_gb:.1f} GB')


if __name__ == '__main__':
  ap = argparse.ArgumentParser()
  ap.add_argument('--make_store', action='store_true')
  ap.add_argument('--run', action='store_true')
  ap.add_argument('--backend', default='gpu', choices=['gpu', 'cpu'])
  ap.add_argument('--chunk', type=int, default=32)
  ap.add_argument('--format', default='wbx', choices=['wbx', 'zarr'])
  ap.add_argument('--compressor', default='none',
                  choices=['none', 'zstd', 'blosc'])
  ap.add_argument('--ens', action='store_true',
                  help='month-scale 50-member CRPS workload instead of the '
                       'year-scale deterministic one')
  args = ap.parse_args()
  comp = None if args.compressor == 'none' else args.compressor
  if args.make_store:
    if args.ens:
      make_ens_store(args.format, comp)
    else:
      make_store(args.format, comp)
  if args.run:
    if args.ens:
      run_ens(args.backend, args.chunk, args.format)
    else:
      run(args.backend, args.chunk, args.format)
