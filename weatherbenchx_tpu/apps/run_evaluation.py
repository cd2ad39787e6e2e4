"""Example evaluation CLI: RMSE/MSE with area weighting and region bins.

The JAX equivalent of the reference's
``evaluation_scripts/run_example_evaluation.py:60-201`` — same flags, same
metric/aggregation setup, with the Beam pipeline replaced by the
single-controller device driver.

Example:
  python -m weatherbenchx_tpu.apps.run_evaluation \
      --prediction_path=preds.npz --target_path=targets.npz \
      --time_start=2020-01-01 --time_stop=2020-01-11 \
      --output_path=results.npz
"""

import argparse
from typing import Optional, Sequence

import numpy as np

from weatherbenchx_tpu import aggregation, binning, compile_cache, weighting
from weatherbenchx_tpu import time_chunks as time_chunks_lib
from weatherbenchx_tpu.data import loaders
from weatherbenchx_tpu.metrics import deterministic
from weatherbenchx_tpu.parallel import pipeline as pipeline_lib

DEFAULT_VARIABLES = [
    'geopotential',
    'temperature',
    'u_component_of_wind',
    'v_component_of_wind',
    'specific_humidity',
    '2m_temperature',
    'mean_sea_level_pressure',
]


def build_parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--prediction_path', required=True,
                 help='Forecasts to evaluate (.npz container or, with '
                      'xarray installed, Zarr/netCDF)')
  p.add_argument('--target_path', required=True,
                 help='Ground truth (.npz container or Zarr/netCDF)')
  p.add_argument('--time_start', default='2020-01-01',
                 help='ISO 8601 start of evaluation inits (inclusive)')
  p.add_argument('--time_stop', default='2020-12-31',
                 help='ISO 8601 end of evaluation inits (exclusive)')
  p.add_argument('--time_frequency', type=int, default=12,
                 help='Init frequency in hours')
  p.add_argument('--time_chunk_size', type=int, default=None)
  p.add_argument('--lead_time_start', type=int, default=0,
                 help='Lead time start in hours')
  p.add_argument('--lead_time_stop', type=int, default=24 * 10,
                 help='Lead time end in hours (exclusive)')
  p.add_argument('--lead_time_frequency', type=int, default=6,
                 help='Lead time frequency in hours')
  p.add_argument('--lead_time_chunk_size', type=int, default=None)
  p.add_argument('--levels', default=None,
                 help='Comma-delimited pressure levels to select')
  p.add_argument('--variables', default=','.join(DEFAULT_VARIABLES),
                 help='Comma-delimited variables to evaluate')
  p.add_argument('--reduce_dims', default='init_time,latitude,longitude',
                 help='Comma-delimited dims to reduce over')
  p.add_argument('--output_path', required=True,
                 help='File for metric results (.npz)')
  p.add_argument('--aggregation_state_output_path', default=None,
                 help='Optional file for the final AggregationState (.npz)')
  p.add_argument('--checkpoint_path', default=None,
                 help='Optional running-state checkpoint path (resume)')
  p.add_argument('--checkpoint_every', type=int, default=0)
  p.add_argument('--compilation_cache_dir', default=None,
                 help='Persistent XLA compilation cache directory, used '
                      'when JAX_COMPILATION_CACHE_DIR is unset (default: '
                      '<checkout>/.jax_cache)')
  p.add_argument('--chunks_per_dispatch', type=int, default=1,
                 help='Structurally-identical chunks evaluated per XLA '
                      'dispatch (amortizes dispatch latency)')
  p.add_argument('--load_retries', type=int, default=0,
                 help='Retries per chunk load on transient (I/O) failures, '
                      'with exponential backoff')
  p.add_argument('--load_retry_backoff', type=float, default=1.0,
                 help='First retry delay in seconds (doubles per attempt)')
  p.add_argument('--skip_failed_chunks', action='store_true',
                 help='Skip (and report in <output>.failures.json) chunks '
                      'whose transient failures survive all retries, '
                      'instead of failing the run')
  return p


def retry_policy_from_args(args) -> Optional[pipeline_lib.RetryPolicy]:
  if not args.load_retries and not args.skip_failed_chunks:
    return None
  return pipeline_lib.RetryPolicy(
      retries=args.load_retries, backoff_s=args.load_retry_backoff,
      skip_failed=args.skip_failed_chunks)


def main(argv: Optional[Sequence[str]] = None) -> None:
  args = build_parser().parse_args(argv)
  compile_cache.enable(args.compilation_cache_dir)

  init_times = np.arange(
      args.time_start, args.time_stop,
      np.timedelta64(args.time_frequency, 'h'), dtype='datetime64[ns]')
  lead_times = np.arange(
      args.lead_time_start, args.lead_time_stop, args.lead_time_frequency,
      dtype='timedelta64[h]').astype('timedelta64[ns]')
  times = time_chunks_lib.TimeChunks(
      init_times, lead_times,
      init_time_chunk_size=args.time_chunk_size,
      lead_time_chunk_size=args.lead_time_chunk_size)

  variables = [v for v in args.variables.split(',') if v]
  sel_kwargs = ({'level': [int(l) for l in args.levels.split(',')]}
                if args.levels else None)

  target_loader = loaders.TargetsFromDataset(
      path=args.target_path, variables=variables, sel_kwargs=sel_kwargs)
  prediction_loader = loaders.PredictionsFromDataset(
      path=args.prediction_path, variables=variables, sel_kwargs=sel_kwargs)

  all_metrics = {'rmse': deterministic.RMSE(), 'mse': deterministic.MSE()}
  regions = {
      'global': ((-90, 90), (0, 360)),
      'northern-hemisphere': ((20, 90), (0, 360)),
  }
  aggregation_method = aggregation.Aggregator(
      reduce_dims=[d for d in args.reduce_dims.split(',') if d],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions(regions)])

  values = pipeline_lib.evaluate(
      all_metrics, aggregation_method, prediction_loader, target_loader,
      times,
      out_path=args.output_path,
      aggregation_state_out_path=args.aggregation_state_output_path,
      checkpoint_path=args.checkpoint_path,
      checkpoint_every=args.checkpoint_every,
      chunks_per_dispatch=args.chunks_per_dispatch,
      retry=retry_policy_from_args(args))
  print(f'Wrote {len(values)} metric variables to {args.output_path}')
  for k, v in sorted(values.items()):
    print(f'  {k}: dims={v.dims} shape={v.shape}')


if __name__ == '__main__':
  main()
