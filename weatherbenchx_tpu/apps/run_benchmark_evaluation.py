"""WeatherBench benchmark evaluation CLI.

JAX equivalent of ``public_benchmark/run_benchmark_evaluation.py:66-409``:
config-registry lookup, deterministic vs probabilistic metric sets (SEEPS
with climatology, ACC/activity, sort-form CRPS, spread/skill), 17
ECMWF-style regions with land bins, area weighting, masked aggregation,
and a --temporal mode preserving init_time.

Example:
  python -m weatherbenchx_tpu.apps.run_benchmark_evaluation \
      --prediction=hres --target=era5 --resolution=64x32 --year=2020 \
      --variables=geopotential,2m_temperature --output_dir=./results
"""

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from weatherbenchx_tpu import aggregation, binning, compile_cache, weighting
from weatherbenchx_tpu import io as io_lib
from weatherbenchx_tpu import time_chunks as time_chunks_lib
from weatherbenchx_tpu.apps import configs as configs_lib
from weatherbenchx_tpu.apps import run_evaluation
from weatherbenchx_tpu.darray import DimArray
from weatherbenchx_tpu.data import loaders
from weatherbenchx_tpu.metrics import categorical, deterministic
from weatherbenchx_tpu.metrics import probabilistic, wrappers
from weatherbenchx_tpu.parallel import pipeline as pipeline_lib


def build_parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--prediction', required=True,
                 help='Model key in the config registry (e.g. hres, ens)')
  p.add_argument('--target', default='era5')
  p.add_argument('--resolution', default='64x32',
                 choices=list(configs_lib.RESOLUTIONS))
  p.add_argument('--year', type=int, default=2020)
  p.add_argument('--variables', default=None,
                 help='Comma-delimited variables (default: the registry '
                      "entry's standard variable list)")
  p.add_argument('--levels', default=None,
                 help='Comma-delimited pressure levels '
                      f'(default {configs_lib.DEFAULT_LEVELS})')
  p.add_argument('--time_frequency', type=int, default=None,
                 help='Init frequency in hours (default 12; 24 for excarta '
                      'per the reference quirks)')
  p.add_argument('--init_time_start', default=None,
                 help='Override init start (default: Jan 1 of --year)')
  p.add_argument('--init_time_stop', default=None,
                 help='Override init stop, exclusive (default: Jan 1 of '
                      'the following year)')
  p.add_argument('--lead_time_stop_days', type=int, default=10)
  p.add_argument('--lead_time_frequency', type=int, default=6)
  p.add_argument('--init_time_chunk_size', type=int, default=1)
  p.add_argument('--lead_time_chunk_size', type=int, default=12)
  p.add_argument('--temporal', action='store_true',
                 help='Do not reduce over init_time (per-init outputs)')
  p.add_argument('--output_dir', required=True)
  p.add_argument('--output_format', default='npz',
                 choices=['npz', 'zarr', 'wbx', 'nc'],
                 help='Metrics container: npz (portable single file), '
                      'zarr (standard store, xarray-openable), wbx '
                      '(native block container), or nc (netCDF3 classic, '
                      'the reference output format)')
  p.add_argument('--prediction_path', default=None,
                 help='Override the registry path (e.g. a local .npz)')
  p.add_argument('--target_path', default=None)
  p.add_argument('--climatology_path', default=None)
  p.add_argument('--checkpoint_every', type=int, default=0)
  p.add_argument('--compilation_cache_dir', default=None,
                 help='Persistent XLA compilation cache directory, used '
                      'when JAX_COMPILATION_CACHE_DIR is unset (default: '
                      '<checkout>/.jax_cache)')
  p.add_argument('--chunks_per_dispatch', type=int, default=1,
                 help='Structurally-identical chunks evaluated per XLA '
                      'dispatch (amortizes dispatch latency)')
  p.add_argument('--load_retries', type=int, default=0,
                 help='Retries per chunk load on transient (I/O) failures')
  p.add_argument('--load_retry_backoff', type=float, default=1.0)
  p.add_argument('--skip_failed_chunks', action='store_true',
                 help='Skip (and report) chunks whose transient failures '
                      'survive all retries, instead of failing the run')
  p.add_argument('--zarr_format', type=int, default=2, choices=(2, 3),
                 help='Zarr store format for --unaggregated_zarr output')
  p.add_argument('--zarr_compressor', default=None,
                 choices=['zlib', 'zstd', 'blosc'],
                 help='Compression for --unaggregated_zarr cells')
  p.add_argument('--zarr_shards', default=None,
                 help='v3 sharding_indexed shard sizes per dim for '
                      '--unaggregated_zarr output, e.g. '
                      '"init_time=64,lead_time=16" (elements; rounded up '
                      'to a chunk multiple). Requires --zarr_format=3')
  p.add_argument('--unaggregated_zarr', action='store_true',
                 help='Also stream raw per-point statistics into a '
                      '<output>_stats.zarr store (reference unaggregated '
                      'mode)')
  return p


def _open_dataset(path: str) -> dict[str, DimArray]:
  """Lazy open by extension/protocol (one dispatch, io.open_dataset_auto:
  self-contained npz/wbx/zarr incl. remote URLs; xarray for netCDF)."""
  return io_lib.open_dataset_auto(path)


def main(argv: Optional[Sequence[str]] = None) -> None:
  args = build_parser().parse_args(argv)
  compile_cache.enable(args.compilation_cache_dir)

  # 1. Config lookup (registry or explicit path overrides).
  # Special prediction kinds resolve against the era5 target/climatology
  # entries with dedicated loaders (reference
  # ``run_benchmark_evaluation.py:151-201``).
  pred_key = f'{args.prediction}_{args.resolution}_{args.year}'
  is_probabilistic = pred_key in configs_lib.probabilistic_prediction_configs
  if args.prediction in ('persistence', 'probabilistic_climatology',
                         'climatology'):
    if args.prediction == 'climatology':
      clim_key0 = f'era5_{args.resolution}_{args.year}'
      if clim_key0 not in configs_lib.climatology_configs:
        clim_key0 = f'era5_{args.resolution}'
      registry_cfg = configs_lib.climatology_configs[clim_key0]
    else:
      registry_cfg = configs_lib.target_configs[f'era5_{args.resolution}']
    pred_cfg = (dict(registry_cfg, path=args.prediction_path)
                if args.prediction_path else registry_cfg)
    is_probabilistic = args.prediction == 'probabilistic_climatology'
  elif args.prediction_path:
    # Override ONLY the path: the registry entry's per-model quirks
    # (keisler's add_nan_mask + skipna, level defaults, renames) must
    # survive a local-file override, same as the special-kind branch.
    if is_probabilistic:
      registry_cfg = configs_lib.probabilistic_prediction_configs[pred_key]
    else:
      registry_cfg = configs_lib.deterministic_prediction_configs.get(
          pred_key, {'data_loader_kwargs': {}})
    pred_cfg = dict(registry_cfg, path=args.prediction_path)
  elif is_probabilistic:
    pred_cfg = configs_lib.probabilistic_prediction_configs[pred_key]
  elif pred_key in configs_lib.deterministic_prediction_configs:
    pred_cfg = configs_lib.deterministic_prediction_configs[pred_key]
  else:
    known = sorted(set(configs_lib.deterministic_prediction_configs)
                   | set(configs_lib.probabilistic_prediction_configs))
    same_model = [k for k in known if k.startswith(args.prediction + '_')]
    raise SystemExit(
        f"Unknown prediction config '{pred_key}'. "
        + (f'Configs for this model: {same_model}. ' if same_model
           else f'Known models: {sorted({k.rsplit("_", 2)[0] for k in known})}. ')
        + 'Use --prediction_path to point at a local file instead.')
  tgt_cfg = ({'path': args.target_path} if args.target_path
             else configs_lib.target_configs[
                 f'{args.target}_{args.resolution}'])
  clim_key = f'era5_{args.resolution}_{args.year}'
  if clim_key not in configs_lib.climatology_configs:
    clim_key = f'era5_{args.resolution}'
  clim_cfg = ({'path': args.climatology_path} if args.climatology_path
              else configs_lib.climatology_configs[clim_key])

  if args.variables:
    variables = [v for v in args.variables.split(',') if v]
  elif pred_cfg.get('variables'):
    variables = list(pred_cfg['variables'])
  else:
    raise SystemExit('--variables is required when the prediction config '
                     'declares no default variable list.')
  if args.levels:
    levels = [int(l) for l in args.levels.split(',')]
  else:
    levels = list(pred_cfg.get('levels', configs_lib.DEFAULT_LEVELS))
  precip_variables = [
      v for v in variables if v in configs_lib.SEEPS_DRY_THRESHOLDS_MM]

  # 2. Times. Default init range carries the reference's per-model data
  # quirks (``run_benchmark_evaluation.py:219-248``): 2022 targets and
  # fuxi/excarta predictions end mid-December; aurora is missing the first
  # init; baguan the last day; excarta is daily.
  init_start = args.init_time_start
  init_stop = args.init_time_stop
  if init_start is None and init_stop is None:
    init_start = f'{args.year}-01-01'
    if args.year == 2022 or args.prediction in ('fuxi', 'excarta'):
      init_stop = f'{args.year}-12-16'
      if args.prediction == 'aurora':
        init_start = f'{args.year}-01-01T12'
    elif args.year == 2020 and args.prediction == 'baguan':
      init_stop = f'{args.year}-12-30T12'
    else:
      init_stop = f'{args.year + 1}-01-01'
  time_frequency = args.time_frequency
  if time_frequency is None:
    time_frequency = 24 if args.prediction == 'excarta' else 12
  init_times = np.arange(
      init_start or f'{args.year}-01-01',
      init_stop or f'{args.year + 1}-01-01',
      np.timedelta64(time_frequency, 'h'), dtype='datetime64[ns]')
  lead_times = np.arange(
      0, 24 * args.lead_time_stop_days, args.lead_time_frequency,
      dtype='timedelta64[h]').astype('timedelta64[ns]')
  times = time_chunks_lib.TimeChunks(
      init_times, lead_times,
      init_time_chunk_size=args.init_time_chunk_size,
      lead_time_chunk_size=args.lead_time_chunk_size)

  # 3. Loaders.
  sel_kwargs = {'level': levels} if levels else None
  loader_kwargs = dict(pred_cfg.get('data_loader_kwargs', {}))
  if sel_kwargs:
    loader_kwargs.setdefault('sel_kwargs', sel_kwargs)
  if args.prediction == 'persistence':
    prediction_cls = loaders.PersistenceFromDataset
  elif args.prediction == 'climatology':
    prediction_cls = loaders.ClimatologyFromDataset
  elif args.prediction == 'probabilistic_climatology':
    prediction_cls = loaders.ProbabilisticClimatologyFromDataset
    # The website's fixed climatological-ensemble period (reference
    # ``run_benchmark_evaluation.py:192-200``).
    loader_kwargs.setdefault('start_year', 1990)
    loader_kwargs.setdefault('end_year', 2019)
  else:
    prediction_cls = loaders.PredictionsFromDataset
  prediction_loader = prediction_cls(
      path=pred_cfg['path'], variables=variables, **loader_kwargs)

  # Targets always sort latitude ascending (the era5 registry entry
  # already carries the same preprocessing_fn — setdefault, not a second
  # explicit kwarg, so the two never collide).
  tgt_kwargs = dict(tgt_cfg.get('data_loader_kwargs', {}))
  tgt_kwargs.setdefault('preprocessing_fn', configs_lib.sort_latitude)
  target_loader = loaders.TargetsFromDataset(
      path=tgt_cfg['path'], variables=variables, sel_kwargs=sel_kwargs,
      **tgt_kwargs)

  # 4. Metrics. The probabilistic set needs no climatology — don't open
  # (or require) one for it. SEEPS/ACC require ascending latitudes on the
  # climatology.
  if not is_probabilistic:
    climatology = configs_lib.sort_latitude(_open_dataset(clim_cfg['path']))
    if levels:
      # Subset the EVALUATED variables to the evaluated levels: anomaly
      # statistics broadcast against the climatology, so an unsubset
      # level axis would silently widen ACC/activity outputs to the
      # climatology's full level set. Unevaluated climatology variables
      # are left alone — their level axes may legitimately differ.
      climatology = {
          k: (v.sel(level=levels) if k in variables and 'level' in v.dims
              else v)
          for k, v in climatology.items()}
  if is_probabilistic:
    all_metrics = {
        'crps': probabilistic.CRPSEnsemble(use_sort=True),
        'unbiased_spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
        'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
        'mean_rmse': wrappers.WrappedMetric(
            deterministic.RMSE(),
            [wrappers.EnsembleMean(which='predictions')]),
    }
  else:
    all_metrics = {
        'rmse': deterministic.RMSE(),
        'mse': deterministic.MSE(),
        'bias': deterministic.Bias(),
        'acc': deterministic.ACC(climatology=climatology),
        'prediction_activity': deterministic.PredictionActivity(
            climatology=climatology),
    }
    u_names, v_names, vector_names = [], [], []
    if {'u_component_of_wind', 'v_component_of_wind'} <= set(variables):
      u_names.append('u_component_of_wind')
      v_names.append('v_component_of_wind')
      vector_names.append('wind')
    if {'10m_u_component_of_wind',
        '10m_v_component_of_wind'} <= set(variables):
      u_names.append('10m_u_component_of_wind')
      v_names.append('10m_v_component_of_wind')
      vector_names.append('10m_wind')
    if u_names:
      all_metrics['vector_rmse'] = deterministic.WindVectorRMSE(
          u_names, v_names, vector_names)
    if precip_variables:
      all_metrics['seeps'] = categorical.SEEPS(
          variables=precip_variables, climatology=climatology,
          dry_threshold_mm=[configs_lib.SEEPS_DRY_THRESHOLDS_MM[v]
                            for v in precip_variables])

  # 5. Aggregation: land-sea-augmented regions, area weights, masked.
  target_ds = _open_dataset(tgt_cfg['path'])
  land_sea_mask = target_ds.get('land_sea_mask')
  bin_by = [binning.Regions(configs_lib.REGIONS,
                            land_sea_mask=land_sea_mask)]
  reduce_dims = (['latitude', 'longitude'] if args.temporal
                 else ['init_time', 'latitude', 'longitude'])
  aggregator_kwargs = dict(pred_cfg.get('aggregator_kwargs', {}))
  aggregation_method = aggregation.Aggregator(
      reduce_dims=reduce_dims,
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=bin_by,
      masked=True,  # required for SEEPS (p1 masking)
      **aggregator_kwargs)

  # 6. Run and write.
  init_time_str = f'{args.year}-init{time_frequency}h'
  filename = (f'{args.prediction}_vs_{args.target}_{args.resolution}_'
              f'{init_time_str}')
  if args.temporal:
    filename += '_temporal'
  out_path = os.path.join(args.output_dir,
                          f'{filename}.{args.output_format}')
  os.makedirs(args.output_dir, exist_ok=True)
  print(f'Save path: {out_path}')

  stats_store = None
  if args.unaggregated_zarr:
    # Raw per-point statistics streamed into a standard Zarr store from
    # the SAME pass as the aggregated evaluation (reference computes both
    # in one Beam graph, ``beam_pipeline.py:449-540,610-681``) — the
    # dataset is read and transferred once.
    from weatherbenchx_tpu.parallel import unaggregated
    zarr_shards = None
    if args.zarr_shards:
      zarr_shards = {k: int(v) for k, v in
                     (kv.split('=', 1)
                      for kv in args.zarr_shards.split(','))}
    stats_store = unaggregated.ZarrStatsStore(
        times, os.path.join(args.output_dir, filename + '_stats.zarr'),
        compressor=args.zarr_compressor, zarr_format=args.zarr_format,
        zarr_shards=zarr_shards)

  values = pipeline_lib.evaluate(
      all_metrics, aggregation_method, prediction_loader, target_loader,
      times, out_path=out_path,
      checkpoint_path=(out_path + '.ckpt' if args.checkpoint_every else None),
      checkpoint_every=args.checkpoint_every,
      chunks_per_dispatch=args.chunks_per_dispatch,
      chunk_stats_sink=stats_store.write_chunk if stats_store else None,
      retry=run_evaluation.retry_policy_from_args(args))
  if stats_store is not None:
    print(f'Wrote unaggregated statistics store: {stats_store.finalize()}')
  print(f'Wrote {len(values)} metric variables.')


if __name__ == '__main__':
  main()
