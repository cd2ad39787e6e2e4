"""Chunked ensemble evaluation from a Zarr store, with unaggregated output.

The production shape (reference ``run_benchmark_evaluation.py:341-354`` +
``define_unaggregated_pipeline``): write a blosc-compressed Zarr forecast
store, stream it chunk-by-chunk through the pipeline computing CRPS +
spread/skill + ensemble-mean RMSE, and tee the raw per-point statistics
into a second Zarr store from the same pass.

Run: python examples/ensemble_zarr_pipeline.py [--cpu]  (writes under the temp dir)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

if '--cpu' in sys.argv:  # fast local run without an accelerator
  import jax
  jax.config.update('jax_platforms', 'cpu')

import tempfile

import numpy as np

from weatherbenchx_tpu import aggregation, weighting, zarr_io
from weatherbenchx_tpu import time_chunks as tc
from weatherbenchx_tpu.darray import DimArray
from weatherbenchx_tpu.data import loaders
from weatherbenchx_tpu.metrics import deterministic, probabilistic, wrappers
from weatherbenchx_tpu.parallel import pipeline as pipeline_lib
from weatherbenchx_tpu.parallel import unaggregated

tmp = tempfile.mkdtemp(prefix='wbx_example_')
rng = np.random.default_rng(0)
lats = np.linspace(-90, 90, 19)
lons = np.linspace(0, 360, 36, endpoint=False)
init = np.datetime64('2020-01-01', 'ns') + np.arange(8) * np.timedelta64(
    12, 'h')
lead = np.array([12, 24], 'timedelta64[h]').astype('timedelta64[ns]')
valid = np.datetime64('2020-01-01', 'ns') + np.arange(10) * np.timedelta64(
    12, 'h')

# Forecast: 8 members; targets: deterministic analysis at valid_time.
zarr_io.save_dataset_zarr(f'{tmp}/preds.zarr', {'t2m': DimArray(
    rng.standard_normal((8, 8, 2, 19, 36)).astype(np.float32),
    ('number', 'init_time', 'lead_time', 'latitude', 'longitude'),
    {'number': np.arange(8), 'init_time': init, 'lead_time': lead,
     'latitude': lats, 'longitude': lons})},
    chunks={'init_time': 2}, compressor='blosc')
zarr_io.save_dataset_zarr(f'{tmp}/era5.zarr', {'t2m': DimArray(
    rng.standard_normal((10, 19, 36)).astype(np.float32),
    ('valid_time', 'latitude', 'longitude'),
    {'valid_time': valid, 'latitude': lats, 'longitude': lons})},
    chunks={'valid_time': 4}, compressor='blosc')

metrics = {
    'crps': probabilistic.CRPSEnsemble(use_sort=True),
    'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
    'mean_rmse': wrappers.WrappedMetric(
        deterministic.RMSE(),
        [wrappers.EnsembleMean(which='predictions', ensemble_dim='number')]),
}
times = tc.TimeChunks(init, lead, init_time_chunk_size=2)
stats_store = unaggregated.ZarrStatsStore(times, f'{tmp}/stats.zarr',
                                          compressor='zstd')

pipe = pipeline_lib.EvaluationPipeline(
    metrics=metrics,
    aggregator=aggregation.Aggregator(
        reduce_dims=['init_time', 'latitude', 'longitude'],
        weigh_by=[weighting.GridAreaWeighting()]),
    predictions_loader=loaders.PredictionsFromDataset(
        path=f'{tmp}/preds.zarr', rename_dimensions=None),
    targets_loader=loaders.TargetsFromDataset(
        path=f'{tmp}/era5.zarr', rename_dimensions=None),
    times=times,
    chunk_stats_sink=stats_store.write_chunk)

values = pipe.run().metric_values(metrics)
stats_store.finalize()

for name, da in values.items():
  print(f'{name}: dims={da.dims} values={np.asarray(da.values).round(3)}')
raw = unaggregated.load_unaggregated(f'{tmp}/stats.zarr')
print('unaggregated statistics:', {k: v.shape for k, v in raw.items()})
