"""Quickstart: score one forecast chunk in memory.

The single-chunk path (the reference quickstart's
``aggregation.compute_metric_values_for_single_chunk``,
``aggregation.py:404``): build named-axis arrays, pick metrics, aggregate
with area weighting and region bins, read off metric values.

Run: python examples/quickstart.py [--cpu]  (CPU or GPU; no data files needed)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

if '--cpu' in sys.argv:  # fast local run without an accelerator
  import jax
  jax.config.update('jax_platforms', 'cpu')

import numpy as np

from weatherbenchx_tpu import aggregation, binning, weighting
from weatherbenchx_tpu.darray import DimArray
from weatherbenchx_tpu.metrics import deterministic

rng = np.random.default_rng(0)
lats = np.linspace(-90, 90, 19)
lons = np.linspace(0, 360, 36, endpoint=False)
lead = np.array([6, 12, 24], 'timedelta64[h]').astype('timedelta64[ns]')
dims = ('lead_time', 'latitude', 'longitude')
coords = {'lead_time': lead, 'latitude': lats, 'longitude': lons}

predictions = {'2m_temperature': DimArray(
    280 + rng.standard_normal((3, 19, 36)).astype(np.float32), dims, coords)}
targets = {'2m_temperature': DimArray(
    280 + rng.standard_normal((3, 19, 36)).astype(np.float32), dims, coords)}

metrics = {
    'rmse': deterministic.RMSE(),
    'bias': deterministic.Bias(),
    'mae': deterministic.MAE(),
}
aggregator = aggregation.Aggregator(
    reduce_dims=['latitude', 'longitude'],
    weigh_by=[weighting.GridAreaWeighting()],
    bin_by=[binning.Regions({'global': ((-90, 90), (0, 360)),
                             'tropics': ((-20, 20), (0, 360))})])

values = aggregation.compute_metric_values_for_single_chunk(
    metrics, aggregator, predictions, targets)

for name, da in values.items():
  print(f'{name}: dims={da.dims}')
  print(np.asarray(da.values).round(3))
