"""Tests for ``Aggregator.aggregate_statistics``.

One chunk's (statistic, variable) arrays are contracted against shared
weight and bin-mask operands (reference semantics: separate ``xr.dot``
calls, ``weatherbenchX/aggregation.py:290-328``). The batched call must
equal aggregating each statistic on its own, and the finalized metrics
must equal a float64 numpy weighted mean.
"""

import numpy as np
import pytest

from weatherbenchx_tpu import aggregation, binning, weighting
from weatherbenchx_tpu.darray import DimArray


def _rel(a, b):
  a = np.asarray(a, np.float64)
  b = np.asarray(b, np.float64)
  return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-9)))


def _mk(seed, shape, dims, **coords):
  rng = np.random.default_rng(seed)
  return DimArray(rng.standard_normal(shape).astype(np.float32), dims,
                  coords or None)


class TestAggregateStatistics:

  def _setup(self, masked=False, skipna=False):
    nlat, nlon = 13, 24
    lats = np.linspace(-90, 90, nlat)
    lons = np.linspace(0, 360, nlon, endpoint=False)
    coords = {'latitude': lats, 'longitude': lons}
    rng = np.random.default_rng(0)

    def da(seed, with_nan=False, extra_level=False):
      r = np.random.default_rng(seed)
      shape = (2, nlat, nlon) if not extra_level else (2, 3, nlat, nlon)
      dims = (('lead_time', 'latitude', 'longitude') if not extra_level
              else ('lead_time', 'level', 'latitude', 'longitude'))
      v = r.standard_normal(shape).astype(np.float32)
      if with_nan:
        v[(0,) * (v.ndim - 2) + (1, 2)] = np.nan
      c = dict(coords)
      if masked:
        c['mask'] = (dims[-2:], r.random(shape[-2:]) > 0.2)
      return DimArray(v, dims, c)

    land = DimArray(rng.random((nlat, nlon)) > 0.5,
                    ('latitude', 'longitude'), coords)
    regions = {'global': ((-90.0, 90.0), (0.0, 360.0)),
               'tropics': ((-20.0, 20.0), (0.0, 360.0))}
    agg = aggregation.Aggregator(
        reduce_dims=['latitude', 'longitude'],
        bin_by=[binning.Regions(regions, land_sea_mask=land)],
        weigh_by=[weighting.GridAreaWeighting()],
        masked=masked, skipna=skipna)
    stats = {
        'se': {'a': da(1), 'b': da(2, with_nan=skipna)},
        'err': {'a': da(3), 'b': da(4)},
        # a different layout in the same family: groups must not mix
        'lvl': {'a': da(5, extra_level=True)},
    }
    return agg, stats

  @pytest.mark.parametrize('masked,skipna',
                           [(False, False), (True, False),
                            (True, True), (False, True)])
  def test_matches_per_statistic_aggregation(self, masked, skipna):
    agg, stats = self._setup(masked=masked, skipna=skipna)
    got = agg.aggregate_statistics(stats)
    for name, per_var in stats.items():
      for var, stat in per_var.items():
        ref = agg.aggregate_stat_var(stat)
        for side in ('sum_weighted_statistics', 'sum_weights'):
          ra = getattr(ref, side)
          ga = getattr(got, side)[name][var]
          assert ra.dims == ga.dims
          rv, gv = np.asarray(ra.data), np.asarray(ga.data)
          ok = ~np.isnan(rv)
          assert np.array_equal(ok, ~np.isnan(gv))
          np.testing.assert_allclose(gv[ok], rv[ok], rtol=1e-6, atol=1e-7)

  def test_metric_values_match_float64(self):
    from weatherbenchx_tpu.metrics import deterministic
    nlat, nlon = 13, 24
    lats = np.linspace(-90, 90, nlat)
    coords = {'latitude': lats,
              'longitude': np.linspace(0, 360, nlon, endpoint=False)}
    dims = ('lead_time', 'latitude', 'longitude')
    rng = np.random.default_rng(7)
    p64 = rng.standard_normal((2, nlat, nlon))
    t64 = rng.standard_normal((2, nlat, nlon))
    p = {'a': DimArray(p64.astype(np.float32), dims, coords)}
    t = {'a': DimArray(t64.astype(np.float32), dims, coords)}
    agg = aggregation.Aggregator(reduce_dims=['latitude', 'longitude'],
                                 weigh_by=[weighting.GridAreaWeighting()])
    metrics = {'rmse': deterministic.RMSE(), 'bias': deterministic.Bias()}
    got = aggregation.compute_metric_values_for_single_chunk(
        metrics, agg, p, t)
    w = np.asarray(weighting.GridAreaWeighting().weights(p['a']).data,
                   np.float64)
    w = np.broadcast_to(w.reshape(-1, 1) if w.ndim == 1 else w,
                        (nlat, nlon))
    err = p['a'].data.astype(np.float64) - t['a'].data.astype(np.float64)
    mean = lambda s: (s * w).sum((1, 2)) / w.sum()
    np.testing.assert_allclose(np.asarray(got['rmse.a'].data),
                               np.sqrt(mean(err ** 2)), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got['bias.a'].data), mean(err),
                               rtol=1e-5, atol=1e-7)

  def test_operands_stay_bool(self):
    # prepare_operands must keep bin masks bool (a 4x smaller device
    # copy than float32).
    import jax
    agg, stats = self._setup()
    abstract = {
        name: {var: DimArray(
            jax.ShapeDtypeStruct(s.shape, s.dtype), s.dims, s.coords)
            for var, s in per.items()}
        for name, per in stats.items()}
    ops = agg.prepare_operands(abstract)
    kinds = {np.dtype(o.dtype).kind for o in ops['se']['a']}
    assert 'b' in kinds, kinds  # the Regions mask
    assert 'f' in kinds, kinds  # the area weights
