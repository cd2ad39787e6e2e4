"""Probabilistic metric numerics, mirroring reference metrics_test patterns."""

import functools
import itertools

import numpy as np
import pytest
import scipy.stats

from weatherbenchx_tpu import aggregation, test_utils
from weatherbenchx_tpu.darray import Coord, DimArray
from weatherbenchx_tpu.metrics import base as mbase
from weatherbenchx_tpu.metrics import probabilistic, wrappers
from weatherbenchx_tpu.ops import ensemble_stats


def compute_all(metrics, preds, tgts, reduce_dims):
  agg = aggregation.Aggregator(reduce_dims=reduce_dims)
  return aggregation.compute_metric_values_for_single_chunk(
      metrics, agg, preds, tgts)


def ens_pair(ens=5, seed=0, tgt_ens=None):
  preds, _ = test_utils.canonical_forecast_pair(
      n_init=2, n_lead=2, ensemble_size=ens, seed=seed)
  tgts, _ = test_utils.canonical_forecast_pair(
      n_init=2, n_lead=2, ensemble_size=tgt_ens, seed=seed + 100)
  return preds, tgts


def crps_spread_brute(p, fair, axis=0):
  m = p.shape[axis]
  pairwise = np.abs(
      np.expand_dims(p, axis) - np.expand_dims(p, axis + 1))
  return pairwise.sum((axis, axis + 1)) / (m * (m - int(fair)))


class TestCRPS:
  @pytest.mark.parametrize('ens,use_sort,fair', list(
      itertools.product([4, 5], [False, True], [True, False])))
  def test_crps_vs_brute_force(self, ens, use_sort, fair):
    preds, tgts = ens_pair(ens=ens)
    metrics = {'crps': probabilistic.CRPSEnsemble(
        use_sort=use_sort, fair=fair)}
    results = compute_all(
        metrics, preds, tgts,
        ['init_time', 'lead_time', 'latitude', 'longitude'])
    p = preds['2m_temperature'].values  # (number, init, lead, lat, lon)
    t = tgts['2m_temperature'].values
    skill = np.abs(p - t[None]).mean()
    spread = crps_spread_brute(p, fair).mean()
    np.testing.assert_allclose(
        results['crps.2m_temperature'].item(), skill - 0.5 * spread,
        rtol=1e-5)

  def test_sort_equals_pairwise(self):
    preds, tgts = ens_pair(ens=7)
    for fair in [True, False]:
      r1 = compute_all({'c': probabilistic.CRPSEnsemble(
          use_sort=True, fair=fair)}, preds, tgts, ['latitude', 'longitude'])
      r2 = compute_all({'c': probabilistic.CRPSEnsemble(
          use_sort=False, fair=fair)}, preds, tgts, ['latitude', 'longitude'])
      np.testing.assert_allclose(
          np.asarray(r1['c.2m_temperature'].values),
          np.asarray(r2['c.2m_temperature'].values), atol=1e-4)

  @pytest.mark.parametrize('use_sort', [False, True])
  def test_crps_ensemble_distance(self, use_sort):
    preds, tgts = ens_pair(ens=4, tgt_ens=3)
    metrics = {'cd': probabilistic.CRPSEnsembleDistance(use_sort=use_sort)}
    results = compute_all(
        metrics, preds, tgts,
        ['init_time', 'lead_time', 'latitude', 'longitude'])
    p = preds['2m_temperature'].values
    t = tgts['2m_temperature'].values
    skill = np.abs(p[:, None] - t[None, :]).mean()
    spread_p = crps_spread_brute(p, fair=True).mean()
    spread_t = crps_spread_brute(t, fair=True).mean()
    np.testing.assert_allclose(
        results['cd.2m_temperature'].item(),
        skill - 0.5 * spread_p - 0.5 * spread_t, rtol=1e-4)

  def test_crps_skipna_pairwise(self):
    preds, tgts = ens_pair(ens=4)
    pv = np.asarray(preds['2m_temperature'].values).copy()
    pv[0, 0, 0, 0, 0] = np.nan
    preds = {'2m_temperature': preds['2m_temperature'].copy(data=pv)}
    r = compute_all({'c': probabilistic.CRPSEnsemble(
        skipna_ensemble=True)}, preds, tgts,
        ['init_time', 'lead_time', 'latitude', 'longitude'])
    assert np.isfinite(r['c.2m_temperature'].item())
    r2 = compute_all({'c': probabilistic.CRPSEnsemble()}, preds, tgts,
                     ['init_time', 'lead_time', 'latitude', 'longitude'])
    assert np.isnan(r2['c.2m_temperature'].item())


class TestUnbiasedEstimators:
  def test_unbiased_mse_formula(self):
    preds, tgts = ens_pair(ens=6)
    r = compute_all(
        {'m': probabilistic.UnbiasedEnsembleMeanRMSE()}, preds, tgts,
        ['init_time', 'lead_time', 'latitude', 'longitude'])
    p = preds['2m_temperature'].values
    t = tgts['2m_temperature'].values
    mse = (p.mean(0) - t) ** 2 - p.var(0, ddof=1) / p.shape[0]
    np.testing.assert_allclose(
        r['m.2m_temperature'].item(), np.sqrt(mse.mean()), rtol=1e-5)

  def test_spread_skill_and_root_mean_variance(self):
    preds, tgts = ens_pair(ens=6)
    r = compute_all(
        {'ssr': probabilistic.UnbiasedSpreadSkillRatio(),
         'rmv': probabilistic.EnsembleRootMeanVariance()},
        preds, tgts, ['init_time', 'lead_time', 'latitude', 'longitude'])
    p = preds['2m_temperature'].values
    t = tgts['2m_temperature'].values
    var = p.var(0, ddof=1).mean()
    mse = ((p.mean(0) - t) ** 2 - p.var(0, ddof=1) / p.shape[0]).mean()
    np.testing.assert_allclose(r['ssr.2m_temperature'].item(),
                               np.sqrt(var / mse), rtol=1e-5)
    np.testing.assert_allclose(r['rmv.2m_temperature'].item(),
                               np.sqrt(var), rtol=1e-5)

  def test_ensemble_target_unbiased_mse(self):
    preds, tgts = ens_pair(ens=5, tgt_ens=4)
    # Use the statistic directly as a Metric (identity finalizer) so the
    # comparison is on the (possibly negative) debiased MSE itself.
    r = compute_all(
        {'m': probabilistic.UnbiasedEnsembleMeanSquaredError()}, preds, tgts,
        ['init_time', 'lead_time', 'latitude', 'longitude'])
    p = preds['2m_temperature'].values
    t = tgts['2m_temperature'].values
    mse = ((p.mean(0) - t.mean(0)) ** 2
           - p.var(0, ddof=1) / p.shape[0]
           - t.var(0, ddof=1) / t.shape[0])
    np.testing.assert_allclose(
        r['m.2m_temperature'].item(), mse.mean(), rtol=1e-4)


class TestRankHistogram:
  def test_counts(self):
    p = DimArray(np.array([[1.0, 5.0], [2.0, 6.0], [3.0, 7.0]]),
                 ('number', 'x'))
    # Targets 2.5 -> rank 2 (greater than 1,2); 4 -> rank 0.
    t = DimArray(np.array([2.5, 4.0]), ('x',))
    out = probabilistic.RankHistogram().compute(
        {'v': p}, {'v': t})['v']
    assert out.sizes['rank'] == 4
    got = out.transpose('x', 'rank').values
    np.testing.assert_array_equal(got, [[0, 0, 1, 0], [1, 0, 0, 0]])

  def test_uniform_for_calibrated(self):
    rng = np.random.default_rng(0)
    p = DimArray(rng.standard_normal((9, 4000)).astype(np.float64),
                 ('number', 'x'))
    t = DimArray(rng.standard_normal(4000), ('x',))
    out = probabilistic.RankHistogram().compute({'v': p}, {'v': t})['v']
    freqs = np.asarray(out.mean('x').values)
    np.testing.assert_allclose(freqs, 0.1, atol=0.02)


class TestWasserstein:
  def test_matches_scipy(self):
    rng = np.random.default_rng(1)
    u = rng.standard_normal((3, 4, 8))
    v = rng.standard_normal((3, 4, 6)) + 0.3
    preds = {'v': DimArray(u, ('a', 'b', 'number'))}
    tgts = {'v': DimArray(v, ('a', 'b', 'number'))}
    out = probabilistic.WassersteinDistance().compute(preds, tgts)['v']
    expected = np.zeros((3, 4))
    for i in range(3):
      for j in range(4):
        expected[i, j] = scipy.stats.wasserstein_distance(u[i, j], v[i, j])
    np.testing.assert_allclose(np.asarray(out.values), expected, rtol=1e-5)

  def test_missing_ensemble_raises(self):
    preds = {'v': DimArray(np.zeros((2, 3)), ('a', 'number'))}
    tgts = {'v': DimArray(np.zeros(2), ('a',))}
    with pytest.raises(ValueError, match='targets'):
      probabilistic.WassersteinDistance().compute(preds, tgts)


class TestREV:
  def _binary_data(self, seed=0, n=2000):
    rng = np.random.default_rng(seed)
    prob = rng.random(n)
    target = (rng.random(n) < prob).astype(np.float64)
    ens = (rng.random((10, n)) < prob[None]).astype(np.float64)
    preds = {'v': DimArray(ens.mean(0), ('x',))}
    tgts = {'v': DimArray(target, ('x',))}
    return preds, tgts

  def test_rev_shape_and_bounds(self):
    preds, tgts = self._binary_data()
    rev = probabilistic.RelativeEconomicValue(ensemble_size=10)
    results = compute_all({'rev': rev}, preds, tgts, ['x'])
    out = results['rev.v']
    assert set(out.dims) == {'threshold', 'cost_loss_ratio'}
    assert out.sizes['threshold'] == 12  # 10 + endpoints 0, 1
    assert out.sizes['cost_loss_ratio'] == 50
    vals = np.asarray(out.values)
    # Max over thresholds should be positive for a skillful forecast.
    assert np.nanmax(vals) > 0.3
    assert np.nanmax(vals) <= 1.0 + 1e-6

  def test_rev_optimal_thresholds_equals_select(self):
    preds, tgts = self._binary_data(seed=1)
    rev_full = probabilistic.RelativeEconomicValue(ensemble_size=10)
    full = compute_all({'rev': rev_full}, preds, tgts, ['x'])['rev.v']
    # Pick optimal threshold per cost/loss ratio from the full matrix.
    full_t = full.transpose('threshold', 'cost_loss_ratio')
    idx = np.nanargmax(np.asarray(full_t.values), axis=0)
    thresholds = full_t.coord_values('threshold')[idx]
    clr = full.coord_values('cost_loss_ratio')
    opt = DimArray(thresholds, ('cost_loss_ratio',),
                   {'cost_loss_ratio': clr})
    rev_opt = probabilistic.RelativeEconomicValue(
        ensemble_size=10, cost_loss_ratios=clr, optimal_thresholds=opt)
    picked = compute_all({'rev': rev_opt}, preds, tgts, ['x'])['rev.v']
    assert 'threshold' not in picked.dims
    expected = np.nanmax(np.asarray(full_t.values), axis=0)
    np.testing.assert_allclose(np.asarray(picked.values), expected,
                               rtol=1e-5)


class TestEnsembleRPS:
  @pytest.mark.parametrize('fair', [True, False])
  def test_rps_handwritten(self, fair):
    # 2 members, 1 point; thresholds [0, 1]. Exercise the CDF MSE math.
    p = DimArray(np.array([[-0.5], [0.5]]), ('number', 'x'))
    t = DimArray(np.array([0.7]), ('x',))
    stat = probabilistic.EnsembleRankedProbabilityScore(
        prediction_bin_thresholds=[0.0, 1.0],
        target_bin_thresholds=[0.0, 1.0],
        bin_dim='b', unique_name_suffix='test', fair=fair)
    out = stat.compute({'v': p}, {'v': t})['v']
    # pred CDF at [0,1] = [0.5, 1]; target CDF = [0, 1].
    if fair:
      # unbiased (mean diff)^2 - var/m per bin:
      # bin0: 0.25 - (ddof=1 var of {0,1} = 0.5)/2 = 0.0
      expected = 0.0 + 0.0
    else:
      expected = 0.25 + 0.0
    np.testing.assert_allclose(np.asarray(out.values), [expected], rtol=1e-6)


class TestEnsembleAveraged:
  def test_ensemble_averaged_metric(self):
    preds, tgts = ens_pair(ens=4)
    from weatherbenchx_tpu.metrics import deterministic
    m = probabilistic.EnsembleAveragedMetric(deterministic.RMSE())
    r = compute_all({'m': m}, preds, tgts,
                    ['init_time', 'lead_time', 'latitude', 'longitude'])
    p = preds['2m_temperature'].values
    t = tgts['2m_temperature'].values
    np.testing.assert_allclose(
        r['m.2m_temperature'].item(),
        np.sqrt(((p - t[None]) ** 2).mean()), rtol=1e-5)

  def test_missing_ensemble_dim_raises(self):
    preds, tgts = test_utils.canonical_forecast_pair(seed=0)
    from weatherbenchx_tpu.metrics import deterministic
    m = probabilistic.EnsembleAveragedMetric(deterministic.RMSE())
    with pytest.raises(ValueError, match='Failed to compute statistic'):
      compute_all({'m': m}, preds, tgts, ['latitude', 'longitude'])


class TestRaggedEnsembles:
  """Different prediction/target ensemble sizes (reference
  ``metrics_test.py:644-682``, ``probabilistic.py:116-145``)."""

  def _pair(self):
    rng = np.random.default_rng(0)
    p = DimArray(rng.standard_normal((5, 4)).astype(np.float32),
                 ('number', 'x'),
                 {'number': np.arange(5), 'x': np.arange(4)})
    t = DimArray(rng.standard_normal((3, 4)).astype(np.float32),
                 ('number', 'x'),
                 {'number': np.arange(3), 'x': np.arange(4)})
    return p, t

  def test_wasserstein_different_ensemble_sizes(self):
    import scipy.stats
    p, t = self._pair()
    out = probabilistic.WassersteinDistance('number').compute(
        {'v': p}, {'v': t})['v']
    pv, tv = np.asarray(p.values), np.asarray(t.values)
    expect = [scipy.stats.wasserstein_distance(pv[:, i], tv[:, i])
              for i in range(4)]
    np.testing.assert_allclose(np.asarray(out.values), expect, atol=1e-6)

  def test_wasserstein_missing_ensemble_dim_raises(self):
    p, t = self._pair()
    t_no_ens = t.isel({'number': 0})
    with pytest.raises((ValueError, KeyError)):
      probabilistic.WassersteinDistance('number').compute(
          {'v': p}, {'v': t_no_ens})

  def test_crps_skill_two_ensembles(self):
    # E|X - Y| over the product of the two ensembles (pseudo-dim case).
    p, t = self._pair()
    out = probabilistic.CRPSSkill('number').compute({'v': p}, {'v': t})['v']
    pv, tv = np.asarray(p.values), np.asarray(t.values)
    expect = np.abs(pv[:, None, :] - tv[None, :, :]).mean(axis=(0, 1))
    np.testing.assert_allclose(np.asarray(out.values), expect, atol=1e-6)


class TestReviewRegressions:
  """Regressions for the round-3 metrics-layer review findings."""

  def _pair(self, ens=5):
    rng = np.random.default_rng(7)
    p = DimArray(rng.standard_normal((ens, 6)).astype(np.float32),
                 ('number', 'x'),
                 {'number': np.arange(ens), 'x': np.arange(6)})
    t = DimArray(rng.standard_normal((6,)).astype(np.float32),
                 ('x',), {'x': np.arange(6)})
    return p, t

  def test_skipna_unique_names_do_not_collide(self):
    for cls, kwargs in [
        (probabilistic.CRPSSkill, {}),
        (probabilistic.CRPSSpread, {}),
    ]:
      a = cls(skipna_ensemble=False, **kwargs)
      b = cls(skipna_ensemble=True, **kwargs)
      assert a.unique_name != b.unique_name
      # Default keeps reference name parity (no suffix).
      assert 'skipna' not in a.unique_name

    inner = probabilistic.EnsembleAveragedStatistic
    from weatherbenchx_tpu.metrics import deterministic as det
    a = inner(det.SquaredError(), ensemble_dim='number',
              skipna_ensemble=False)
    b = inner(det.SquaredError(), ensemble_dim='number',
              skipna_ensemble=True)
    assert a.unique_name != b.unique_name
    assert a.unique_name == 'SquaredError_each_number'

  def test_crps_ensemble_skipna_variants_coexist(self):
    p, t = self._pair()
    pv = np.asarray(p.values).copy()
    pv[0, 0] = np.nan
    p = DimArray(pv, p.dims, p.coords)
    metrics = {
        'crps': probabilistic.CRPSEnsemble(skipna_ensemble=False),
        'crps_skipna': probabilistic.CRPSEnsemble(skipna_ensemble=True),
    }
    out = compute_all(metrics, {'v': p}, {'v': t}, reduce_dims=[])
    plain = np.asarray(out['crps.v'].values)
    skipna = np.asarray(out['crps_skipna.v'].values)
    assert np.isnan(plain[0]) and not np.isnan(skipna[0])
    # Non-NaN points agree.
    np.testing.assert_allclose(plain[1:], skipna[1:], rtol=1e-5)

  def test_crps_ensemble_distance_forwards_skipna(self):
    p, t = self._pair(ens=5)
    # Ensemble targets with one NaN member at x=0 in BOTH sides.
    rng = np.random.default_rng(11)
    tv = rng.standard_normal((4, 6)).astype(np.float32)
    tv[1, 0] = np.nan
    t_ens = DimArray(tv, ('number', 'x'),
                     {'number': np.arange(4), 'x': np.arange(6)})
    pv = np.asarray(p.values).copy()
    pv[2, 0] = np.nan
    p = DimArray(pv, p.dims, p.coords)
    m = probabilistic.CRPSEnsembleDistance(skipna_ensemble=True)
    out = compute_all({'crps_d': m}, {'v': p}, {'v': t_ens},
                      reduce_dims=[])['crps_d.v']
    vals = np.asarray(out.values)
    assert not np.isnan(vals).any(), (
        'skipna_ensemble=True must skip NaN members in the skill and '
        'target-spread terms too')

  def test_rank_histogram_propagates_nan(self):
    p, t = self._pair(ens=4)
    tv = np.asarray(t.values).copy()
    tv[2] = np.nan
    t = DimArray(tv, t.dims, t.coords)
    out = probabilistic.RankHistogram().compute({'v': p}, {'v': t})['v']
    vals = np.asarray(out.transpose('x', 'rank').values)
    assert np.isnan(vals[2]).all(), 'NaN target must not be counted'
    assert not np.isnan(vals[[0, 1, 3, 4, 5]]).any()
    # Non-NaN rows are still one-hot.
    np.testing.assert_allclose(
        vals[[0, 1, 3, 4, 5]].sum(axis=-1), 1.0)

    # NaN ensemble member likewise.
    pv = np.asarray(p.values).copy()
    pv[1, 4] = np.nan
    p2 = DimArray(pv, p.dims, p.coords)
    t2 = DimArray(np.asarray(self._pair(ens=4)[1].values), t.dims, t.coords)
    out2 = probabilistic.RankHistogram().compute({'v': p2}, {'v': t2})['v']
    vals2 = np.asarray(out2.transpose('x', 'rank').values)
    assert np.isnan(vals2[4]).all()

  def test_rev_drops_true_negatives_but_values_unchanged(self):
    rev = probabilistic.RelativeEconomicValue(ensemble_size=4)
    assert 'TrueNegatives' not in rev.statistics
    # REV still finalizes correctly (existing numeric tests cover values);
    # smoke the full path here.
    rng = np.random.default_rng(3)
    p = DimArray(rng.uniform(size=(50,)).astype(np.float32), ('x',),
                 {'x': np.arange(50)})
    t = DimArray((rng.uniform(size=(50,)) > 0.5).astype(np.float32),
                 ('x',), {'x': np.arange(50)})
    out = compute_all({'rev': rev}, {'v': p}, {'v': t},
                      reduce_dims=['x'])['rev.v']
    assert np.isfinite(np.asarray(out.values)).any()

  def test_conflicting_statistics_same_name_raise(self):
    from weatherbenchx_tpu.metrics import deterministic as det
    m1 = det.ErrorExceedance([1.0])
    m2 = det.ErrorExceedance([2.0])
    with pytest.raises(ValueError, match='unique_name'):
      mbase.unique_statistics_for_metrics({'m1': m1, 'm2': m2})
    # Same parameters dedupe fine.
    m3 = det.ErrorExceedance([1.0])
    stats = mbase.unique_statistics_for_metrics({'m1': m1, 'm3': m3})
    assert len(stats) == 1

  def test_rev_different_ensemble_sizes_raise_not_silent(self):
    metrics = {
        'rev4': probabilistic.RelativeEconomicValue(ensemble_size=4),
        'rev8': probabilistic.RelativeEconomicValue(ensemble_size=8),
    }
    with pytest.raises(ValueError, match='unique_name'):
      mbase.unique_statistics_for_metrics(metrics)


class TestFusedEnsemblePass:
  """The fused spread+skill+moments kernel pass == the standalone paths.

  One kernel pass computes CRPS spread, CRPS skill, the ensemble mean and
  Σ(x−mean)², shared across sibling statistics via base.computation_cache
  (it saves a second sweep over the production 50-member ensemble). These
  select the kernel in interpret mode on CPU and pin equality with the
  unfused paths, NaN semantics included.
  """

  @staticmethod
  def _select(monkeypatch, kernel):
    monkeypatch.setattr(ensemble_stats, 'kernel_for', lambda backend: kernel)

  def _interpret(self, monkeypatch):
    self._select(monkeypatch, functools.partial(
        ensemble_stats.fused_ensemble_stats, interpret=True))

  def _inputs(self, nan=True):
    rng = np.random.default_rng(0)
    m, nl, la, lo = 7, 3, 10, 12
    coords = {
        'lead_time': (np.arange(nl) * np.timedelta64(6, 'h')
                      ).astype('timedelta64[ns]'),
        'latitude': np.linspace(-90, 90, la),
        'longitude': np.linspace(0, 360, lo, endpoint=False)}
    x = (280 + 5 * rng.standard_normal((m, nl, la, lo))).astype(np.float32)
    if nan:
      x[2, 1, 3, 4] = np.nan
    y = (280 + 5 * rng.standard_normal((nl, la, lo))).astype(np.float32)
    preds = {'t2m': DimArray(
        x, ('number', 'lead_time', 'latitude', 'longitude'),
        dict(coords, number=np.arange(m)))}
    tgts = {'t2m': DimArray(y, ('lead_time', 'latitude', 'longitude'),
                            coords)}
    return preds, tgts, x, y, m

  def test_fused_matches_f64_and_plain(self, monkeypatch):
    self._interpret(monkeypatch)
    preds, tgts, x, y, m = self._inputs()
    metrics = {'crps': probabilistic.CRPSEnsemble(use_sort=True),
               'ssr': probabilistic.UnbiasedSpreadSkillRatio(),
               'umr': probabilistic.UnbiasedEnsembleMeanRMSE()}
    fused = mbase.compute_unique_statistics_for_all_metrics(
        metrics, preds, tgts)
    self._select(monkeypatch, None)
    plain = mbase.compute_unique_statistics_for_all_metrics(
        metrics, preds, tgts)

    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    truth = {
        'CRPSSkill_number': np.abs(x64 - y64).mean(0),
        'CRPSSpread_number_fair_predictions':
            np.abs(x64[:, None] - x64[None, :]).sum((0, 1)) / (m * (m - 1)),
        'EnsembleVariance_number_skipna_ensemble_False':
            x64.var(0, ddof=1),
        'UnbiasedEnsembleMeanSquaredError_number_skipna_ensemble_False':
            (x64.mean(0) - y64) ** 2 - x64.var(0, ddof=1) / m,
    }
    for k, want in truth.items():
      got = np.asarray(fused[k]['t2m'].values, np.float64)
      # NaN poisoning identical to the unfused semantics
      assert (np.isnan(got) == np.isnan(want)).all(), k
      rel = np.nanmax(np.abs(got - want) / np.maximum(np.abs(want), 1.0))
      # spread/skill/variance sit at f32 roundoff; the unbiased MSE's
      # (mean−y)² − var/m cancellation is inherent to the statistic — pin
      # it to the PLAIN path's error instead of an absolute bound.
      plain_got = np.asarray(plain[k]['t2m'].values, np.float64)
      plain_rel = np.nanmax(
          np.abs(plain_got - want) / np.maximum(np.abs(want), 1.0))
      assert rel <= max(2 * plain_rel, 5e-7), (k, rel, plain_rel)

  def test_fused_pass_runs_once_per_input_pair(self, monkeypatch):
    preds, tgts, *_ = self._inputs(nan=False)
    calls = []

    def spy(x, y):
      calls.append(x.shape)
      return ensemble_stats.fused_ensemble_stats(x, y, interpret=True)

    self._select(monkeypatch, spy)
    metrics = {'crps': probabilistic.CRPSEnsemble(use_sort=True),
               'ssr': probabilistic.UnbiasedSpreadSkillRatio(),
               'umr': probabilistic.UnbiasedEnsembleMeanRMSE()}
    mbase.compute_unique_statistics_for_all_metrics(metrics, preds, tgts)
    assert len(calls) == 1, calls

  def test_no_cache_no_fusion(self, monkeypatch):
    """Outside a compute pass (no active cache) stats keep their
    standalone paths — the memo must never hold tracers across traces."""
    self._interpret(monkeypatch)
    preds, tgts, *_ = self._inputs(nan=False)
    assert mbase.get_computation_cache() is None
    stat = probabilistic.CRPSSkill()
    out = stat.compute(preds, tgts)
    want = np.abs(np.asarray(preds['t2m'].values)
                  - np.asarray(tgts['t2m'].values)[None]).mean(0)
    np.testing.assert_allclose(np.asarray(out['t2m'].values), want,
                               rtol=1e-6)

  def test_mask_coord_survives_fusion(self, monkeypatch):
    self._interpret(monkeypatch)
    preds, tgts, *_ = self._inputs(nan=False)
    mask = np.random.default_rng(1).random((10, 12)) > 0.3
    tgts = {'t2m': tgts['t2m'].assign_coords(
        mask=Coord(('latitude', 'longitude'), mask))}
    metrics = {'crps': probabilistic.CRPSEnsemble(use_sort=True)}
    stats = mbase.compute_unique_statistics_for_all_metrics(
        metrics, preds, tgts)
    skill = stats['CRPSSkill_number']['t2m']
    assert skill.has_coord('mask')
    np.testing.assert_array_equal(
        np.asarray(skill.coords['mask'].values), mask)

  def test_memo_pins_inputs_against_id_reuse(self, monkeypatch):
    """The id()-keyed memo must hold references to the keyed arrays.

    In eager passes, wrapper transforms build fresh same-shape arrays per
    statistic; once freed, CPython reuses the id and a later statistic
    with DIFFERENT data would silently get the previous statistic's
    fused results. Pinning the inputs in the entry
    makes id collision impossible while the entry lives.
    """
    self._interpret(monkeypatch)
    preds, tgts, x, _, _ = self._inputs(nan=False)
    with mbase.computation_cache():
      cache = mbase.get_computation_cache()
      out = probabilistic._fused_ensemble_pass(
          preds['t2m'], tgts['t2m'], 'number')
      assert out is not None
      entry = next(v for v in cache.values()
                   if isinstance(v, dict) and 'spread_sum' in v)
      assert entry['_pin'][0] is preds['t2m'].data
      assert entry['_pin'][1] is tgts['t2m'].data
      # Functional check: drop the caller's reference, build a fresh
      # same-shape array (the id-reuse scenario), and verify the pass
      # does NOT return the stale entry for the new data.
      skill_a = np.asarray(out['skill_sum'].values).copy()
      dims, coords = preds['t2m'].dims, dict(preds['t2m'].coords)
      del preds, out, entry
      x2 = np.ascontiguousarray(x + 100.0)
      preds2 = DimArray(x2, dims,
                        {k: c for k, c in coords.items()})
      out2 = probabilistic._fused_ensemble_pass(
          preds2, tgts['t2m'], 'number')
      assert out2 is not None
      skill_b = np.asarray(out2['skill_sum'].values)
      assert not np.allclose(skill_a, skill_b)
