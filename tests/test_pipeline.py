"""Pipeline equivalence tests: chunked+sharded == direct single-chunk.

Mirrors the reference's flagship test (``beam_pipeline_test.py:80-168``):
the distributed result must equal the in-memory single-chunk computation
for several reduce_dims configurations, on both metric values and the
serialized AggregationState, atol=1e-5. Here "distributed" additionally
means GSPMD over an 8-device virtual CPU mesh.
"""

import os

import jax
import numpy as np
import pytest

from weatherbenchx_tpu import aggregation, binning, test_utils, weighting
from weatherbenchx_tpu import time_chunks as time_chunks_lib
from weatherbenchx_tpu.darray import DimArray
from weatherbenchx_tpu.data import loaders
from weatherbenchx_tpu.metrics import deterministic
from weatherbenchx_tpu.parallel import evaluator as evaluator_lib
from weatherbenchx_tpu.parallel import pipeline as pipeline_lib


def _source_datasets(n_valid=16, n_lead=4, seed=0, ens=None):
  """Builds forecast + analysis source datasets with consistent truth."""
  rng = np.random.default_rng(seed)
  lats = np.linspace(-90, 90, 7)
  lons = np.linspace(0, 360, 8, endpoint=False)
  valid_times = (np.datetime64('2020-01-01', 'ns')
                 + np.arange(n_valid) * np.timedelta64(6, 'h'))
  lead_times = (np.arange(n_lead) * np.timedelta64(6, 'h')
                ).astype('timedelta64[ns]')
  init_times = valid_times[:n_valid - n_lead]

  tgt = {
      '2m_temperature': DimArray(
          rng.standard_normal((n_valid, 7, 8)).astype(np.float32),
          ('valid_time', 'latitude', 'longitude'),
          {'valid_time': valid_times, 'latitude': lats, 'longitude': lons})
  }
  pshape = (len(init_times), n_lead, 7, 8)
  pdims = ('init_time', 'lead_time', 'latitude', 'longitude')
  pcoords = {'init_time': init_times, 'lead_time': lead_times,
             'latitude': lats, 'longitude': lons}
  if ens:
    pshape = (ens,) + pshape
    pdims = ('number',) + pdims
    pcoords = {**pcoords, 'number': np.arange(ens)}
  pred = {'2m_temperature': DimArray(
      rng.standard_normal(pshape).astype(np.float32), pdims, pcoords)}
  return pred, tgt, init_times, lead_times


METRICS = {'rmse': deterministic.RMSE(), 'bias': deterministic.Bias()}


def _run_both(reduce_dims, init_chunk=1, lead_chunk=2, mesh=None,
              dim_to_axis=None, **agg_kwargs):
  pred_ds, tgt_ds, init_times, lead_times = _source_datasets()
  agg = aggregation.Aggregator(reduce_dims=reduce_dims, **agg_kwargs)
  times = time_chunks_lib.TimeChunks(
      init_times, lead_times,
      init_time_chunk_size=init_chunk, lead_time_chunk_size=lead_chunk)

  pipe_values = pipeline_lib.evaluate(
      METRICS, agg,
      predictions_loader=loaders.PredictionsFromDataset(
          ds=pred_ds, rename_dimensions=None),
      targets_loader=loaders.TargetsFromDataset(
          ds=tgt_ds, rename_dimensions=None),
      times=times, mesh=mesh, dim_to_axis=dim_to_axis)

  # Direct single-chunk ground truth.
  direct_preds = loaders.PredictionsFromDataset(
      ds=pred_ds, rename_dimensions=None).load_chunk(init_times, lead_times)
  direct_tgts = loaders.TargetsFromDataset(
      ds=tgt_ds, rename_dimensions=None).load_chunk(init_times, lead_times)
  direct_values = aggregation.compute_metric_values_for_single_chunk(
      METRICS, agg, direct_preds, direct_tgts)
  return pipe_values, direct_values


REDUCE_CONFIGS = [
    ('all', ['init_time', 'lead_time', 'latitude', 'longitude']),
    ('keep_lead', ['init_time', 'latitude', 'longitude']),
    ('keep_init', ['lead_time', 'latitude', 'longitude']),
    ('keep_both_times', ['latitude', 'longitude']),
    ('keep_space', ['init_time', 'lead_time']),
]


class TestChunkedVsDirect:
  @pytest.mark.parametrize('name,reduce_dims', REDUCE_CONFIGS)
  def test_equivalence(self, name, reduce_dims):
    pipe_values, direct_values = _run_both(reduce_dims)
    assert set(pipe_values) == set(direct_values)
    for k in direct_values:
      d = direct_values[k]
      p = pipe_values[k]
      p = p.transpose(*d.dims) if set(p.dims) == set(d.dims) and p.dims != d.dims else p
      np.testing.assert_allclose(
          np.asarray(p.values), np.asarray(d.values), atol=1e-5,
          err_msg=f'{name}:{k}')
      # Preserved time dims keep correct coords (restored to datetime).
      for dim in d.dims:
        if dim in ('init_time', 'lead_time'):
          np.testing.assert_array_equal(
              p.coord_values(dim), d.coord_values(dim))

  def test_weighted_binned_equivalence(self):
    pipe_values, direct_values = _run_both(
        ['init_time', 'latitude', 'longitude'],
        weigh_by=[weighting.GridAreaWeighting()],
        bin_by=[binning.Regions({'global': ((-90, 90), (0, 360)),
                                 'sh': ((-90, -20), (0, 360))})])
    for k in direct_values:
      np.testing.assert_allclose(
          np.asarray(pipe_values[k].transpose(
              *direct_values[k].dims).values),
          np.asarray(direct_values[k].values), atol=1e-5)

  def test_masked_nan_equivalence(self):
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets(seed=3)
    # Poke NaNs into targets; load with nan-mask; masked aggregation.
    tv = np.asarray(tgt_ds['2m_temperature'].values).copy()
    tv[::3, 2, 4] = np.nan
    tgt_ds = {'2m_temperature': tgt_ds['2m_temperature'].copy(data=tv)}
    agg = aggregation.Aggregator(
        reduce_dims=['init_time', 'lead_time', 'latitude', 'longitude'],
        masked=True)
    times = time_chunks_lib.TimeChunks(
        init_times, lead_times, init_time_chunk_size=3,
        lead_time_chunk_size=2)
    ploader = loaders.PredictionsFromDataset(ds=pred_ds,
                                             rename_dimensions=None)
    tloader = loaders.TargetsFromDataset(
        ds=tgt_ds, rename_dimensions=None, add_nan_mask=True)
    pipe_values = pipeline_lib.evaluate(
        {'mse': deterministic.MSE()}, agg, ploader, tloader, times)
    direct = aggregation.compute_metric_values_for_single_chunk(
        {'mse': deterministic.MSE()}, agg,
        ploader.load_chunk(init_times, lead_times),
        tloader.load_chunk(init_times, lead_times))
    v = pipe_values['mse.2m_temperature'].item()
    assert np.isfinite(v)
    np.testing.assert_allclose(v, direct['mse.2m_temperature'].item(),
                               atol=1e-5)

  def test_climatology_metric_through_pipeline(self):
    """ACC via precomputed device gather indices == host-sel direct path."""
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets(seed=4)
    lats = pred_ds['2m_temperature'].coord_values('latitude')
    lons = pred_ds['2m_temperature'].coord_values('longitude')
    rng = np.random.default_rng(11)
    clim = {'2m_temperature': DimArray(
        rng.standard_normal((366, 4, len(lats), len(lons))).astype(np.float32),
        ('dayofyear', 'hour', 'latitude', 'longitude'),
        {'dayofyear': np.arange(1, 367), 'hour': np.array([0, 6, 12, 18]),
         'latitude': lats, 'longitude': lons})}
    metrics = {'acc': deterministic.ACC(climatology=clim)}
    agg = aggregation.Aggregator(
        reduce_dims=['init_time', 'latitude', 'longitude'])
    times = time_chunks_lib.TimeChunks(
        init_times, lead_times, init_time_chunk_size=4,
        lead_time_chunk_size=2)
    pipe_values = pipeline_lib.evaluate(
        metrics, agg,
        loaders.PredictionsFromDataset(ds=pred_ds, rename_dimensions=None),
        loaders.TargetsFromDataset(ds=tgt_ds, rename_dimensions=None),
        times)
    ploader = loaders.PredictionsFromDataset(ds=pred_ds,
                                             rename_dimensions=None)
    tloader = loaders.TargetsFromDataset(ds=tgt_ds, rename_dimensions=None)
    direct = aggregation.compute_metric_values_for_single_chunk(
        metrics, agg,
        ploader.load_chunk(init_times, lead_times),
        tloader.load_chunk(init_times, lead_times))
    np.testing.assert_allclose(
        np.asarray(pipe_values['acc.2m_temperature'].values),
        np.asarray(direct['acc.2m_temperature'].values), atol=1e-5)


class TestShardedVsSingleDevice:
  """The mesh analogue of chunked-vs-direct: GSPMD mesh == single device."""

  @pytest.mark.parametrize('reduce_dims', [
      ['init_time', 'lead_time', 'latitude', 'longitude'],
      ['init_time', 'latitude', 'longitude'],
  ])
  def test_mesh_equivalence(self, reduce_dims):
    mesh = jax.make_mesh((2, 4), ('batch', 'space'))
    sharded, _ = _run_both(
        reduce_dims, init_chunk=6, lead_chunk=4, mesh=mesh,
        dim_to_axis={'init_time': 'batch', 'longitude': 'space'},
        weigh_by=[weighting.GridAreaWeighting()])
    single, direct = _run_both(
        reduce_dims, init_chunk=6, lead_chunk=4,
        weigh_by=[weighting.GridAreaWeighting()])
    for k in direct:
      np.testing.assert_allclose(
          np.asarray(sharded[k].values), np.asarray(single[k].values),
          atol=1e-5)
      np.testing.assert_allclose(
          np.asarray(sharded[k].transpose(*direct[k].dims).values
                     if set(sharded[k].dims) == set(direct[k].dims)
                     else sharded[k].values),
          np.asarray(direct[k].values), atol=1e-5)

  def test_ensemble_axis_sharding(self):
    """Shard the ensemble dim; statistics reduce over it inside the step."""
    mesh = jax.make_mesh((8,), ('ensemble',))
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets(
        seed=5, ens=8)
    # Use ensemble-mean RMSE via plain mean over 'number' in a custom stat.
    from weatherbenchx_tpu.metrics import base as mbase

    class EnsMeanSE(mbase.PerVariableStatistic):
      def _compute_per_variable(self, predictions, targets):
        return (predictions.mean('number') - targets) ** 2

    metrics = {'emse': EnsMeanSE()}
    agg = aggregation.Aggregator(
        reduce_dims=['init_time', 'lead_time', 'latitude', 'longitude'])
    times = time_chunks_lib.TimeChunks(init_times, lead_times)
    sharded = pipeline_lib.evaluate(
        metrics, agg,
        loaders.PredictionsFromDataset(ds=pred_ds, rename_dimensions=None),
        loaders.TargetsFromDataset(ds=tgt_ds, rename_dimensions=None),
        times, mesh=mesh, dim_to_axis={'number': 'ensemble'})
    plain = pipeline_lib.evaluate(
        metrics, agg,
        loaders.PredictionsFromDataset(ds=pred_ds, rename_dimensions=None),
        loaders.TargetsFromDataset(ds=tgt_ds, rename_dimensions=None),
        times)
    np.testing.assert_allclose(
        sharded['emse.2m_temperature'].item(),
        plain['emse.2m_temperature'].item(), atol=1e-5)


class TestCheckpointResume:
  def test_resume_gives_identical_result(self, tmp_path):
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets(seed=6)
    agg = aggregation.Aggregator(
        reduce_dims=['init_time', 'lead_time', 'latitude', 'longitude'])
    times = time_chunks_lib.TimeChunks(
        init_times, lead_times, init_time_chunk_size=4)
    mk = lambda ckpt: pipeline_lib.EvaluationPipeline(
        metrics=METRICS, aggregator=agg,
        predictions_loader=loaders.PredictionsFromDataset(
            ds=pred_ds, rename_dimensions=None),
        targets_loader=loaders.TargetsFromDataset(
            ds=tgt_ds, rename_dimensions=None),
        times=times, checkpoint_path=ckpt, checkpoint_every=1)
    full = mk(None).run().metric_values(METRICS)

    ckpt = str(tmp_path / 'ck')
    # Simulate a crash after 2 chunks: run only the first two manually.
    pipe = mk(ckpt)
    stream = pipe._chunk_stream()
    buckets = {}
    for i, offsets, (p, t) in stream:
      state = pipe._evaluator.eval_chunk(p, t)
      key = tuple(getattr(offsets, d) if d in pipe._bucket_dims else -1
                  for d in ('init_time', 'lead_time'))
      buckets[key] = state if key not in buckets else (
          aggregation.AggregationState.sum([buckets[key], state]))
      if i == 1:
        pipe._save_checkpoint(buckets, 2)
        break
    # Fresh pipeline resumes from chunk 2 and completes.
    resumed = mk(ckpt).run().metric_values(METRICS)
    for k in full:
      np.testing.assert_allclose(
          np.asarray(resumed[k].values), np.asarray(full[k].values),
          atol=1e-6)


class TestLoaders:
  def test_targets_valid_time_coord(self):
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets()
    chunk = loaders.TargetsFromDataset(
        ds=tgt_ds, rename_dimensions=None).load_chunk(
            init_times[:2], lead_times[:2])
    da = chunk['2m_temperature']
    assert da.dims == ('init_time', 'lead_time', 'latitude', 'longitude')
    vt = da.coords['valid_time']
    assert vt.dims == ('init_time', 'lead_time')
    np.testing.assert_array_equal(
        np.asarray(vt.values),
        init_times[:2, None] + lead_times[None, :2])
    # Values actually come from the right valid_times.
    src = tgt_ds['2m_temperature']
    np.testing.assert_array_equal(
        da.isel(init_time=1, lead_time=1).values,
        src.sel(valid_time=init_times[1] + lead_times[1]).values)

  def test_ecmwf_renaming(self):
    preds_raw = test_utils.mock_prediction_data(
        random=True, variables_3d=(), time_stop='2020-01-05')
    loader = loaders.PredictionsFromDataset(ds=preds_raw)
    init_times = preds_raw['2m_temperature'].coord_values('time')[:2]
    lead_times = preds_raw['2m_temperature'].coord_values(
        'prediction_timedelta')[:2]
    chunk = loader.load_chunk(init_times, lead_times)
    assert 'init_time' in chunk['2m_temperature'].dims
    assert 'lead_time' in chunk['2m_temperature'].dims

  def test_persistence(self):
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets()
    chunk = loaders.PersistenceFromDataset(
        ds=tgt_ds, rename_dimensions=None).load_chunk(
            init_times[:2], lead_times[:3])
    da = chunk['2m_temperature']
    assert da.sizes['lead_time'] == 3
    # Same value replicated along lead.
    np.testing.assert_array_equal(
        da.isel(lead_time=0).values, da.isel(lead_time=2).values)

  def test_probabilistic_climatology(self):
    rng = np.random.default_rng(0)
    valid_times = np.arange(
        np.datetime64('2018-01-01', 'ns'), np.datetime64('2021-01-01', 'ns'),
        np.timedelta64(6, 'h'))
    tgt_ds = {'t': DimArray(
        rng.standard_normal((len(valid_times), 3)).astype(np.float32),
        ('valid_time', 'latitude'),
        {'valid_time': valid_times, 'latitude': np.array([-10., 0., 10.])})}
    loader = loaders.ProbabilisticClimatologyFromDataset(
        start_year=2018, end_year=2019, ds=tgt_ds, rename_dimensions=None)
    init_times = np.array(['2020-06-01T00', '2020-06-02T12'],
                          dtype='datetime64[ns]')
    lead_times = np.array([0, 6], dtype='timedelta64[h]').astype(
        'timedelta64[ns]')
    chunk = loader.load_chunk(init_times, lead_times)
    da = chunk['t']
    assert da.dims == ('number', 'init_time', 'lead_time', 'latitude')
    assert da.sizes['number'] == 2
    # Member 0 comes from 2018 at same dayofyear/hour.
    import pandas as pd
    vt = pd.Timestamp('2020-06-01T00')
    doy, hod = vt.dayofyear, vt.hour
    t2018 = (np.datetime64('2018', 'ns')
             + ((doy - 1) * 24 + hod) * np.timedelta64(1, 'h'))
    src = tgt_ds['t'].sel(valid_time=t2018)
    np.testing.assert_array_equal(
        da.isel(number=0, init_time=0, lead_time=0).values, src.values)


class TestDistributedPartition:
  """Multi-process data parallelism, simulated single-process.

  distributed=True partitions chunks by index % process_count and combines
  per-process partial states with a monoid sum over DCN
  (pipeline.py:_chunk_stream/_allgather_sum_states). Simulate two processes
  by patching jax.process_count/index and summing the partials by hand —
  the monoid sum is exactly what the host all-gather applies.
  """

  def test_two_process_partials_sum_to_full_result(self, monkeypatch):
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets()
    agg = aggregation.Aggregator(
        reduce_dims=['init_time', 'latitude', 'longitude'],
        weigh_by=[weighting.GridAreaWeighting()])

    def make_pipe():
      return pipeline_lib.EvaluationPipeline(
          metrics=METRICS, aggregator=agg,
          predictions_loader=loaders.PredictionsFromDataset(
              ds=pred_ds, rename_dimensions=None),
          targets_loader=loaders.TargetsFromDataset(
              ds=tgt_ds, rename_dimensions=None),
          times=time_chunks_lib.TimeChunks(
              init_times, lead_times,
              init_time_chunk_size=1, lead_time_chunk_size=2),
          distributed=True)

    # The DCN combine is the monoid sum; patch it out and apply by hand.
    monkeypatch.setattr(pipeline_lib, '_allgather_sum_states', lambda s: s)
    monkeypatch.setattr(jax, 'process_count', lambda: 2)
    partials = []
    chunk_counts = []
    for pi in [0, 1]:
      monkeypatch.setattr(jax, 'process_index', lambda pi=pi: pi)
      pipe = make_pipe()
      seen = sum(1 for _ in pipe._chunk_stream())
      chunk_counts.append(seen)
      partials.append(pipe.run())
    # The two processes saw disjoint, jointly-exhaustive chunk sets.
    n_chunks = len(list(time_chunks_lib.TimeChunks(
        init_times, lead_times, init_time_chunk_size=1,
        lead_time_chunk_size=2)))
    assert sum(chunk_counts) == n_chunks and min(chunk_counts) > 0

    combined = aggregation.AggregationState.sum(partials)
    values = combined.metric_values(METRICS)

    monkeypatch.setattr(jax, 'process_count', lambda: 1)
    monkeypatch.setattr(jax, 'process_index', lambda: 0)
    single = make_pipe()
    single.distributed = False
    expected = single.run().metric_values(METRICS)
    assert set(values) == set(expected)
    for k in expected:
      a = values[k].transpose(*expected[k].dims)
      np.testing.assert_allclose(np.asarray(a.values),
                                 np.asarray(expected[k].values), atol=1e-5)


class TestChunksPerDispatch:
  """chunks_per_dispatch > 1 (vmapped multi-chunk XLA dispatch) must equal
  the one-dispatch-per-chunk result, including climatology gather coords
  and mesh sharding."""

  def _values(self, group, mesh=None, dim_to_axis=None):
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets()
    agg = aggregation.Aggregator(
        reduce_dims=['init_time', 'latitude', 'longitude'],
        weigh_by=[weighting.GridAreaWeighting()],
        bin_by=[binning.Regions({'global': ((-90, 90), (0, 360)),
                                 'nh': ((20, 90), (0, 360))})])
    # Climatology exercises the precomputed gather-index device coords
    # under vmap (Statistic.prepare_chunk leaves get a batch axis).
    clim = {'2m_temperature': DimArray(
        np.random.default_rng(7).standard_normal((366, 4, 7, 8)).astype(
            np.float32),
        ('dayofyear', 'hour', 'latitude', 'longitude'),
        {'dayofyear': np.arange(1, 367),
         'hour': np.array([0, 6, 12, 18]),
         'latitude': np.linspace(-90, 90, 7),
         'longitude': np.linspace(0, 360, 8, endpoint=False)})}
    metrics = dict(METRICS, acc=deterministic.ACC(climatology=clim))
    pipe = pipeline_lib.EvaluationPipeline(
        metrics=metrics, aggregator=agg,
        predictions_loader=loaders.PredictionsFromDataset(
            ds=pred_ds, rename_dimensions=None),
        targets_loader=loaders.TargetsFromDataset(
            ds=tgt_ds, rename_dimensions=None),
        times=time_chunks_lib.TimeChunks(
            init_times, lead_times,
            init_time_chunk_size=1, lead_time_chunk_size=2),
        mesh=mesh, dim_to_axis=dim_to_axis,
        chunks_per_dispatch=group)
    return pipe.run().metric_values(metrics)

  @pytest.mark.parametrize('group', [3, 5])
  def test_batched_equals_single(self, group):
    single = self._values(1)
    batched = self._values(group)  # 5 does not divide 24: tail flush path
    assert set(batched) == set(single)
    for k in single:
      a = batched[k].transpose(*single[k].dims)
      np.testing.assert_allclose(np.asarray(a.values),
                                 np.asarray(single[k].values), atol=1e-5)

  def test_batched_on_mesh(self):
    mesh = jax.make_mesh((2, 4), ('batch', 'space'))
    single = self._values(1)
    batched = self._values(4, mesh=mesh,
                           dim_to_axis={'lead_time': 'batch',
                                        'longitude': 'space'})
    for k in single:
      a = batched[k].transpose(*single[k].dims)
      np.testing.assert_allclose(np.asarray(a.values),
                                 np.asarray(single[k].values), atol=1e-5)


def test_fused_accumulate_equals_default(monkeypatch):
  """WBX_FUSED_ACCUM=1 (eval fused with the bucket add) is bit-equal."""
  pred_ds, tgt_ds, init_times, lead_times = _source_datasets()
  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'])

  def run():
    return pipeline_lib.EvaluationPipeline(
        metrics=METRICS, aggregator=agg,
        predictions_loader=loaders.PredictionsFromDataset(
            ds=pred_ds, rename_dimensions=None),
        targets_loader=loaders.TargetsFromDataset(
            ds=tgt_ds, rename_dimensions=None),
        times=time_chunks_lib.TimeChunks(
            init_times, lead_times,
            init_time_chunk_size=1, lead_time_chunk_size=2),
    ).run().metric_values(METRICS)

  base = run()
  monkeypatch.setenv('WBX_FUSED_ACCUM', '1')
  fused = run()
  for k in base:
    np.testing.assert_array_equal(
        np.asarray(base[k].values),
        np.asarray(fused[k].transpose(*base[k].dims).values))


class TestDistributedCheckpointResume:
  """Per-process checkpoints in distributed mode (pipeline._ckpt_prefix).

  Each process must save and resume its OWN partial state: a shared
  checkpoint would make every process resume from process 0's partial
  sums, multiply-counting them in the final combine.
  """

  def _make_pipe(self, ckpt, tmp=None):
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets(seed=11)
    agg = aggregation.Aggregator(
        reduce_dims=['init_time', 'lead_time', 'latitude', 'longitude'])
    times = time_chunks_lib.TimeChunks(
        init_times, lead_times, init_time_chunk_size=2)
    return pipeline_lib.EvaluationPipeline(
        metrics=METRICS, aggregator=agg,
        predictions_loader=loaders.PredictionsFromDataset(
            ds=pred_ds, rename_dimensions=None),
        targets_loader=loaders.TargetsFromDataset(
            ds=tgt_ds, rename_dimensions=None),
        times=times, distributed=True,
        checkpoint_path=ckpt, checkpoint_every=1)

  def test_per_process_resume_sums_to_full(self, tmp_path, monkeypatch):
    monkeypatch.setattr(pipeline_lib, '_allgather_sum_states', lambda s: s)
    monkeypatch.setattr(jax, 'process_count', lambda: 2)

    # Ground truth: both processes run to completion, no checkpointing.
    partials = []
    for pi in [0, 1]:
      monkeypatch.setattr(jax, 'process_index', lambda pi=pi: pi)
      partials.append(self._make_pipe(None).run())
    expected = aggregation.AggregationState.sum(partials).metric_values(
        METRICS)

    ckpt = str(tmp_path / 'ck')
    # Each process "crashes" after its first chunk (checkpoint_every=1
    # saved a per-process manifest), then resumes and completes.
    for pi in [0, 1]:
      monkeypatch.setattr(jax, 'process_index', lambda pi=pi: pi)
      pipe = self._make_pipe(ckpt)
      stream = pipe._chunk_stream()
      i, offsets, (p, t) = next(stream)
      state = pipe._evaluator.eval_chunk(p, t)
      key = tuple(getattr(offsets, d) if d in pipe._bucket_dims else -1
                  for d in ('init_time', 'lead_time'))
      pipe._save_checkpoint({key: state}, i + 1)
      stream.close()
    manifests = sorted(f.name for f in tmp_path.iterdir()
                       if f.name.endswith('manifest.json'))
    assert manifests == ['ck.p0.manifest.json', 'ck.p1.manifest.json']

    resumed = []
    loads = []
    for pi in [0, 1]:
      monkeypatch.setattr(jax, 'process_index', lambda pi=pi: pi)
      pipe = self._make_pipe(ckpt)
      n_loads = 0
      orig_load = pipe._load
      def counting_load(chunk, _o=orig_load):
        nonlocal n_loads
        n_loads += 1
        return _o(chunk)
      pipe._load = counting_load
      resumed.append(pipe.run())
      loads.append(n_loads)
    got = aggregation.AggregationState.sum(resumed).metric_values(METRICS)
    for k in expected:
      np.testing.assert_allclose(
          np.asarray(got[k].values), np.asarray(expected[k].values),
          atol=1e-6)
    # Resume filtered completed chunks BEFORE loading them: each process
    # re-loaded strictly fewer chunks than it owns.
    n_chunks = len(self._make_pipe(None).times)
    per_proc = [(n_chunks + 1) // 2, n_chunks // 2]
    assert loads[0] < per_proc[0] and loads[1] < per_proc[1]

  def test_process_count_mismatch_raises(self, tmp_path, monkeypatch):
    monkeypatch.setattr(jax, 'process_count', lambda: 2)
    monkeypatch.setattr(jax, 'process_index', lambda: 0)
    ckpt = str(tmp_path / 'ck')
    pipe = self._make_pipe(ckpt)
    i, offsets, (p, t) = next(pipe._chunk_stream())
    state = pipe._evaluator.eval_chunk(p, t)
    pipe._save_checkpoint({(0, -1): state}, i + 1)

    monkeypatch.setattr(jax, 'process_count', lambda: 3)
    with pytest.raises(ValueError, match='process'):
      self._make_pipe(ckpt)._load_checkpoint()


class TestAllgatherSumStates:
  """The DCN combine must tolerate ragged per-process layouts and
  chunk-starved (zero-state) processes (serialized gather + outer join)."""

  def _station_state(self, stations, values):
    da = DimArray(np.asarray(values, np.float64), ('station',),
                  {'station': np.asarray(stations)})
    w = da.copy(data=np.ones_like(da.values))
    return aggregation.AggregationState(
        {'SquaredError': {'t': da}}, {'SquaredError': {'t': w}})

  def test_ragged_and_zero_states_outer_join(self, monkeypatch):
    from weatherbenchx_tpu import io as io_lib
    a = self._station_state([1, 2, 3], [1.0, 2.0, 3.0])
    b = self._station_state([2, 4], [10.0, 40.0])
    blobs = [io_lib.dumps_dataset(a.to_dataset()), b'',
             io_lib.dumps_dataset(b.to_dataset())]
    monkeypatch.setattr(pipeline_lib, '_allgather_bytes', lambda p: blobs)
    total = pipeline_lib._allgather_sum_states(a)
    out = total.sum_weighted_statistics['SquaredError']['t']
    np.testing.assert_array_equal(out.coord_values('station'), [1, 2, 3, 4])
    np.testing.assert_allclose(np.asarray(out.values), [1.0, 12.0, 3.0, 40.0])

  def test_local_zero_state_participates(self, monkeypatch):
    from weatherbenchx_tpu import io as io_lib
    b = self._station_state([5], [7.0])
    seen = {}
    def fake_gather(payload):
      seen['payload'] = payload
      return [b'', io_lib.dumps_dataset(b.to_dataset())]
    monkeypatch.setattr(pipeline_lib, '_allgather_bytes', fake_gather)
    total = pipeline_lib._allgather_sum_states(
        aggregation.AggregationState.zero())
    assert seen['payload'] == b''
    out = total.sum_weighted_statistics['SquaredError']['t']
    np.testing.assert_allclose(np.asarray(out.values), [7.0])

  def test_dumps_loads_roundtrip(self):
    from weatherbenchx_tpu import io as io_lib
    a = self._station_state([1, 2], [1.5, -2.5])
    ds = a.to_dataset()
    back = io_lib.loads_dataset(io_lib.dumps_dataset(ds))
    assert set(back) == set(ds)
    for k in ds:
      np.testing.assert_array_equal(np.asarray(back[k].values),
                                    np.asarray(ds[k].values))
      assert back[k].dims == ds[k].dims


class TestRemoteFilesystemIO:
  """fsspec-backed output + checkpoint paths (reference beam_utils.py:64-101
  via fsspec; validated on the in-memory filesystem)."""

  def test_metrics_write_and_checkpoint_resume_on_memory_fs(self):
    from weatherbenchx_tpu import fileio
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets(seed=9)
    agg = aggregation.Aggregator(
        reduce_dims=['init_time', 'lead_time', 'latitude', 'longitude'])
    times = time_chunks_lib.TimeChunks(
        init_times, lead_times, init_time_chunk_size=4)
    mk = lambda ckpt: pipeline_lib.EvaluationPipeline(
        metrics=METRICS, aggregator=agg,
        predictions_loader=loaders.PredictionsFromDataset(
            ds=pred_ds, rename_dimensions=None),
        targets_loader=loaders.TargetsFromDataset(
            ds=tgt_ds, rename_dimensions=None),
        times=times, checkpoint_path=ckpt, checkpoint_every=1)

    full = mk(None).run_and_write(out_path='memory://out/metrics.npz')
    back = fileio.load_dataset_any('memory://out/metrics.npz')
    assert set(back) == set(full)
    for k in full:
      np.testing.assert_array_equal(np.asarray(back[k].values),
                                    np.asarray(full[k].values))

    # Interrupt after 2 chunks with checkpoints on memory://, then resume.
    ckpt = 'memory://ckpt/run1'
    pipe = mk(ckpt)
    stream = pipe._chunk_stream()
    buckets = {}
    for i, offsets, (p, t) in stream:
      state = pipe._evaluator.eval_chunk(p, t)
      key = tuple(getattr(offsets, d) if d in pipe._bucket_dims else -1
                  for d in ('init_time', 'lead_time'))
      buckets[key] = state if key not in buckets else (
          aggregation.AggregationState.sum([buckets[key], state]))
      if i == 1:
        pipe._save_checkpoint(buckets, 2)
        stream.close()
        break
    assert fileio.exists(f'{ckpt}.manifest.json')
    resumed = mk(ckpt).run().metric_values(METRICS)
    for k in full:
      np.testing.assert_allclose(
          np.asarray(resumed[k].values), np.asarray(full[k].values),
          atol=1e-6)


class TestDistributedCheckpointCadence:
  """checkpoint_every counts LOCAL completions, not global chunk indices.

  With process_count=2, process 0 owns even global indices (i+1 always
  odd), so a global (i+1) % checkpoint_every == 0 test with an even
  cadence would never fire for it — a crash would silently lose all of
  process 0's progress."""

  def test_every_process_checkpoints(self, tmp_path, monkeypatch):
    monkeypatch.setattr(pipeline_lib, '_allgather_sum_states', lambda s: s)
    monkeypatch.setattr(jax, 'process_count', lambda: 2)
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets(seed=3)
    agg = aggregation.Aggregator(
        reduce_dims=['init_time', 'lead_time', 'latitude', 'longitude'])
    times = time_chunks_lib.TimeChunks(
        init_times, lead_times, init_time_chunk_size=1)
    assert len(times) >= 4  # >= 2 chunks per process
    ckpt = str(tmp_path / 'ck')
    for pi in [0, 1]:
      monkeypatch.setattr(jax, 'process_index', lambda pi=pi: pi)
      pipeline_lib.EvaluationPipeline(
          metrics=METRICS, aggregator=agg,
          predictions_loader=loaders.PredictionsFromDataset(
              ds=pred_ds, rename_dimensions=None),
          targets_loader=loaders.TargetsFromDataset(
              ds=tgt_ds, rename_dimensions=None),
          times=times, distributed=True,
          checkpoint_path=ckpt, checkpoint_every=2).run()
    manifests = sorted(f.name for f in tmp_path.iterdir()
                       if f.name.endswith('manifest.json'))
    assert manifests == ['ck.p0.manifest.json', 'ck.p1.manifest.json']


def test_eval_chunks_matches_eval_chunk():
  """ChunkEvaluator.eval_chunks (batched dispatch API) == per-chunk eval."""
  pred_ds, tgt_ds, init_times, lead_times = _source_datasets(seed=9)
  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'lead_time', 'latitude', 'longitude'])
  ev = evaluator_lib.ChunkEvaluator(metrics=METRICS, aggregator=agg)
  pl_ = loaders.PredictionsFromDataset(ds=pred_ds, rename_dimensions=None)
  tl_ = loaders.TargetsFromDataset(ds=tgt_ds, rename_dimensions=None)
  pairs = []
  for i in range(0, len(init_times) - 1, 2):
    init = init_times[i:i + 2]
    pairs.append((pl_.load_chunk(init, lead_times),
                  tl_.load_chunk(init, lead_times)))
  batched = ev.eval_chunks(pairs)
  singles = [ev.eval_chunk(p, t) for p, t in pairs]
  for b, s in zip(batched, singles):
    vb = b.to_host().metric_values(METRICS)
    vs = s.to_host().metric_values(METRICS)
    for k in vb:
      np.testing.assert_allclose(
          np.asarray(vb[k].values), np.asarray(vs[k].values), atol=1e-6)


class TestInflightWindow:
  """Backpressure accounting invariants (advisor round-2 medium finding)."""

  def _window(self, max_bytes, fetched):
    return pipeline_lib._InflightWindow(
        max_bytes, fetch=lambda token: fetched.append(token))

  def test_over_budget_synchronizes_oldest(self):
    fetched = []
    w = self._window(100, fetched)
    for i in range(3):
      w.push(f't{i}', 40)  # 120 > 100 after the third push
    assert fetched == ['t0']
    assert w.total_bytes == 80

  def test_token_cap_keeps_byte_accounting(self):
    """Entries past the 64-token cap lose their buffer but NOT their bytes,

    so backpressure still fires once cumulative staged bytes exceed the
    budget — the failure mode was 64 small chunks under-budget plateauing
    the byte count while dispatch ran unboundedly ahead.
    """
    fetched = []
    w = self._window(100 * 5, fetched)  # budget = 500 bytes, chunks of 5
    for i in range(120):  # 120 * 5 = 600 bytes staged, far past 64 entries
      w.push(f't{i}', 5)
    # Byte accounting never plateaued: the over-budget fetch fired.
    assert fetched, 'backpressure never fired despite exceeding the budget'
    assert w.total_bytes <= 100 * 5
    # Token-less trimmed entries synchronize nothing (can't fetch None).
    assert all(t is not None for t in fetched)

  def test_at_most_max_tokens_live_buffers(self):
    fetched = []
    w = self._window(1 << 40, fetched)  # never over budget
    for i in range(200):
      w.push(f't{i}', 5)
    live = [t for t, _ in w.entries if t is not None]
    assert len(live) == 64
    assert live[0] == 't136' and live[-1] == 't199'
    assert w.total_bytes == 200 * 5  # trimmed tokens keep their bytes
    assert fetched == []


def test_select_on_reduced_dim_through_pipeline():
  """Regression: wrappers.Select on a reduced GRID dim needs that dim's
  host label coord at trace time — lean_pair must only strip ragged
  (index) coords, not stable grid labels."""
  from weatherbenchx_tpu.metrics import wrappers

  pred_ds, tgt_ds, init_times, lead_times = _source_datasets()
  metrics = {'sel_mse': wrappers.WrappedMetric(
      deterministic.MSE(),
      [wrappers.Select(which='both', sel={'latitude': [-90.0, 0.0, 90.0]})])}
  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'])
  times = time_chunks_lib.TimeChunks(init_times, lead_times,
                                     init_time_chunk_size=4,
                                     lead_time_chunk_size=2)
  pipe_values = pipeline_lib.evaluate(
      metrics, agg,
      predictions_loader=loaders.PredictionsFromDataset(
          ds=pred_ds, rename_dimensions=None),
      targets_loader=loaders.TargetsFromDataset(
          ds=tgt_ds, rename_dimensions=None),
      times=times)
  direct_preds = loaders.PredictionsFromDataset(
      ds=pred_ds, rename_dimensions=None).load_chunk(init_times, lead_times)
  direct_tgts = loaders.TargetsFromDataset(
      ds=tgt_ds, rename_dimensions=None).load_chunk(init_times, lead_times)
  direct = aggregation.compute_metric_values_for_single_chunk(
      metrics, agg, direct_preds, direct_tgts)
  for k in direct:
    np.testing.assert_allclose(
        np.asarray(pipe_values[k].transpose(*direct[k].dims).data,
                   np.float64),
        np.asarray(direct[k].data, np.float64), atol=1e-5, err_msg=k)


class TestCheckpointCrashAtomicity:
  """A crash BETWEEN bucket writes and the manifest write must leave the
  previous (manifest, buckets) set fully loadable — bucket files alternate
  generations, so a save never overwrites what the current manifest
  references."""

  def _mk(self, ckpt, pred_ds, tgt_ds, init_times, lead_times):
    agg = aggregation.Aggregator(
        reduce_dims=['init_time', 'lead_time', 'latitude', 'longitude'])
    times = time_chunks_lib.TimeChunks(
        init_times, lead_times, init_time_chunk_size=4)
    return pipeline_lib.EvaluationPipeline(
        metrics=METRICS, aggregator=agg,
        predictions_loader=loaders.PredictionsFromDataset(
            ds=pred_ds, rename_dimensions=None),
        targets_loader=loaders.TargetsFromDataset(
            ds=tgt_ds, rename_dimensions=None),
        times=times, checkpoint_path=ckpt, checkpoint_every=1)

  def test_generations_alternate_and_manifest_tracks(self, tmp_path):
    import json
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets(seed=11)
    ckpt = str(tmp_path / 'ck')
    pipe = self._mk(ckpt, pred_ds, tgt_ds, init_times, lead_times)
    stream = pipe._chunk_stream()
    i, offsets, (p, t) = next(stream)
    state = pipe._evaluator.eval_chunk(p, t)
    pipe._save_checkpoint({(0, -1): state}, 1)
    m1 = json.load(open(ckpt + '.manifest.json'))
    pipe._save_checkpoint({(0, -1): state}, 2)
    m2 = json.load(open(ckpt + '.manifest.json'))
    assert m1['generation'] != m2['generation']
    paths1 = {b['path'] for b in m1['buckets']}
    paths2 = {b['path'] for b in m2['buckets']}
    assert paths1.isdisjoint(paths2)
    for path in paths1 | paths2:
      assert os.path.exists(path), path

  def test_crashed_save_preserves_previous_checkpoint(self, tmp_path):
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets(seed=12)
    ckpt = str(tmp_path / 'ck')
    pipe = self._mk(ckpt, pred_ds, tgt_ds, init_times, lead_times)
    stream = pipe._chunk_stream()
    i, offsets, (p, t) = next(stream)
    state1 = pipe._evaluator.eval_chunk(p, t)
    pipe._save_checkpoint({(0, -1): state1}, 1)
    want = {k: np.asarray(v.values)
            for k, v in state1.to_host().to_dataset().items()}

    # Second save crashes AFTER its bucket files hit disk but BEFORE the
    # manifest commit.
    j, offs2, (p2, t2) = next(stream)
    state2 = aggregation.AggregationState.sum(
        [state1.to_host(), pipe._evaluator.eval_chunk(p2, t2).to_host()])
    orig = pipeline_lib.fileio.write_text_atomic
    try:
      def crash(*a, **kw):
        raise RuntimeError('simulated preemption')
      pipeline_lib.fileio.write_text_atomic = crash
      with pytest.raises(RuntimeError):
        pipe._save_checkpoint({(0, -1): state2}, 2)
    finally:
      pipeline_lib.fileio.write_text_atomic = orig

    # A fresh pipeline resumes from checkpoint 1, bit-identically.
    fresh = self._mk(ckpt, pred_ds, tgt_ds, init_times, lead_times)
    buckets, next_chunk = fresh._load_checkpoint()
    assert next_chunk == 1
    got = {k: np.asarray(v.values)
           for k, v in buckets[(0, -1)].to_host().to_dataset().items()}
    assert set(got) == set(want)
    for k in want:
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class TestLoaderThreadSafety:
  def test_preprocessing_fn_applied_once_under_concurrency(self):
    import threading
    pred_ds, _, _, _ = _source_datasets(seed=13)
    calls = []

    def preprocess(ds):
      calls.append(1)
      return {k: v + 100.0 for k, v in ds.items()}

    loader = loaders.PredictionsFromDataset(
        ds=pred_ds, rename_dimensions=None, preprocessing_fn=preprocess)
    barrier = threading.Barrier(8)
    errors = []

    def prepare():
      try:
        barrier.wait()
        loader.maybe_prepare_dataset()
      except Exception as e:  # pragma: no cover
        errors.append(e)

    threads = [threading.Thread(target=prepare) for _ in range(8)]
    for th in threads:
      th.start()
    for th in threads:
      th.join()
    assert not errors
    assert len(calls) == 1, f'preprocessing_fn ran {len(calls)} times'
    # Values shifted exactly once.
    np.testing.assert_allclose(
        np.asarray(loader._ds['2m_temperature'].values),
        np.asarray(pred_ds['2m_temperature'].values) + 100.0)


class TestCrossUnitTimeLookups:
  def test_targets_valid_time_in_seconds_unit(self):
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets(seed=14)
    da = tgt_ds['2m_temperature']
    coarse = {'2m_temperature': da.assign_coords(
        valid_time=darray_coord(
            da.coords['valid_time'].dims,
            np.asarray(da.coords['valid_time'].values)
            .astype('datetime64[s]')))}
    want = loaders.TargetsFromDataset(
        ds=tgt_ds, rename_dimensions=None).load_chunk(
            init_times[:3], lead_times)['2m_temperature']
    got = loaders.TargetsFromDataset(
        ds=coarse, rename_dimensions=None).load_chunk(
            init_times[:3], lead_times)['2m_temperature']
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(want.values))


def darray_coord(dims, values):
  from weatherbenchx_tpu.darray import Coord
  return Coord(dims, values)


def test_restore_time_coords_covers_nonstandard_names():
  """Every coord _convert_chunk turned into int64 seconds must come back as
  datetime/timedelta — including non-canonical names like a sparse
  observation-time coordinate (evaluator.py registry)."""
  from weatherbenchx_tpu.darray import Coord

  pred_ds, tgt_ds, init_times, lead_times = _source_datasets(seed=15)
  da = pred_ds['2m_temperature']
  obs_times = (np.asarray(da.coords['init_time'].values)
               + np.timedelta64(37, 'm'))
  da = da.assign_coords(timeObs=Coord(('init_time',), obs_times))
  converted = evaluator_lib.prepare_chunk({'2m_temperature': da})
  out = evaluator_lib.restore_time_coords(converted['2m_temperature'])
  v = np.asarray(out.coords['timeObs'].values)
  assert v.dtype.kind == 'M', v.dtype
  np.testing.assert_array_equal(
      v, obs_times.astype('datetime64[s]').astype('datetime64[ns]'))


class _FlakyPredictions(loaders.PredictionsFromDataset):
  """Fault-injection loader: raises per-chunk according to a plan.

  ``plan`` maps a chunk's first init_time (as datetime64) to either an int
  N (fail the first N load attempts with OSError, then succeed) or the
  string 'always'/'keyerror' (never succeed). Attempt counts are shared
  across prefetch threads (GIL-atomic dict ops on distinct keys).
  """

  def __init__(self, plan, **kwargs):
    super().__init__(**kwargs)
    self._plan = dict(plan)
    self.attempts = {}

  def load_chunk(self, init_times, lead_times, reference=None):
    key = np.datetime64(init_times[0], 'ns')
    n = self.attempts.get(key, 0)
    self.attempts[key] = n + 1
    spec = self._plan.get(key)
    if spec == 'keyerror':
      raise KeyError(f'permanent bug for chunk at {key}')
    if spec == 'always':
      raise OSError(f'permanent transient-looking failure at {key}')
    if isinstance(spec, int) and n < spec:
      raise OSError(f'injected transient failure {n + 1}/{spec} at {key}')
    return super().load_chunk(init_times, lead_times, reference)


class TestRetryFaultInjection:
  """In-repo elasticity story (SURVEY §2.4 row 37).

  The reference delegates retries entirely to the Beam runner; here the
  policy is explicit: transient failures retry with backoff, opted-in
  skipping drops a permanently-failing chunk and reports it, and
  programming errors always fail fast.
  """

  def _run(self, plan, retry, tmp_path=None, out=False):
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets()
    agg = aggregation.Aggregator(reduce_dims=['latitude', 'longitude'])
    times = time_chunks_lib.TimeChunks(
        init_times, lead_times,
        init_time_chunk_size=4, lead_time_chunk_size=None)
    obs = __import__(
        'weatherbenchx_tpu.observability', fromlist=['Metrics']).Metrics()
    pipe = pipeline_lib.EvaluationPipeline(
        metrics=METRICS, aggregator=agg,
        predictions_loader=_FlakyPredictions(
            plan, ds=pred_ds, rename_dimensions=None),
        targets_loader=loaders.TargetsFromDataset(
            ds=tgt_ds, rename_dimensions=None),
        times=times, retry=retry, metrics_registry=obs)
    if out:
      out_path = str(tmp_path / 'metrics.npz')
      values = pipe.run_and_write(out_path=out_path)
      return pipe, obs, values, out_path
    return pipe, obs, pipe.run().metric_values(METRICS)

  def test_transient_failures_retried_result_exact(self):
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets()
    plan = {np.datetime64(init_times[0], 'ns'): 2,
            np.datetime64(init_times[8], 'ns'): 1}
    retry = pipeline_lib.RetryPolicy(retries=3, backoff_s=0.0)
    _, obs, values = self._run(plan, retry)
    _, _, clean = self._run({}, None)
    for k in clean:
      np.testing.assert_allclose(values[k].values, clean[k].values,
                                 atol=1e-6)
    assert obs.counters['load_retries'] == 3
    assert 'chunks_failed' not in obs.counters

  def test_exhausted_retries_raise_without_skip(self):
    pred_ds, tgt_ds, init_times, _ = _source_datasets()
    plan = {np.datetime64(init_times[4], 'ns'): 'always'}
    retry = pipeline_lib.RetryPolicy(retries=2, backoff_s=0.0)
    with pytest.raises(OSError, match='permanent'):
      self._run(plan, retry)

  def test_no_policy_fails_immediately(self):
    pred_ds, tgt_ds, init_times, _ = _source_datasets()
    plan = {np.datetime64(init_times[0], 'ns'): 1}
    with pytest.raises(OSError, match='injected'):
      self._run(plan, None)

  def test_skip_failed_drops_chunk_reports_and_writes_sidecar(self, tmp_path):
    pred_ds, tgt_ds, init_times, lead_times = _source_datasets()
    failing = np.datetime64(init_times[4], 'ns')
    plan = {failing: 'always'}
    retry = pipeline_lib.RetryPolicy(
        retries=1, backoff_s=0.0, skip_failed=True)
    pipe, obs, values, out_path = self._run(
        plan, retry, tmp_path=tmp_path, out=True)

    # Ground truth: direct computation over the surviving init_times only.
    keep = np.concatenate([init_times[:4], init_times[8:]])
    direct_preds = loaders.PredictionsFromDataset(
        ds=pred_ds, rename_dimensions=None).load_chunk(keep, lead_times)
    direct_tgts = loaders.TargetsFromDataset(
        ds=tgt_ds, rename_dimensions=None).load_chunk(keep, lead_times)
    agg = aggregation.Aggregator(reduce_dims=['latitude', 'longitude'])
    direct = aggregation.compute_metric_values_for_single_chunk(
        METRICS, agg, direct_preds, direct_tgts)
    for k, v in direct.items():
      got = values[k].sel(init_time=v.coord_values('init_time'))
      np.testing.assert_allclose(
          np.asarray(got.values, dtype=np.float64),
          np.asarray(v.values, dtype=np.float64), atol=1e-5)
    # The failed chunk's init_times are absent from the result.
    assert failing not in np.asarray(
        values['rmse.2m_temperature'].coord_values('init_time'))

    assert obs.counters['chunks_failed'] == 1
    assert obs.counters['load_retries'] == 1
    assert len(pipe.failed_chunks) == 1
    idx, offsets, err = pipe.failed_chunks[0]
    assert idx == 1 and 'OSError' in err

    import json as json_lib
    with open(out_path + '.failures.json') as f:
      sidecar = json_lib.load(f)
    assert len(sidecar) == 1 and sidecar[0]['chunk'] == 1
    assert 'OSError' in sidecar[0]['error']

  def test_programming_errors_never_skipped(self):
    pred_ds, tgt_ds, init_times, _ = _source_datasets()
    plan = {np.datetime64(init_times[0], 'ns'): 'keyerror'}
    retry = pipeline_lib.RetryPolicy(
        retries=3, backoff_s=0.0, skip_failed=True)
    with pytest.raises(KeyError, match='permanent bug'):
      self._run(plan, retry)
