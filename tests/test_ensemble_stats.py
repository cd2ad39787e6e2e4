"""Tests for the fused ensemble-statistics kernel (``ops/ensemble_stats.py``).

The kernel runs here through the Pallas interpreter and is compared with
the float64 numpy reference in ``test_utils`` (shared with
``chip_smoke.py``, which runs the same comparison on the card). Tolerances:
float32 sums of up to 51 members (≲ 51·2⁻²⁴ relative), bfloat16 inputs
(rounded once on the way in, so the reference takes the rounded values)
and bfloat16 outputs (2⁻⁸ relative).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from weatherbenchx_tpu import test_utils
from weatherbenchx_tpu.darray import Coord, DimArray
from weatherbenchx_tpu.metrics import base as mbase
from weatherbenchx_tpu.metrics import probabilistic
from weatherbenchx_tpu.ops import ensemble_stats

BLOCK = ensemble_stats.BLOCK
MEMBERS = (2, 3, 5, 8, 16, 20, 21, 32, 50, 51)
# (data shape, how its gridpoint count N sits against BLOCK)
SHAPES = {
    'n_below_block_1d': (BLOCK - 27,),
    'n_at_blocks_2d': (4, BLOCK // 2),
    'n_off_blocks_3d': (2, 3, BLOCK // 2 + 5),
}
NAMES = ('spread_sum', 'skill_sum', 'mean', 'sq_dev_sum')


def _data(m, shape, dtype, seed=0, offset=0.0):
  rng = np.random.default_rng(seed)
  x = (rng.standard_normal((m,) + shape) * 3 + offset).astype(dtype)
  y = (rng.standard_normal(shape) * 3 + offset).astype(dtype)
  return x, y


def _kernel(x, y):
  return ensemble_stats.fused_ensemble_stats(
      jnp.asarray(x), jnp.asarray(y), interpret=True)


def _assert_close(got, want, rtol, label=''):
  for name, g, w in zip(NAMES, got, want):
    g = np.asarray(g, np.float64)
    assert g.shape == w.shape, (label, name)
    assert np.array_equal(np.isnan(g), np.isnan(w)), (label, name)
    ok = ~np.isnan(w)
    # Relative error, floored at a tenth of the array's largest magnitude
    # (a mean of zero-centred members sits near zero).
    scale = np.maximum(np.abs(w[ok]), 0.1 * np.max(np.abs(w[ok]), initial=1))
    err = np.max(np.abs(g[ok] - w[ok]) / scale, initial=0.0)
    assert err <= rtol, (label, name, err)


class TestKernelAgainstFloat64:

  @pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
  @pytest.mark.parametrize('shape', list(SHAPES), ids=list(SHAPES))
  @pytest.mark.parametrize('m', MEMBERS)
  def test_matches_reference(self, m, shape, dtype):
    np_dtype = jnp.dtype(dtype)
    x, y = _data(m, SHAPES[shape], np.float32, seed=m, offset=280.0)
    x, y = x.astype(np_dtype), y.astype(np_dtype)
    got = _kernel(x, y)
    assert all(g.dtype == np_dtype for g in got)
    want = test_utils.reference_ensemble_stats(x.astype(np.float32),
                                               y.astype(np.float32))
    _assert_close(got, want, 2e-6 if dtype == 'float32' else 1e-2,
                  (m, shape, dtype))

  @pytest.mark.parametrize('m,pos', [(m, p) for m in (8, 21)
                                     for p in range(m)])
  def test_nan_in_any_member_poisons_only_its_gridpoint(self, m, pos):
    x, y = _data(m, (3, BLOCK + 9), np.float32, seed=pos)
    x[pos, 1, 7] = np.nan
    x[(pos + 1) % m, 2, BLOCK + 3] = np.nan
    got = [np.asarray(g) for g in _kernel(x, y)]
    for name, g in zip(NAMES, got):
      assert np.isnan(g[1, 7]) and np.isnan(g[2, BLOCK + 3]), name
      assert np.isnan(g).sum() == 2, name
    _assert_close(got, test_utils.reference_ensemble_stats(x, y), 2e-6)

  def test_nan_target_poisons_only_the_skill(self):
    x, y = _data(5, (BLOCK,), np.float32)
    y[3] = np.nan
    spread, skill, mean, sqdev = (np.asarray(g) for g in _kernel(x, y))
    assert np.isnan(skill[3]) and np.isnan(skill).sum() == 1
    for g in (spread, mean, sqdev):
      assert not np.isnan(g).any()

  def test_large_offset_keeps_precision(self):
    # |mean| = 1000 std (temperature is ~60 std): the moments and the
    # spread are taken on centred rows.
    x, y = _data(50, (2, BLOCK), np.float32, seed=3, offset=3e3)
    _assert_close(_kernel(x, y), test_utils.reference_ensemble_stats(x, y),
                  2e-6)


class TestReference:

  @pytest.mark.parametrize('m', [2, 7, 50])
  def test_sort_identity_matches_pair_sum(self, m):
    x, y = _data(m, (4, 6), np.float64, seed=m)
    spread, skill, mean, sqdev = test_utils.reference_ensemble_stats(x, y)
    np.testing.assert_allclose(
        spread, np.abs(x[:, None] - x[None]).sum((0, 1)), rtol=1e-12)
    np.testing.assert_allclose(skill, np.abs(x - y).sum(0), rtol=1e-12)
    np.testing.assert_allclose(sqdev, x.var(0) * m, rtol=1e-12)
    np.testing.assert_allclose(mean, x.mean(0), rtol=1e-12)


class TestSelection:

  @pytest.mark.parametrize('backend,expected', [
      ('gpu', ensemble_stats.fused_ensemble_stats), ('cpu', None)])
  def test_kernel_for_backend(self, backend, expected):
    assert ensemble_stats.kernel_for(backend) is expected

  @pytest.mark.parametrize('m,ndims,dtype,ok', [
      (2, 1, jnp.float32, True), (50, 4, jnp.bfloat16, True),
      (1, 3, jnp.float32, False), (50, 0, jnp.float32, False),
      (50, 3, jnp.float64, False), (50, 3, jnp.float16, False)])
  def test_applies(self, m, ndims, dtype, ok):
    assert ensemble_stats.applies(m, ndims, dtype) is ok

  def test_cpu_compute_pass_takes_plain_forms(self):
    x, y = _data(4, (3, 5), np.float32)
    dims = ('lead_time', 'latitude')
    with mbase.computation_cache():
      assert probabilistic._fused_ensemble_pass(
          DimArray(x, ('number',) + dims), DimArray(y, dims),
          'number') is None

  @pytest.mark.parametrize('x_shape,y_shape,dtype,match', [
      ((4, 3, 5), (3, 6), np.float32, 'does not match'),
      ((4, 3, 5), (4, 3, 5), np.float32, 'does not match'),
      ((1, 3, 5), (3, 5), np.float32, 'unsupported'),
      ((4, 3, 5), (3, 5), np.float64, 'unsupported')])
  def test_rejects_bad_inputs(self, x_shape, y_shape, dtype, match):
    with pytest.raises(ValueError, match=match):
      ensemble_stats.fused_ensemble_stats(
          np.zeros(x_shape, dtype), np.zeros(y_shape, dtype), interpret=True)


class TestSharding:
  """The partition rule on the 8-device CPU mesh: any data axis shards,
  the member axis is gathered, the outputs keep the data sharding."""

  @pytest.mark.parametrize('explicit', [False, True])
  @pytest.mark.parametrize('x_spec', [
      (None, 'a', None, 'b'),   # the evaluator's layout: members together
      ('a', None, None, 'b'),   # member axis sharded: gathered by the rule
      (None, None, 'a', None),  # one data axis over two devices
  ])
  def test_sharded_matches_reference(self, x_spec, explicit):
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    types = (AxisType.Explicit if explicit else AxisType.Auto,) * 2
    mesh = jax.make_mesh((2, 4), ('a', 'b'), axis_types=types)
    x, y = _data(6, (4, 6, 32), np.float32, seed=1)
    y_spec = tuple(a if a != x_spec[0] else None for a in x_spec[1:])
    xd = jax.device_put(x, NamedSharding(mesh, P(*x_spec)))
    yd = jax.device_put(y, NamedSharding(mesh, P(*y_spec)))
    got = jax.jit(functools.partial(ensemble_stats.fused_ensemble_stats,
                                    interpret=True))(xd, yd)
    _assert_close(got, test_utils.reference_ensemble_stats(x, y), 2e-6)
    norm = lambda spec: tuple(spec) + (None,) * (3 - len(tuple(spec)))
    for g in got:
      assert norm(g.sharding.spec) == norm(y_spec), g.sharding


@pytest.mark.gpu
def test_compiled_kernel_on_gpu_matches_reference():
  if jax.default_backend() != 'gpu':
    pytest.skip('needs a GPU; chip_smoke.py runs this check on the card')
  x, y = _data(50, (1, 4, 721, 1440), np.float32, offset=288.0)
  got = ensemble_stats.fused_ensemble_stats(x, y)
  _assert_close(got, test_utils.reference_ensemble_stats(x, y), 1e-5)


class TestPlainEnsembleForms:
  """The jnp forms every backend without the kernel runs."""

  @pytest.mark.parametrize('mx,my', [(1, 1), (3, 5), (8, 2), (25, 25)])
  def test_cross_skill_matches_brute_force(self, mx, my):
    rng = np.random.default_rng(mx * 100 + my)
    dims = ('number', 'lead_time', 'latitude', 'longitude')
    x = rng.normal(size=(mx, 2, 9, 14)).astype(np.float32)
    y = rng.normal(size=(my, 2, 9, 14)).astype(np.float32)
    out = probabilistic.CRPSSkill()._compute_per_variable(
        DimArray(x, dims, {'number': np.arange(mx)}),
        DimArray(y, dims, {'number': np.arange(my)}))
    assert out.dims == dims[1:]
    want = np.abs(x[:, None].astype(np.float64) - y[None]).mean((0, 1))
    np.testing.assert_allclose(np.asarray(out.values), want, rtol=2e-6)

  def test_cross_skill_keeps_target_mask_coord(self):
    rng = np.random.default_rng(0)
    dims = ('number', 'lead_time', 'latitude', 'longitude')
    mask = Coord(('latitude', 'longitude'), rng.random((4, 5)) > 0.5)
    pred = DimArray(rng.normal(size=(3, 2, 4, 5)).astype(np.float32), dims,
                    {'number': np.arange(3)})
    tgt = DimArray(rng.normal(size=(2, 2, 4, 5)).astype(np.float32), dims,
                   {'number': np.arange(2), 'mask': mask})
    out = probabilistic.CRPSSkill()._compute_per_variable(pred, tgt)
    np.testing.assert_array_equal(np.asarray(out.coords['mask'].values),
                                  np.asarray(mask.values))

  @pytest.mark.parametrize('fair', [True, False])
  @pytest.mark.parametrize('which', ['predictions', 'targets'])
  def test_spread_sort_and_pair_forms_agree(self, fair, which):
    rng = np.random.default_rng(0)
    dims = ('number', 'lead_time', 'latitude', 'longitude')
    pred = DimArray(rng.normal(size=(7, 3, 8, 10)).astype(np.float32), dims,
                    {'number': np.arange(7)})
    tgt = DimArray(rng.normal(size=(6, 3, 8, 10)).astype(np.float32), dims,
                   {'number': np.arange(6)})
    x = np.asarray((pred if which == 'predictions' else tgt).values,
                   np.float64)
    m = x.shape[0]
    want = np.abs(x[:, None] - x[None]).sum((0, 1)) / (m * (m - int(fair)))
    for use_sort in (True, False):
      stat = probabilistic.CRPSSpread(use_sort=use_sort, fair=fair,
                                      which=which)
      got = stat._compute_per_variable(pred, tgt)
      assert got.dims == dims[1:]
      np.testing.assert_allclose(np.asarray(got.values), want, rtol=2e-6)
