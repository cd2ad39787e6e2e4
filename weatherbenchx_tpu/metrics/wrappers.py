"""Input-transform wrappers for statistics and metrics.

Reference semantics: ``weatherbenchX/metrics/wrappers.py:50-994``. Each
``InputTransform`` is a pure jnp function over DimArrays applied to
predictions and/or targets before a wrapped statistic; under jit the
transform fuses with the statistic and aggregation. Unique-name suffix
discipline matches the reference: every parameterized transform encodes its
parameters so statistic dedup stays sound.
"""

import abc
from typing import Any, Callable, Hashable, Iterable, Mapping, Sequence, Union

import jax.numpy as jnp
import numpy as np

from weatherbenchx_tpu import darray
from weatherbenchx_tpu import datetimes
from weatherbenchx_tpu.darray import Coord, DimArray
from weatherbenchx_tpu.metrics import base

Thresholds = Union[float, Iterable[float], DimArray, Mapping[str, DimArray]]


def _thresholds_for(thresholds: Thresholds, threshold_dim: str,
                    name: Hashable | None) -> DimArray:
  """Resolves thresholds to a DimArray (per-variable dict supported)."""
  if isinstance(thresholds, Mapping):
    assert name in thresholds, (
        f'Input variable name ({name}) not found in thresholds')
    t = thresholds[name]
    assert threshold_dim in t.dims, (
        f'threshold_dim ({threshold_dim}) not found in thresholds {t.dims}')
    return t
  if isinstance(thresholds, DimArray):
    assert threshold_dim in thresholds.dims, (
        f'threshold_dim ({threshold_dim}) not found in {thresholds.dims}')
    return thresholds
  t = np.asarray(list(thresholds) if isinstance(thresholds, Iterable)
                 else [thresholds], dtype=np.float64)
  return DimArray(t, (threshold_dim,), {threshold_dim: t})


def binarize_thresholds(
    x: DimArray,
    thresholds: Thresholds,
    threshold_dim: str,
    name: Hashable | None = None,
) -> DimArray:
  """(x > threshold) with NaNs retained, as float32.

  Reference ``wrappers.py:50-88``.
  """
  threshold = _thresholds_for(thresholds, threshold_dim, name)
  threshold_cmp = darray.comparison_safe_threshold(threshold, x.dtype, '>')
  return (x > threshold_cmp).where(~x.isnull()).astype(np.float32)


class InputTransform(abc.ABC):
  """Base class for input transformations."""

  def __init__(self, which: str):
    if which not in ['predictions', 'targets', 'both']:
      raise ValueError(f'Invalid value for `which`: {which}')
    self.which = which

  @property
  @abc.abstractmethod
  def unique_name_suffix(self) -> str:
    """Suffix identifying this transform and its parameters."""

  @abc.abstractmethod
  def transform_fn(self, da: DimArray,
                   name: Hashable | None = None) -> DimArray:
    """Function applied to predictions and/or targets arrays."""


class EnsembleMean(InputTransform):
  """Mean over the ensemble dimension."""

  def __init__(self, which: str, ensemble_dim: str = 'number',
               skipna: bool = False,
               skip_if_ensemble_dim_missing: bool = False):
    super().__init__(which)
    self._ensemble_dim = ensemble_dim
    self._skipna = skipna
    self._skip_if_ensemble_dim_missing = skip_if_ensemble_dim_missing

  @property
  def unique_name_suffix(self) -> str:
    # The 'self._'-prefixed key text is intentional: the reference builds this
    # suffix with f'..._{self._ensemble_dim=}_{self._skipna=}'
    # (wrappers.py:142-143), and saved AggregationState keys must match.
    return (f'ensemble_mean_self._ensemble_dim={self._ensemble_dim!r}_'
            f'self._skipna={self._skipna}')

  def transform_fn(self, da, name=None):
    if self._ensemble_dim not in da.dims and self._skip_if_ensemble_dim_missing:
      return da
    return da.mean(self._ensemble_dim, skipna=self._skipna)


class EnsembleQuantiles(InputTransform):
  """Ensemble quantiles (numpy 'linear' interpolation, like xarray)."""

  def __init__(self, which: str, quantiles: Union[float, Iterable[float]],
               quantile_dim: str = 'quantile', ensemble_dim: str = 'number',
               skipna: bool = False,
               skip_if_ensemble_dim_missing: bool = False):
    super().__init__(which)
    self._quantiles = (list(quantiles) if isinstance(quantiles, Iterable)
                       else [quantiles])
    self._quantile_dim = quantile_dim
    self._ensemble_dim = ensemble_dim
    self._skipna = skipna
    self._skip_if_ensemble_dim_missing = skip_if_ensemble_dim_missing

  @property
  def unique_name_suffix(self) -> str:
    quantiles_str = ','.join([str(q) for q in self._quantiles])
    return (f'ensemble_quantiles_{self._ensemble_dim}_{self._quantile_dim}_'
            f'{self._skipna}_{quantiles_str}')

  def transform_fn(self, da, name=None):
    if self._ensemble_dim not in da.dims and self._skip_if_ensemble_dim_missing:
      return da
    if self._quantile_dim in da.dims:
      raise ValueError(
          f'Input DimArray already has a {self._quantile_dim!r} dimension. '
          'Please rename it before applying the EnsembleQuantiles wrapper.')
    return da.quantile(self._quantiles, dim=self._ensemble_dim,
                       skipna=self._skipna, quantile_dim=self._quantile_dim)


class ContinuousToBinary(InputTransform):
  """x > threshold for each threshold, along a new threshold dim."""

  def __init__(self, which: str, threshold_value: Thresholds,
               threshold_dim: str, unique_name_suffix: str | None = None):
    super().__init__(which)
    self._threshold_value = (
        threshold_value
        if isinstance(threshold_value, (Iterable, DimArray, Mapping))
        else [threshold_value])
    self._threshold_dim = threshold_dim
    if isinstance(self._threshold_value, (DimArray, Mapping)):
      if unique_name_suffix is None:
        raise ValueError(
            'unique_name_suffix must be provided if threshold_value is a '
            'DimArray or Mapping.')
    self._unique_name_suffix = unique_name_suffix

  @property
  def unique_name_suffix(self) -> str:
    if self._unique_name_suffix is None:
      s = ','.join([str(t) for t in self._threshold_value])
    else:
      s = self._unique_name_suffix
    return f'{self._threshold_dim}={s}'

  def transform_fn(self, da, name=None):
    return binarize_thresholds(
        da, self._threshold_value, self._threshold_dim, name)


def select_bin_thresholds_by_time_from_chunk(
    bin_thresholds: DimArray,
    chunk: DimArray,
) -> DimArray:
  """Selects time-dependent bin thresholds at the chunk's times.

  Reference ``wrappers.py:270-330``. Requires host datetime coords on the
  chunk (notebook/single-chunk mode); in the jitted pipeline use
  climatology-style statistics, or run with retrace-per-chunk.
  """
  def host_coord(name):
    c = chunk.coords[name]
    v = np.asarray(c.values)
    if v.dtype.kind not in 'Mm':
      raise ValueError(
          'select_bin_thresholds_by_time_from_chunk requires host '
          f'datetime coords, got {v.dtype} for {name}.')
    return c.dims, v

  if {'init_time', 'lead_time'}.issubset(chunk.dims):
    if 'valid_time' in bin_thresholds.dims:
      _, init = host_coord('init_time')
      _, lead = host_coord('lead_time')
      vt = (init[:, None] + lead[None, :]).astype('datetime64[ns]')
      coord = bin_thresholds.coord_values('valid_time').astype(
          'datetime64[ns]').astype(np.int64)
      lookup = {int(v): i for i, v in enumerate(coord)}
      idx = np.vectorize(lambda t: lookup[int(t)])(vt.astype(np.int64))
      return bin_thresholds.take('valid_time', idx,
                                 ('init_time', 'lead_time'))
    elif {'init_time', 'lead_time'}.issubset(bin_thresholds.dims):
      return bin_thresholds.sel(
          init_time=host_coord('init_time')[1],
          lead_time=host_coord('lead_time')[1])
    elif {'dayofyear', 'lead_time'}.issubset(bin_thresholds.dims):
      _, init = host_coord('init_time')
      doy = datetimes.datetime_field(init, 'dayofyear')
      return bin_thresholds.sel(dayofyear=doy, lead_time=host_coord(
          'lead_time')[1]).rename({'dayofyear': 'init_time'})
    else:
      return bin_thresholds
  elif 'valid_time' in chunk.dims:
    if 'valid_time' in bin_thresholds.dims:
      return bin_thresholds.sel(valid_time=host_coord('valid_time')[1])
    elif 'dayofyear' in bin_thresholds.dims:
      _, vt = host_coord('valid_time')
      doy = datetimes.datetime_field(vt, 'dayofyear')
      return bin_thresholds.sel(dayofyear=doy).rename(
          {'dayofyear': 'valid_time'})
    else:
      return bin_thresholds
  else:
    return bin_thresholds


def compute_cdf(
    threshold_values: Thresholds,
    da: DimArray,
    threshold_dim: str,
    enforce_monotonicity: bool,
    right_inclusive: bool = True,
    name: Hashable | None = None,
) -> DimArray:
  """Empirical CDF indicator of ``da`` at each threshold.

  Reference ``wrappers.py:333-374``: NaNs in data or thresholds propagate.
  """
  if isinstance(threshold_values, (DimArray, Mapping)):
    thresholds = _thresholds_for(threshold_values, threshold_dim, name)
    thresholds = select_bin_thresholds_by_time_from_chunk(thresholds, da)
  elif isinstance(threshold_values, Iterable):
    t = np.asarray(list(threshold_values), dtype=np.float64)
    thresholds = DimArray(t, (threshold_dim,), {threshold_dim: t})
  else:
    raise ValueError(
        'Bin values must be an Iterable, DimArray, or Mapping.')
  if enforce_monotonicity:
    tvals = np.asarray(thresholds.values)
    ax = thresholds.dims.index(threshold_dim)
    if not np.all(np.diff(tvals, axis=ax) > 0):
      raise ValueError(
          'Bin values must be monotonically increasing. To turn off this'
          ' check, set `enforce_monotonicity=False`.')
  op = '<=' if right_inclusive else '<'
  thresholds_cmp = darray.comparison_safe_threshold(thresholds, da.dtype, op)
  if right_inclusive:
    cdf = (da <= thresholds_cmp).astype(np.float32)
  else:
    cdf = (da < thresholds_cmp).astype(np.float32)
  cdf = cdf.where(~da.isnull()).where(~thresholds.isnull())
  return cdf


class ContinuousToBins(InputTransform):
  """Bins a continuous input: CDF differences over right-inclusive bins.

  Reference ``wrappers.py:377-461``; adds ``{bin_dim}_left``/``_right``
  edge coords and human-readable bin labels.
  """

  def __init__(self, which: str, bin_values: Thresholds, bin_dim: str,
               unique_name_suffix: str | None = None,
               enforce_monotonicity: bool = True):
    super().__init__(which)
    self._bin_values = bin_values
    self._bin_dim = bin_dim
    if isinstance(bin_values, (DimArray, Mapping)):
      if unique_name_suffix is None:
        raise ValueError(
            'unique_name_suffix must be provided if bin_values is a '
            'DimArray or Mapping.')
    self._unique_name_suffix = unique_name_suffix
    self._enforce_monotonicity = enforce_monotonicity

  @property
  def unique_name_suffix(self) -> str:
    if self._unique_name_suffix is None:
      s = ','.join([str(t) for t in self._bin_values])
    else:
      s = self._unique_name_suffix
    return f'ContinuousToBins_{self._bin_dim}_{s}'

  def transform_fn(self, da, name=None):
    cdf = compute_cdf(
        threshold_values=self._bin_values, da=da,
        threshold_dim=self._bin_dim,
        enforce_monotonicity=self._enforce_monotonicity, name=name)
    edges = cdf.coord_values(self._bin_dim)
    left_edges, right_edges = edges[:-1], edges[1:]
    result = cdf.diff(self._bin_dim)
    bin_names = np.array([
        f'{left:.2f} < p <= {right:.2f}'
        for left, right in zip(left_edges, right_edges)])
    return result.assign_coords(**{
        self._bin_dim: Coord((self._bin_dim,), bin_names),
        f'{self._bin_dim}_left': Coord((self._bin_dim,), left_edges),
        f'{self._bin_dim}_right': Coord((self._bin_dim,), right_edges),
    })


class ContinuousToCDF(InputTransform):
  """CDF indicators of the input at each threshold (reference :464-531)."""

  def __init__(self, which: str, threshold_values: Thresholds,
               threshold_dim: str, unique_name_suffix: str | None = None,
               enforce_monotonicity: bool = True,
               right_inclusive: bool = True):
    super().__init__(which)
    self._threshold_values = threshold_values
    self._threshold_dim = threshold_dim
    if isinstance(threshold_values, (DimArray, Mapping)):
      if unique_name_suffix is None:
        raise ValueError(
            'unique_name_suffix must be provided if threshold_values is a '
            'DimArray or Mapping.')
    self._unique_name_suffix = unique_name_suffix
    self._enforce_monotonicity = enforce_monotonicity
    self._right_inclusive = right_inclusive

  @property
  def unique_name_suffix(self) -> str:
    if self._unique_name_suffix is None:
      s = ','.join([str(t) for t in self._threshold_values])
    else:
      s = self._unique_name_suffix
    return (f'ContinuousToCDF_{self._threshold_dim}_{s}_right_inclusive_'
            f'{self._right_inclusive}')

  def transform_fn(self, da, name=None):
    return compute_cdf(
        threshold_values=self._threshold_values, da=da,
        threshold_dim=self._threshold_dim,
        enforce_monotonicity=self._enforce_monotonicity,
        right_inclusive=self._right_inclusive, name=name)


class WeibullEnsembleToProbabilistic(InputTransform):
  """Binary ensemble → probability via Weibull plotting position Σ/(M+1).

  Reference ``wrappers.py:534-567``.
  """

  def __init__(self, which: str, ensemble_dim: str = 'number',
               skipna: bool = False):
    assert which == 'predictions', (
        'Only predictions can be converted to probabilities')
    super().__init__(which)
    self._ensemble_dim = ensemble_dim
    self._skipna = skipna

  @property
  def unique_name_suffix(self) -> str:
    return 'ensemble_to_probabilistic_by_weibull_plotting_position'

  def transform_fn(self, da, name=None):
    m = da.sizes[self._ensemble_dim]
    return da.sum(self._ensemble_dim, skipna=self._skipna) / (m + 1)


class Inline(InputTransform):
  """Transform with a user-provided function."""

  def __init__(self, which: str, transform_fn: Callable[[DimArray], DimArray],
               unique_name_suffix: str):
    super().__init__(which)
    self._transform_fn = transform_fn
    self._unique_name_suffix = unique_name_suffix

  @property
  def unique_name_suffix(self) -> str:
    return f'{self._unique_name_suffix}'

  def transform_fn(self, da, name=None):
    return self._transform_fn(da)


class ReLU(InputTransform):
  """max(x, 0), preserving NaNs."""

  @property
  def unique_name_suffix(self) -> str:
    return 'relu'

  def transform_fn(self, da, name=None):
    return darray.where(da > 0, da, 0).where(~da.isnull())


class ShiftAlongNewDim(InputTransform):
  """Adds shift values along a new dimension (reference :631-725)."""

  def __init__(self, which: str,
               shift_value: Union[float, Iterable[float], Mapping[str, DimArray]],
               shift_dim: str, unique_name_suffix: str):
    super().__init__(which)
    self._shift_value = (
        shift_value if isinstance(shift_value, (Iterable, Mapping))
        else [shift_value])
    self._shift_dim = shift_dim
    self._unique_name_suffix = unique_name_suffix

  @property
  def unique_name_suffix(self) -> str:
    return self._unique_name_suffix

  def transform_fn(self, da, name=None):
    if isinstance(self._shift_value, Mapping):
      shifts = self._shift_value[name]
      if self._shift_dim not in shifts.dims:
        raise RuntimeError(
            f'Expected to find shift_dim={self._shift_dim!r} in '
            f'{shifts.dims!r} but did not.')
    else:
      v = np.asarray(list(self._shift_value), dtype=np.float64)
      shifts = DimArray(v, (self._shift_dim,), {self._shift_dim: v})
    return da + shifts


class Rename(InputTransform):
  """Renames dims and coords."""

  def __init__(self, which: str, renames: Mapping[str, str]):
    super().__init__(which)
    self._renames = dict(renames)

  @property
  def unique_name_suffix(self) -> str:
    return f'rename_{self._renames}'

  def transform_fn(self, da, name=None):
    return da.rename(self._renames)


class Select(InputTransform):
  """Applies label (sel) and/or positional (isel) selection."""

  def __init__(self, which: str,
               sel: Mapping[str, Any] | None = None,
               isel: Mapping[str, Any] | None = None,
               sel_kwargs: Mapping[str, Any] | None = None,
               isel_kwargs: Mapping[str, Any] | None = None):
    super().__init__(which)
    self._sel = sel
    self._isel = isel
    self._sel_kwargs = dict(sel_kwargs or {})
    self._isel_kwargs = dict(isel_kwargs or {})

  @property
  def unique_name_suffix(self) -> str:
    return (f'select_self._isel={self._isel}_self._isel_kwargs='
            f'{self._isel_kwargs}_self._sel={self._sel}_self._sel_kwargs='
            f'{self._sel_kwargs}')

  def transform_fn(self, da, name=None):
    if self._sel is not None:
      da = da.sel(self._sel, **self._sel_kwargs)
    if self._isel is not None:
      da = da.isel(self._isel, **self._isel_kwargs)
    return da


class StackToNewDimension(InputTransform):
  """Stacks dims into a new range-valued dimension (reference :794-831)."""

  def __init__(self, which: str, dims_to_stack: Sequence[str],
               new_dim_name: str):
    super().__init__(which)
    self._dims_to_stack = tuple(dims_to_stack)
    self._new_dim_name = new_dim_name

  @property
  def unique_name_suffix(self) -> str:
    return f'stack_{self._dims_to_stack}_to_{self._new_dim_name}'

  def transform_fn(self, da, name=None):
    return da.stack_to_new_dim(self._dims_to_stack, self._new_dim_name)


class WrappedStatistic(base.Statistic):
  """Wraps a statistic with one input transform (name-suffixing)."""

  def __init__(self, statistic: base.Statistic, transform: InputTransform):
    self.statistic = statistic
    self.transform = transform

  @property
  def unique_name(self) -> str:
    return (f'{self.statistic.unique_name}_{self.transform.which}_'
            f'{self.transform.unique_name_suffix}')

  def prepare_chunk(self, predictions, targets):
    return self.statistic.prepare_chunk(predictions, targets)

  def compute(self, predictions, targets):
    if self.transform.which in ('predictions', 'both'):
      predictions = {
          k: self.transform.transform_fn(v, k)
          for k, v in predictions.items()}
    if self.transform.which in ('targets', 'both'):
      targets = {
          k: self.transform.transform_fn(v, k) for k, v in targets.items()}
    return self.statistic.compute(predictions, targets)


class RenamedStatistic(base.Statistic):
  """Wraps a statistic with a new unique name."""

  def __init__(self, statistic: base.Statistic, unique_name: str):
    self._statistic = statistic
    self._unique_name = unique_name

  @property
  def unique_name(self) -> str:
    return self._unique_name

  def prepare_chunk(self, predictions, targets):
    return self._statistic.prepare_chunk(predictions, targets)

  def compute(self, predictions, targets):
    return self._statistic.compute(predictions, targets)


class WrappedMetric(base.Metric):
  """Wraps all statistics of a metric with a list of input transforms.

  Transforms [f, g, h] apply as h(g(f(x))) (reference ``wrappers.py:892-936``).
  """

  def __init__(self, metric: base.Metric,
               transforms: Sequence[InputTransform],
               unique_name_suffix: str | None = None):
    self.metric = metric
    self.transforms = list(transforms)
    self.unique_name_suffix = unique_name_suffix

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    stats = {}
    for stat_name, stat in self.metric.statistics.items():
      original_name = stat.unique_name
      for wrapper in self.transforms[::-1]:
        stat = WrappedStatistic(stat, wrapper)
      if self.unique_name_suffix is not None:
        stat = RenamedStatistic(
            stat, f'{original_name}_{self.unique_name_suffix}')
      stats[stat_name] = stat
    return stats

  def values_from_mean_statistics(self, statistic_values):
    return self.metric.values_from_mean_statistics(statistic_values)


class SubselectVariablesForStatistic(base.Statistic):
  """Computes a statistic only for a subset of variables."""

  def __init__(self, statistic: base.Statistic, variables: Sequence[str]):
    self.statistic = statistic
    self.variables = list(variables)

  @property
  def unique_name(self) -> str:
    return f"{self.statistic.unique_name}_{'_'.join(self.variables)}"

  def prepare_chunk(self, predictions, targets):
    return self.statistic.prepare_chunk(predictions, targets)

  def compute(self, predictions, targets):
    predictions = {k: v for k, v in predictions.items()
                   if k in self.variables}
    targets = {k: v for k, v in targets.items() if k in self.variables}
    return self.statistic.compute(predictions, targets)


class SubselectVariables(base.Metric):
  """Computes a metric only for a subset of variables."""

  def __init__(self, metric: base.Metric, variables: Sequence[str]):
    self.metric = metric
    self.variables = list(variables)

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {
        name: SubselectVariablesForStatistic(stat, self.variables)
        for name, stat in self.metric.statistics.items()}

  def values_from_mean_statistics(self, statistic_values):
    return self.metric.values_from_mean_statistics(statistic_values)
