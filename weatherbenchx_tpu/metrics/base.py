"""The Metric/Statistic contract.

Mirrors the semantics of the reference's ``weatherbenchX/metrics/base.py``:

* A ``Statistic`` maps a (predictions, targets) chunk — each a
  ``dict[var, DimArray]`` — to per-variable statistic arrays
  (``metrics/base.py:85-158`` in the reference).
* A ``Metric`` names the statistics it needs and finalizes their
  (weighted) *means* via ``values_from_mean_statistics``
  (``metrics/base.py:23-82``).
* Statistics are deduplicated across metrics by ``unique_name``
  (``metrics/base.py:120-133, 252-291``).

Difference from the reference: statistics here are pure jnp functions of DimArrays,
so the whole stats→aggregate step jits into a single XLA program per chunk;
there is no generator-based streaming (the fused aggregation never
materializes per-point statistics in HBM unless asked to).
"""

import abc
import contextlib
import threading
from typing import Any, Hashable, Iterator, Mapping, final

import numpy as np

from weatherbenchx_tpu import datetimes
from weatherbenchx_tpu.darray import Coord, DimArray

# -- device resources ---------------------------------------------------------
# Large arrays a statistic holds for its whole lifetime (climatologies) must
# not be embedded into jitted programs as trace-time constants: at 0.25° a
# dayofyear×hour climatology is >100 MB per variable, which bloats every
# compiled program (and oversizes remote-compile payloads). Instead the
# evaluator uploads them ONCE and passes them into the jitted step as
# arguments; while tracing, this registry maps the statistic's host array
# (by object identity) to the traced argument.

_ACTIVE_RESOURCES = threading.local()


def resource_id(da: DimArray) -> str:
  return f'r{id(da)}'


@contextlib.contextmanager
def device_resources(mapping: Mapping[str, Any] | None):
  """Activates a {resource_id: traced array} mapping for the current trace."""
  prev = getattr(_ACTIVE_RESOURCES, 'mapping', None)
  _ACTIVE_RESOURCES.mapping = mapping
  try:
    yield
  finally:
    _ACTIVE_RESOURCES.mapping = prev


def resolve_resource(da: DimArray) -> DimArray:
  """The traced-argument view of a long-lived host array, if active."""
  m = getattr(_ACTIVE_RESOURCES, 'mapping', None)
  if m:
    hit = m.get(resource_id(da))
    if hit is not None:
      return DimArray(hit, da.dims, da.coords)
  return da


class Metric(abc.ABC):
  """Abstract base class for metrics.

  A Metric = a set of named Statistics + a finalizer over their means.
  The aggregation (weighting/binning/masking) between the two is chosen
  independently via ``aggregation.Aggregator``.
  """

  @property
  @abc.abstractmethod
  def statistics(self) -> Mapping[str, 'Statistic']:
    """Statistics whose mean values are required to compute the metric."""

  @abc.abstractmethod
  def values_from_mean_statistics(
      self,
      statistic_values: Mapping[str, Mapping[Hashable, DimArray]],
  ) -> Mapping[Hashable, DimArray]:
    """Computes metric values from mean statistics, keyed by internal name."""


class Statistic(Metric):
  """A per-chunk function of (predictions, targets), aggregated by mean.

  Must define a ``unique_name`` capturing all parameters that affect its
  value — deduplication and AggregationState keys rely on it.

  A Statistic is itself a Metric whose finalizer is the identity on the
  statistic's mean.
  """

  @property
  def unique_name(self) -> str:
    return type(self).__name__

  @abc.abstractmethod
  def compute(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> Mapping[Hashable, DimArray]:
    """Computes statistic values for a predictions/targets chunk."""

  def _dedup_identity(self) -> Mapping[str, Any]:
    """State compared when another statistic claims the same unique_name.

    Override to exclude parameters that select only the algorithm, not the
    value (e.g. ``CRPSSpread.use_sort``), so equivalent instances still
    deduplicate.
    """
    return vars(self)

  def prepare_chunk(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> tuple[Mapping[Hashable, DimArray], Mapping[Hashable, DimArray]]:
    """Host-side hook run by the pipeline BEFORE the jit boundary.

    Statistics needing host-only information that varies per chunk (e.g.
    datetime coords for climatology alignment) override this to precompute
    device-friendly auxiliary coords (traced leaves), so their ``compute``
    stays retrace-free inside the jitted step. Default: no-op.
    """
    return predictions, targets

  @final
  @property
  def statistics(self) -> Mapping[str, 'Statistic']:
    return {'self': self}

  @final
  def values_from_mean_statistics(
      self,
      statistic_values: Mapping[str, Mapping[Hashable, DimArray]],
  ) -> Mapping[Hashable, DimArray]:
    return statistic_values['self']


class PerVariableStatistic(Statistic):
  """Statistic computed independently for each common variable."""

  @final
  def compute(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> Mapping[Hashable, DimArray]:
    result = {}
    for var_name in predictions.keys():
      if var_name in targets.keys():
        per_var = self._compute_per_variable(
            predictions[var_name], targets[var_name])
        if per_var is not None:
          result[var_name] = per_var
    return result

  @abc.abstractmethod
  def _compute_per_variable(
      self,
      predictions: DimArray,
      targets: DimArray,
  ) -> DimArray | None:
    """Computes statistic for one variable, or None if undefined for it."""


class PerVariableMetric(Metric):
  """Metric computed independently for each variable common to all stats."""

  @final
  def values_from_mean_statistics(
      self,
      statistic_values: Mapping[str, Mapping[Hashable, DimArray]],
  ) -> Mapping[Hashable, DimArray]:
    common_variables = set.intersection(
        *[set(statistic_values[s]) for s in self.statistics])
    values = {}
    for v in sorted(common_variables, key=str):
      stats_per_variable = {
          s: statistic_values[s][v] for s in self.statistics}
      values[v] = self._values_from_mean_statistics_per_variable(
          stats_per_variable)
    return values

  @abc.abstractmethod
  def _values_from_mean_statistics_per_variable(
      self,
      statistic_values: Mapping[str, DimArray],
  ) -> DimArray:
    """Compute metric value for a single variable."""


# Deprecated backwards-compatibility shim: a Statistic implements Metric
# directly (reference ``metrics/base.py:246-249``).
NoOpMetric = lambda statistic: statistic


def _provably_different(a: Any, b: Any, _depth: int = 0) -> bool:
  """True when two parameter values are demonstrably unequal.

  Conservative: unknown/opaque values (callables, device arrays, tracers)
  compare as equal so the collision guard below never raises spuriously.
  """
  if a is b or _depth > 8:
    return False
  if type(a) is not type(b):
    return True
  if isinstance(a, (bool, int, float, complex, str, bytes)) or a is None:
    return a != b
  if isinstance(a, np.ndarray):
    if a.shape != b.shape or a.dtype != b.dtype:
      return True
    if np.array_equal(a, b):
      return False
    if a.dtype.kind == 'f' and np.array_equal(a, b, equal_nan=True):
      return False
    return True
  if isinstance(a, (list, tuple)):
    return (len(a) != len(b)
            or any(_provably_different(x, y, _depth + 1)
                   for x, y in zip(a, b)))
  if isinstance(a, dict):
    return (set(a) != set(b)
            or any(_provably_different(a[k], b[k], _depth + 1) for k in a))
  if isinstance(a, Coord):
    return (a.dims != b.dims
            or _provably_different(a.values, b.values, _depth + 1))
  if isinstance(a, DimArray):
    if a.dims != b.dims:
      return True
    if isinstance(a.data, np.ndarray) and isinstance(b.data, np.ndarray):
      return _provably_different(a.data, b.data, _depth + 1)
    return False  # device/tracer payloads: not provable
  if isinstance(a, Statistic):
    return _provably_different(a._dedup_identity(), b._dedup_identity(),
                               _depth + 1)
  if hasattr(a, '__dict__'):
    # Metrics, input transforms: compare constructor state.
    return _provably_different(vars(a), vars(b), _depth + 1)
  return False


def unique_statistics_for_metrics(
    metrics: Mapping[str, Metric]) -> Mapping[str, 'Statistic']:
  """Deduplicates statistics across metrics by unique_name, loudly.

  The reference deduplicates silently (``metrics/base.py:252-269``), so two
  statistics that share a unique_name but differ in value-affecting
  parameters (e.g. ``ErrorExceedance`` with different thresholds, which has
  no parameter-encoding unique_name upstream either) silently compute only
  one of them. Here that is an error instead.
  """
  out: dict[str, Statistic] = {}
  for m in metrics.values():
    for stat in m.statistics.values():
      prev = out.get(stat.unique_name)
      if prev is not None and _provably_different(prev, stat):
        raise ValueError(
            f'Two statistics with different parameters share the unique_name '
            f'{stat.unique_name!r} ({type(prev).__name__} vs '
            f'{type(stat).__name__}). Statistics are deduplicated across '
            f'metrics by unique_name, so only one of them would be computed. '
            f'Disambiguate them, e.g. with wrappers.RenamedStatistic or a '
            f'unique_name_suffix parameter.')
      out[stat.unique_name] = stat
  return out


_ACTIVE_COMPUTE_CACHE = threading.local()


@contextlib.contextmanager
def computation_cache():
  """A per-evaluation memo shared by the statistics of one compute pass.

  Statistics whose values derive from one fused computation (e.g. the
  CRPS skill/spread + ensemble moments kernel pass,
  ``ops/ensemble_stats.fused_ensemble_stats``) store it here keyed by
  their input array identities, so sibling statistics in the same pass
  reuse it instead of re-reading the ensemble from device memory. Scoped strictly
  to one compute_unique_statistics_for_all_metrics call — entries may
  hold tracers, which must never outlive their trace.
  """
  prev = getattr(_ACTIVE_COMPUTE_CACHE, 'cache', None)
  _ACTIVE_COMPUTE_CACHE.cache = {}
  try:
    yield
  finally:
    _ACTIVE_COMPUTE_CACHE.cache = prev


def get_computation_cache() -> dict | None:
  """The active per-evaluation memo, or None outside a compute pass."""
  return getattr(_ACTIVE_COMPUTE_CACHE, 'cache', None)


def generate_unique_statistics_for_all_metrics(
    metrics: Mapping[str, Metric],
    predictions: Mapping[Hashable, DimArray],
    targets: Mapping[Hashable, DimArray],
) -> Iterator[tuple[str, Mapping[Hashable, DimArray]]]:
  """Yields (unique_name, values) for each deduplicated statistic."""
  unique_statistics = unique_statistics_for_metrics(metrics)

  def strip_gathered(values):
    # Pre-gathered climatology slices (CLIM_VALUE_PREFIX coords, chunk-
    # sized) propagate through arithmetic like any coord; once statistics
    # are computed they are dead weight — and would bloat unaggregated
    # sinks — so drop them from the outputs here.
    out = {}
    for var, da in values.items():
      names = [n for n in da.coords if str(n).startswith(CLIM_VALUE_PREFIX)]
      out[var] = da.drop_coords(names) if names else da
    return out

  with computation_cache():
    for k, stat in unique_statistics.items():
      try:
        yield k, strip_gathered(stat.compute(predictions, targets))
      except Exception as e:
        raise ValueError(f'Failed to compute statistic {k}={stat}') from e


def compute_unique_statistics_for_all_metrics(
    metrics: Mapping[str, Metric],
    predictions: Mapping[Hashable, DimArray],
    targets: Mapping[Hashable, DimArray],
) -> Mapping[str, Mapping[Hashable, DimArray]]:
  """Computes deduplicated statistics for all metrics."""
  return dict(generate_unique_statistics_for_all_metrics(
      metrics, predictions, targets))


def compute_metric_from_statistics(
    metric: Metric,
    statistic_values: Mapping[str, Mapping[Hashable, DimArray]],
) -> Mapping[Hashable, DimArray]:
  """Computes a metric from mean statistics keyed by unique_name."""
  statistic_values = {
      k: statistic_values[v.unique_name]
      for k, v in metric.statistics.items()
  }
  return metric.values_from_mean_statistics(statistic_values)


def compute_metrics_from_statistics(
    metrics: Mapping[str, Metric],
    statistic_values: Mapping[str, Mapping[Hashable, DimArray]],
) -> Mapping[str, Mapping[Hashable, DimArray]]:
  """Computes multiple metrics from mean statistics keyed by unique_name."""
  return {
      name: compute_metric_from_statistics(metric, statistic_values)
      for name, metric in metrics.items()
  }


# ---------------------------------------------------------------------------
# Climatology-aligned statistics
# ---------------------------------------------------------------------------


def valid_time_coord(da: DimArray) -> tuple[tuple[str, ...], np.ndarray]:
  """Host valid_time (dims, datetime64 values) from coords.

  Mirrors reference ``metrics/base.py:383-394``: either an explicit
  ``valid_time`` coord, or the broadcast sum of init_time and lead_time.
  """
  if da.has_coord('valid_time'):
    c = da.coords['valid_time']
    return c.dims, np.asarray(c.values)
  if da.has_coord('init_time') and da.has_coord('lead_time'):
    init = da.coords['init_time']
    lead = da.coords['lead_time']
    init_v = np.asarray(init.values)
    lead_v = np.asarray(lead.values)
    dims = tuple(init.dims) + tuple(d for d in lead.dims if d not in init.dims)
    shape_map = {}
    for d, s in zip(init.dims, init_v.shape):
      shape_map[d] = s
    for d, s in zip(lead.dims, lead_v.shape):
      shape_map[d] = s
    full_shape = tuple(shape_map[d] for d in dims)

    def expand(vals, vdims):
      idx = tuple(slice(None) if d in vdims else None for d in dims)
      # Transpose vals dims into order of `dims` first.
      order = [vdims.index(d) for d in dims if d in vdims]
      v = np.transpose(vals, order) if order != list(range(len(vdims))) else vals
      return np.broadcast_to(v[idx if len(idx) else ...], full_shape) \
          if idx else v

    iv = expand(init_v, tuple(init.dims))
    lv = expand(lead_v, tuple(lead.dims))
    return dims, (iv + lv).astype('datetime64[ns]')
  raise ValueError(
      'Predictions should have either valid_time or init/lead_time coords.')


def climatology_alignment_indices(
    clim: DimArray,
    valid_time: np.ndarray,
) -> dict[str, np.ndarray]:
  """Host-side indices aligning a climatology to given valid times.

  The climatology has either a ``time`` dim, a ``dayofyear`` dim, or
  ``dayofyear`` + ``hour`` dims (reference ``metrics/base.py:396-403``).
  Returns a dict of {clim_dim: integer index array of valid_time's shape}.
  """
  vt = np.asarray(valid_time).reshape(-1).astype('datetime64[ns]')
  out: dict[str, np.ndarray] = {}
  if 'time' in clim.dims:
    coord = np.asarray(clim.coords['time'].values)
    lookup = {v: i for i, v in enumerate(coord)}
    idx = np.array([lookup[t] for t in vt])
    out['time'] = idx.reshape(valid_time.shape)
    return out
  doy_coord = np.asarray(clim.coords['dayofyear'].values)
  doy_lookup = {int(v): i for i, v in enumerate(doy_coord)}
  out['dayofyear'] = np.array(
      [doy_lookup[int(d)] for d in datetimes.datetime_field(vt, 'dayofyear')]
  ).reshape(valid_time.shape)
  if 'hour' in clim.dims:
    hour_coord = np.asarray(clim.coords['hour'].values)
    hour_lookup = {int(v): i for i, v in enumerate(hour_coord)}
    out['hour'] = np.array(
        [hour_lookup[int(h)] for h in datetimes.datetime_field(vt, 'hour')]
    ).reshape(valid_time.shape)
  return out


def align_climatology(
    clim: DimArray,
    predictions: DimArray,
) -> DimArray:
  """Gather climatology values at each prediction valid_time.

  Result has the valid_time dims in place of the climatology's time dims,
  retaining other (spatial) dims. The gather indices are computed host-side
  from static time coords and lowered as constants; the gather itself runs
  on device so this is jit-compatible.
  """
  vt_dims, vt = valid_time_coord(predictions)
  idx = climatology_alignment_indices(clim, vt)
  return gather_climatology(clim, idx, vt_dims)


def gather_climatology(
    clim: DimArray,
    indices: Mapping[str, Any],
    out_dims: tuple[str, ...],
) -> DimArray:
  """Gather of climatology at precomputed time indices.

  Indices may be host numpy (computed at trace time from static coords) or
  device/traced int arrays (precomputed by the pipeline and passed as
  leaves, so per-chunk time changes never retrace).
  """
  import jax.numpy as jnp

  data = jnp.asarray(clim.data)
  clim_dims = clim.dims
  time_dims = [d for d in clim_dims if d in indices]
  other_dims = [d for d in clim_dims if d not in indices]
  # Move time dims to front.
  order = [clim_dims.index(d) for d in time_dims + other_dims]
  data = jnp.transpose(data, order)
  tshape = data.shape[:len(time_dims)]
  data = data.reshape((-1,) + data.shape[len(time_dims):])
  # Flatten multi-axis time index into one.
  on_host = all(isinstance(indices[d], np.ndarray) for d in time_dims)
  xp = np if on_host else jnp
  first = indices[time_dims[0]]
  flat_idx = xp.zeros(first.shape, dtype=xp.int64 if on_host else jnp.int32)
  stride = 1
  for d, s in zip(reversed(time_dims), reversed(tshape)):
    flat_idx = flat_idx + xp.asarray(indices[d]) * stride
    stride *= s
  gathered = jnp.take(data, jnp.asarray(flat_idx).reshape(-1), axis=0)
  gathered = gathered.reshape(tuple(first.shape) + data.shape[1:])
  dims = tuple(out_dims) + tuple(other_dims)
  coords = {
      k: c for k, c in clim.coords.items()
      if set(c.dims).issubset(other_dims)
  }
  return DimArray(gathered, dims, coords)


def gather_climatology_host(
    clim: DimArray,
    indices: Mapping[str, np.ndarray],
    out_dims: tuple[str, ...],
) -> DimArray:
  """Numpy twin of :func:`gather_climatology` for the host-gather path.

  Runs in the pipeline's prepare/prefetch threads on host climatology
  arrays (never touching the device), producing the chunk-aligned slice
  that ships as a ``CLIM_VALUE_PREFIX`` device leaf. Same gather
  semantics, so values are bit-identical to the device gather.
  """
  data = np.asarray(clim.data)
  clim_dims = clim.dims
  time_dims = [d for d in clim_dims if d in indices]
  other_dims = [d for d in clim_dims if d not in indices]
  order = [clim_dims.index(d) for d in time_dims + other_dims]
  data = np.transpose(data, order)
  tshape = data.shape[:len(time_dims)]
  data = data.reshape((-1,) + data.shape[len(time_dims):])
  first = np.asarray(indices[time_dims[0]])
  flat_idx = np.zeros(first.shape, dtype=np.int64)
  stride = 1
  for d, s in zip(reversed(time_dims), reversed(tshape)):
    flat_idx = flat_idx + np.asarray(indices[d]) * stride
    stride *= s
  gathered = np.take(data, flat_idx.reshape(-1), axis=0)
  gathered = gathered.reshape(tuple(first.shape) + data.shape[1:])
  return DimArray(gathered, tuple(out_dims) + tuple(other_dims), {})


# Device coords carrying precomputed climatology gather indices, attached by
# the pipeline before the jit boundary (see parallel.evaluator.prepare_chunk).
CLIM_INDEX_PREFIX = '_clim_idx_'

# Device coords carrying HOST-PRE-GATHERED climatology values for one chunk.
# Used when a climatology is too large to live in HBM for the whole run
# (production arity: a 366x4 dayofyear/hour climatology over ~85 field-levels
# is ~14 GB at 240x121 and ~200 GB at 0.25 degrees — it can never be a
# resident device resource). The evaluator marks oversized gather-only
# climatologies (see ChunkEvaluator._plan_resources) and the statistic's
# prepare_chunk hook then gathers the chunk's aligned slice on HOST and ships
# it as a per-chunk device leaf instead — bounded by chunk size, at the cost
# of re-transferring the aligned slice each chunk. Coord name is keyed by the
# climatology array's resource_id so multiple statistics sharing one
# climatology share one gathered copy.
CLIM_VALUE_PREFIX = '_clim_val_'


def attach_climatology_indices(
    predictions: Mapping[Hashable, DimArray],
    climatology: Mapping[Hashable, DimArray],
) -> dict[Hashable, DimArray]:
  """Precomputes clim alignment indices and attaches them as device coords.

  Host-side per chunk (cheap: O(n_times)). The int32 index coords are left
  as numpy here; the pipeline's ``prepare_chunk`` moves them to the device
  in one batched transfer (per-array transfers are a blocking transfer
  each), after which they are pytree leaves and the
  jitted statistic gathers without retracing when chunk times change.
  """
  out = dict(predictions)
  for var, da in predictions.items():
    if var in climatology:
      clim = climatology[var]
    elif climatology:
      # Climatology variables may be derived names (e.g. SEEPS's
      # '{var}_seeps_threshold'); alignment indices depend only on the
      # climatology's time layout, which is shared across its variables.
      clim = next(iter(climatology.values()))
    else:
      continue
    vt_dims, vt = valid_time_coord(da)
    idx = climatology_alignment_indices(clim, vt)
    coords = {
        f'{CLIM_INDEX_PREFIX}{d}': Coord(vt_dims, np.asarray(i, np.int32))
        for d, i in idx.items()
    }
    out[var] = da.assign_coords(**coords)
  return out


def aligned_climatology_for(clim: DimArray, pred: DimArray) -> DimArray:
  """Climatology aligned to pred's valid_time, via either path.

  Pipeline path: a ``_clim_val_<rid>`` coord (host-pre-gathered slice for
  oversized climatologies) is used verbatim if present; otherwise
  ``_clim_idx_*`` device index coords attached by ``prepare_chunk``
  (retrace-free on-device gather from the resident resource). Notebook
  path: align host-side from datetime coords.
  """
  val = pred.coords.get(f'{CLIM_VALUE_PREFIX}{resource_id(clim)}')
  if val is not None:
    return DimArray(val.values, val.dims, {})
  idx_coords = {
      name[len(CLIM_INDEX_PREFIX):]: c
      for name, c in pred.coords.items()
      if name.startswith(CLIM_INDEX_PREFIX)
  }
  idx_coords = {d: c for d, c in idx_coords.items() if d in clim.dims}
  if idx_coords:
    any_coord = next(iter(idx_coords.values()))
    return gather_climatology(
        clim, {d: c.values for d, c in idx_coords.items()},
        tuple(any_coord.dims))
  return align_climatology(clim, pred)


class StatisticWithClimatology(Statistic):
  """Mixin providing climatology storage + the pipeline prepare hook."""

  # resource_ids the evaluator decided NOT to keep device-resident (too
  # large for the resource budget); prepare_chunk host-gathers these per
  # chunk instead. Set via set_host_gather_resources.
  _host_gather_ids: frozenset = frozenset()

  def __init__(self, climatology: Mapping[Hashable, DimArray]):
    self._climatology = dict(climatology)

  @property
  def climatology(self) -> Mapping[Hashable, DimArray]:
    return self._climatology

  def clim(self, key: Hashable) -> DimArray:
    """Climatology variable, resolved to its device-resource argument when
    tracing under the evaluator (see ``device_resources``)."""
    return resolve_resource(self._climatology[key])

  def device_resource_arrays(self) -> dict[str, Any]:
    """{resource_id: host array} for the evaluator to upload once."""
    return {resource_id(da): da.data for da in self._climatology.values()}

  def host_gatherable_resource_arrays(self) -> dict[str, DimArray]:
    """{resource_id: DimArray} of entries consumed ONLY through
    ``aligned_climatology_for`` — safe to host-gather per chunk when the
    resident-resource budget overflows. Subclasses using an entry
    directly in compute (not via alignment) must exclude it."""
    return {resource_id(da): da for da in self._climatology.values()}

  def set_host_gather_resources(self, ids) -> None:
    self._host_gather_ids = frozenset(ids)

  def _aligned_clim_keys(self, var: Hashable) -> tuple:
    """Climatology keys whose arrays compute() aligns to variable ``var``
    (used to pre-gather the right array on the host-gather path)."""
    return (var,) if var in self._climatology else ()

  def _attach_host_gathered(self, predictions: dict) -> dict:
    """Attaches host-gathered aligned slices for oversized climatologies."""
    if not self._host_gather_ids:
      return predictions
    for var, da in list(predictions.items()):
      for key in self._aligned_clim_keys(var):
        clim = self._climatology[key]
        rid = resource_id(clim)
        if rid not in self._host_gather_ids:
          continue
        name = f'{CLIM_VALUE_PREFIX}{rid}'
        if name in da.coords:
          continue  # another statistic sharing this climatology attached it
        vt_dims, vt = valid_time_coord(da)
        idx = climatology_alignment_indices(clim, vt)
        g = gather_climatology_host(clim, idx, vt_dims)
        da = da.assign_coords(**{name: Coord(g.dims, g.data)})
      predictions[var] = da
    return predictions

  def prepare_chunk(self, predictions, targets):
    return self._attach_host_gathered(attach_climatology_indices(
        dict(predictions), self._climatology)), targets


class PerVariableStatisticWithClimatology(StatisticWithClimatology):
  """Base for per-variable statistics needing a time-aligned climatology.

  Reference: ``metrics/base.py:338-415``. The climatology is aligned to the
  predictions' valid_time (explicit coord, or init_time + lead_time), by
  exact ``time`` match or by (dayofyear[, hour]).
  """

  @final
  def compute(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> Mapping[Hashable, DimArray]:
    result = {}
    for var_name in predictions.keys():
      if var_name not in targets:
        continue
      clim = self.clim(var_name)
      pred = predictions[var_name]
      aligned = aligned_climatology_for(clim, pred)
      result[var_name] = self._compute_per_variable_with_aligned_climatology(
          pred, targets[var_name], aligned)
    return result

  @abc.abstractmethod
  def _compute_per_variable_with_aligned_climatology(
      self,
      predictions: DimArray,
      targets: DimArray,
      aligned_climatology: DimArray,
  ) -> DimArray:
    """Computes the statistic given the time-aligned climatology."""
