"""Aggregation: the monoid (Σ weighted statistics, Σ weights) and Aggregator.

Reference semantics: ``weatherbenchX/aggregation.py:27-428``. The central
algebra: every metric is a function of weighted means of per-chunk
statistics, so distributed evaluation reduces to summing
``(Σ w·s, Σ w)`` pairs — a commutative monoid — then applying a final
nonlinear ``values_from_mean_statistics``.

Mapping onto JAX:

* The per-chunk contraction ``xr.dot(stat, *weights, *bin_masks,
  dim=reduce_dims)`` (reference ``aggregation.py:290-328``) is ONE fused
  ``jnp.einsum`` per (statistic, variable) — XLA fuses the statistic
  elementwise math into the reduction so per-point statistics are never
  materialized in device memory.
* Cross-chunk accumulation has two tiers: a device fast path (same
  dims/shape/coords → pure tree add, psum-able across a mesh) and a host
  general path (zero-filled sorted outer join, matching
  ``combining_sum``/``xr.align(join='outer', fill_value=0)``,
  ``aggregation.py:27-53``) used for sparse/ragged chunk results. Host
  accumulation is float64 for cross-chunk precision.
* The state serializes to the framework's npz container (and to xarray
  when available) using the reference's ``#``-separated naming schema
  (``aggregation.py:227-258``).
"""

import dataclasses
from typing import Any, Callable, Collection, Hashable, Iterable, Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from weatherbenchx_tpu import binning as binning_lib
from weatherbenchx_tpu import darray
from weatherbenchx_tpu import io as io_lib
from weatherbenchx_tpu import tree
from weatherbenchx_tpu import weighting as weighting_lib
from weatherbenchx_tpu.darray import Coord, DimArray
from weatherbenchx_tpu.metrics import base as metrics_base


def _host_dim_coords_equal(a: DimArray, b: DimArray) -> bool:
  for d in a.dims:
    ca, cb = a.coords.get(d), b.coords.get(d)
    if (ca is None) != (cb is None):
      return False
    if ca is None:
      continue
    if ca.is_host != cb.is_host:
      return False
    if ca.is_host and not np.array_equal(
        np.asarray(ca.values), np.asarray(cb.values)):
      return False
  return True


def _fast_path_compatible(arrays: Sequence[DimArray]) -> bool:
  first = arrays[0]
  return all(
      a.dims == first.dims and a.shape == first.shape
      and _host_dim_coords_equal(a, first) for a in arrays[1:])


def combining_sum(data_arrays: Sequence[DimArray]) -> DimArray:
  """Sum with zero-filled outer join over non-aligned dim coordinates.

  Fast path (identical layout): a device-side add that jits/psums.
  General path: host-side sorted-union outer join with zero fill, matching
  the reference's ``xr.align(join='outer', fill_value=0)`` semantics.
  """
  data_arrays = list(data_arrays)
  if len(data_arrays) == 1:
    return data_arrays[0]
  if _fast_path_compatible(data_arrays):
    out = data_arrays[0]
    leaves = [a.data for a in data_arrays]
    if not any(isinstance(l, jax.Array) for l in leaves):
      # All-host inputs (e.g. float64 to_host() states loaded from disk):
      # accumulate on host. Routing through jnp.asarray would silently
      # downcast float64 to float32 (x64 disabled) and move a host-only
      # result-combination workflow onto the device.
      acc = np.zeros(np.shape(leaves[0]),
                     dtype=np.result_type(*[np.asarray(l) for l in leaves]))
      for l in leaves:
        acc += np.asarray(l)
      return out.copy(data=acc)
    return out.copy(data=_batched_device_sum(
        [jnp.asarray(l) for l in leaves]))
  return _outer_join_sum(data_arrays)


_DEVICE_SUM_BATCH = 64


def _batched_device_sum(leaves):
  """Sum of same-shape arrays in O(N/64) dispatches, not O(N).

  The inference workflow sums many saved AggregationStates
  (``AggregationState.sum`` over per-month files); a sequential
  ``acc + a`` loop dispatches once per state per leaf, each dispatch a
  host round trip. Stack + one reduction
  per batch of 64 bounds both the dispatch count and the transient
  stacked-buffer memory.
  """
  if len(leaves) == 2:  # the running-pipeline case: one fused add
    return leaves[0] + leaves[1]
  partials = []
  for i in range(0, len(leaves), _DEVICE_SUM_BATCH):
    batch = leaves[i:i + _DEVICE_SUM_BATCH]
    if len(batch) == 1:
      partials.append(batch[0])
    else:
      partials.append(jnp.sum(jnp.stack(batch), axis=0))
  acc = partials[0]
  for p in partials[1:]:
    acc = acc + p
  return acc


def _outer_join_sum(arrays: Sequence[DimArray]) -> DimArray:
  """Host-side zero-filled outer-join sum (sorted coordinate union)."""
  first = arrays[0]
  dims = first.dims
  for a in arrays[1:]:
    if set(a.dims) != set(dims):
      raise ValueError(
          f'Cannot sum arrays with different dims: {a.dims} vs {dims}')
  arrays = [a.transpose(*dims) if a.dims != dims else a for a in arrays]

  union_coords: dict[str, np.ndarray] = {}
  for d in dims:
    has_coord = [a.coords.get(d) is not None for a in arrays]
    sizes = {a.sizes[d] for a in arrays}
    same_coords = all(has_coord) and all(
        np.array_equal(np.asarray(a.coords[d].values),
                       np.asarray(arrays[0].coords[d].values))
        for a in arrays[1:])
    if len(sizes) == 1 and (not any(has_coord) or same_coords):
      continue  # aligned already
    if not all(has_coord):
      raise ValueError(
          f'Cannot outer-join dim {d!r} without coordinates on all arrays')
    union_coords[d] = np.unique(np.concatenate(
        [np.asarray(a.coords[d].values) for a in arrays]))

  out_sizes = {
      d: (len(union_coords[d]) if d in union_coords else first.sizes[d])
      for d in dims}
  dtype = np.result_type(*[np.asarray(a.data).dtype for a in arrays])
  if dtype.kind == 'f':
    acc_dtype = np.float64
  else:
    acc_dtype = dtype
  result = np.zeros([out_sizes[d] for d in dims], dtype=acc_dtype)

  for a in arrays:
    indexers = []
    for d in dims:
      if d in union_coords:
        vals = np.asarray(a.coords[d].values)
        indexers.append(np.searchsorted(union_coords[d], vals))
      else:
        indexers.append(np.arange(a.sizes[d]))
    np.add.at(result, np.ix_(*indexers) if indexers else (),
              np.asarray(a.values))

  coords: dict[str, Coord] = {}
  for d in dims:
    if d in union_coords:
      coords[d] = Coord((d,), union_coords[d])
    elif first.coords.get(d) is not None:
      coords[d] = first.coords[d]
  # Non-dim host coords: keep those consistent across inputs on unchanged dims.
  for name, c in first.coords.items():
    if name in coords or not set(c.dims).issubset(dims):
      continue
    if any(d in union_coords for d in c.dims):
      continue
    coords[name] = c
  return DimArray(result.astype(dtype, copy=False), dims, coords)


@dataclasses.dataclass
class AggregationState:
  """Sum of weighted statistics and sum of weights (a commutative monoid).

  Both attributes are nested ``{statistic_name: {var_name: DimArray}}``
  mappings (or a bare DimArray in degenerate uses), or None for the zero
  state.
  """

  sum_weighted_statistics: Any
  sum_weights: Any

  @classmethod
  def zero(cls) -> 'AggregationState':
    return cls(sum_weighted_statistics=None, sum_weights=None)

  def __add__(self, other: 'AggregationState') -> 'AggregationState':
    return self.sum([self, other])

  @classmethod
  def sum(cls, aggregation_states: Iterable['AggregationState']
          ) -> 'AggregationState':
    tuples = [
        (a.sum_weighted_statistics, a.sum_weights)
        for a in aggregation_states
        if a.sum_weighted_statistics is not None
    ]
    if not tuples:
      return cls.zero()
    sum_ws, sum_w = tree.map_structure(
        lambda *a: combining_sum(a), *tuples)
    return cls(sum_ws, sum_w)

  def mean_statistics(self) -> Any:
    """Statistics normalized by their weights ({} for the zero state)."""
    if self.sum_weighted_statistics is None:
      return {}
    return tree.map_structure(
        lambda ws, w: ws / w, self.sum_weighted_statistics, self.sum_weights)

  def metric_values(
      self, metrics: Mapping[str, metrics_base.Metric]
  ) -> dict[str, DimArray]:
    """Final metric values as a flat '<metric>.<variable>' dataset."""
    if self.sum_weighted_statistics is None:
      return {}
    mean_statistics = self.mean_statistics()
    metric_values = metrics_base.compute_metrics_from_statistics(
        metrics, mean_statistics)
    values: dict[str, DimArray] = {}
    for metric_name in metric_values:
      for var_name in metric_values[metric_name]:
        values[f'{metric_name}.{var_name}'] = (
            metric_values[metric_name][var_name])
    return values

  def sum_along_dims(self, dims: Collection[str]) -> 'AggregationState':
    """Second-stage reduction over preserved dims (e.g. init_time)."""
    if self.sum_weighted_statistics is None:
      return self
    return self.map(lambda x: x.sum(tuple(d for d in dims if d in x.dims)))

  def dot(self, *arrays: DimArray,
          dim: str | Sequence[str]) -> 'AggregationState':
    """Contract all stats with resampling/count matrices (bootstrap core)."""
    return self.map(lambda x: darray.dot(x, *arrays, dim=dim))

  @classmethod
  def map_multi(
      cls,
      func: Callable[..., DimArray],
      *agg_states: 'AggregationState',
  ) -> 'AggregationState':
    if any(a.sum_weighted_statistics is None for a in agg_states):
      raise ValueError('Cannot map a zero AggregationState.')
    sum_ws = tree.map_structure(
        func, *[a.sum_weighted_statistics for a in agg_states])
    sum_w = tree.map_structure(
        func, *[a.sum_weights for a in agg_states])
    return AggregationState(sum_ws, sum_w)

  def map(self, func: Callable[[DimArray], DimArray]) -> 'AggregationState':
    if self.sum_weighted_statistics is None:
      return self  # the zero state maps to itself (so e.g. to_host works)
    return self.map_multi(func, self)

  # -- serialization ---------------------------------------------------------

  def to_dataset(self, separator: str = '#') -> dict[str, DimArray]:
    """Flat dataset view using the reference's '#' path schema.

    Keys are '<stat>#<var>#sum_weighted_statistics' / '...#sum_weights'
    (compare reference ``aggregation.py:227-247``).
    """
    out: dict[str, DimArray] = {}
    for leaf_name, tree_ in (
        ('sum_weighted_statistics', self.sum_weighted_statistics),
        ('sum_weights', self.sum_weights)):
      for path, da in tree.flatten_with_paths(tree_).items():
        key = separator.join([str(p) for p in path] + [leaf_name])
        out[key] = da
    return out

  @classmethod
  def from_dataset(cls, dataset: Mapping[str, DimArray],
                   separator: str = '#') -> 'AggregationState':
    sum_ws: dict = {}
    sum_w: dict = {}
    for key, da in dataset.items():
      *path, leaf_name = str(key).split(separator)
      target = sum_ws if leaf_name == 'sum_weighted_statistics' else sum_w
      node = target
      for p in path[:-1]:
        node = node.setdefault(p, {})
      node[path[-1]] = da
    return cls(sum_ws, sum_w)

  def save(self, path: str) -> None:
    io_lib.save_dataset(path, self.to_dataset())

  def to_xarray(self, separator: str = '#'):
    """xarray.Dataset view (optional dependency), reference schema."""
    return io_lib.to_xarray_dataset(self.to_dataset(separator))

  @classmethod
  def load(cls, path: str) -> 'AggregationState':
    return cls.from_dataset(io_lib.load_dataset(path))

  def block_until_ready(self) -> 'AggregationState':
    jax.block_until_ready(jax.tree_util.tree_leaves(
        (self.sum_weighted_statistics, self.sum_weights)))
    return self

  def to_host(self) -> 'AggregationState':
    """Device→host transfer of all arrays (as float64 numpy).

    One batched jax.device_get for the whole state — per-array fetches
    are a blocking transfer each.
    """
    fetched = jax.device_get(self)
    def conv(x: DimArray) -> DimArray:
      d = np.asarray(x.data)
      if d.dtype.kind == 'f':
        d = d.astype(np.float64)
      coords = {
          name: Coord(c.dims, np.asarray(c.values))
          for name, c in x.coords.items()
      }
      return DimArray(d, x.dims, coords)
    return fetched.map(conv)


# Register as pytree so whole states pass through jit/psum directly.
jax.tree_util.register_pytree_node(
    AggregationState,
    lambda s: ((s.sum_weighted_statistics, s.sum_weights), None),
    lambda _, c: AggregationState(*c),
)


def _coord_fingerprint(c) -> tuple:
  v = c.values
  if isinstance(v, np.ndarray) and v.size <= 4096:
    # content hash for small coords (lat/lon/time/levels): different
    # variables routinely carry equal-valued but distinct coord
    # arrays, and id-keying them would defeat the dedup entirely
    return (str(v.dtype), v.shape,
            hash(np.ascontiguousarray(v).tobytes()))
  return ('id', id(v))


def _layout_key(stat: DimArray) -> tuple:
  """Hashable key identifying a statistic's aggregation layout: dims,
  shape, dtype, and coord content (small coords by value, large by id).
  Equal keys share operand objects and batch into one contraction."""
  coords_key = tuple(sorted(
      (str(n), tuple(c.dims), _coord_fingerprint(c))
      for n, c in stat.coords.items()))
  return (tuple(stat.dims), tuple(stat.shape),
          np.dtype(stat.dtype).str, coords_key)


@dataclasses.dataclass
class Aggregator:
  """Weighted/binned/masked aggregation over a set of dimensions.

  Reference semantics (``aggregation.py:261-401``): variables lacking any
  reduce dim (or any bin-mask input dim) are silently dropped; masked
  values are zeroed in both statistic and weights; skipna turns NaNs into
  masked points; otherwise NaNs propagate loudly.
  """

  reduce_dims: Collection[str]
  bin_by: Sequence[binning_lib.Binning] | None = None
  weigh_by: Sequence[weighting_lib.Weighting] | None = None
  masked: bool = False
  skipna: bool = False

  def aggregation_operands(self, stat: DimArray) -> list[DimArray] | None:
    """Weights + bin masks for a statistic's LAYOUT (host computation).

    Depends only on the stat's dims/dtype and host coords, so it can be
    computed from an abstract stat (``jax.eval_shape`` output) and reused
    across chunks: the evaluator prepares these ONCE per chunk layout and
    passes them into the jitted step as device arguments — baking the
    0.25°x34-bin region masks (~140 MB) into the program as HLO constants
    bloats compile payloads and duplicates them per program.

    Returns None when this variable must be dropped (missing reduce dims
    or bin-input dims), mirroring reference ``aggregation.py:290-327``.
    """
    reduce_dims_set = set(self.reduce_dims)
    eval_unit_dims = set(stat.dims)
    if not reduce_dims_set.issubset(eval_unit_dims):
      return None

    weights = [w.weights(stat) for w in self.weigh_by or []]

    bin_dim_names = {b.bin_dim_name for b in self.bin_by or []}
    if len(bin_dim_names) != len(self.bin_by or []):
      raise ValueError('Bin dimension names must be unique.')

    bin_masks = []
    for b in self.bin_by or []:
      bin_mask = b.create_bin_mask(stat)
      bin_mask_dims = set(bin_mask.dims) - {b.bin_dim_name}
      if bin_mask_dims.issubset(eval_unit_dims):
        bin_masks.append(bin_mask)
      else:
        return None

    def cast(da: DimArray) -> DimArray:
      if da.dtype == stat.dtype:
        return da
      if da.dtype == np.bool_:
        # Bin masks STAY bool: the device copy of e.g. the 0.25°x34-bin
        # region stack is 1 B/elt (~35 MB) instead of the float32 cast's
        # ~141 MB.
        return da
      d = da.data
      if isinstance(d, np.ndarray):
        # Host cast: DimArray.astype routes through jnp, an eager device
        # round trip per operand per chunk. Operand prep is host-side by
        # design.
        return da.copy(data=d.astype(stat.dtype))
      return da.astype(stat.dtype)

    operands = [cast(w) for w in weights]
    operands += [cast(m) for m in bin_masks]
    return operands

  _UNSET = object()

  def aggregation_fn(self, stat: DimArray,
                     operands=_UNSET) -> DimArray | None:
    """The fused contraction: einsum(stat, *weights, *bin_masks)."""
    if operands is Aggregator._UNSET:
      operands = self.aggregation_operands(stat)
    if operands is None:
      return None
    reduce_dims_set = set(self.reduce_dims)
    if not reduce_dims_set.issubset(set(stat.dims)):
      return None
    return darray.dot(stat, *operands, dim=tuple(
        d for d in stat.dims if d in reduce_dims_set))

  def _promote(self, stat: DimArray) -> DimArray:
    if stat.dtype == np.bool_:
      # XLA reduces booleans with logical OR, so a bool statistic (Covered,
      # Confident, ErrorExceedance, ...) would aggregate to "any" instead of
      # a weighted mean. Promote before the einsum (xr.dot promotes too).
      return stat.astype(np.float32)
    return stat

  def _prepare_masked(self, stat: DimArray) -> tuple[DimArray, DimArray]:
    """masked/skipna prep: (zeroed statistic, weights-indicator mask)."""
    if self.masked and stat.has_coord('mask'):
      mask = DimArray(stat.coords['mask'].values,
                      stat.coords['mask'].dims)
      if self.skipna:
        mask = mask & ~stat.isnull()
      # Zero out masked values in the stat (avoids NaN*0 -> NaN), and use
      # the broadcast mask as the weights indicator.
      stat = stat.where(mask, 0)
      mask = mask.broadcast_like(stat)
    elif self.skipna:
      mask = ~stat.isnull()
      stat = stat.where(mask, 0)
    else:
      mask = darray.ones_like(stat, dtype=bool)
    assert mask.sizes == stat.sizes
    return stat, mask.astype(stat.dtype)

  def aggregate_stat_var(self, stat: DimArray,
                         operands=_UNSET) -> AggregationState | None:
    """Aggregate one statistic DimArray for one variable."""
    stat, maskf = self._prepare_masked(self._promote(stat))
    sum_weighted_statistics = self.aggregation_fn(stat, operands)
    sum_weights = self.aggregation_fn(maskf, operands)
    if sum_weighted_statistics is None or sum_weights is None:
      return None
    return AggregationState(sum_weighted_statistics, sum_weights)

  def aggregate_stat_vars(
      self, stats: Mapping[Hashable, DimArray],
      operands=None) -> AggregationState:
    per_var = {
        var: self.aggregate_stat_var(
            stat,
            (operands or {}).get(var, Aggregator._UNSET)
            if operands is not None else Aggregator._UNSET)
        for var, stat in stats.items() if stat is not None}
    return AggregationState(
        sum_weighted_statistics={
            v: s.sum_weighted_statistics for v, s in per_var.items()
            if s is not None},
        sum_weights={
            v: s.sum_weights for v, s in per_var.items() if s is not None},
    )

  def aggregate_statistics(
      self,
      statistics: Mapping[str, Mapping[Hashable, DimArray]],
      operands=None,
  ) -> AggregationState:
    """Aggregate all (statistic, variable) arrays of a chunk.

    ``operands``: optional pre-built {stat_name: {var: [DimArray...]|None}}
    from :meth:`prepare_operands` — device-resident weights/bin masks
    passed into the jitted step instead of being re-derived (and baked as
    HLO constants) at trace time.

    Operands are resolved once per statistic layout, so statistics of one
    layout contract against the same weight and bin-mask arrays.
    """
    reduce_set = set(self.reduce_dims)
    op_memo: dict = {}

    def resolve_operands(name, var, stat):
      per_name = operands.get(name) if operands is not None else None
      if per_name is not None and var in per_name:
        return per_name[var]  # may be None: var dropped
      key = _layout_key(stat)
      if key not in op_memo:
        op_memo[key] = self.aggregation_operands(stat)
      return op_memo[key]

    sums: dict = {name: {} for name in statistics}
    weights: dict = {name: {} for name in statistics}
    for name, stats in statistics.items():
      for var, stat in stats.items():
        if stat is None:
          continue
        stat = self._promote(stat)
        ops = resolve_operands(name, var, stat)
        if ops is None or not reduce_set.issubset(set(stat.dims)):
          continue
        stat0, maskf = self._prepare_masked(stat)
        dims = tuple(d for d in stat0.dims if d in reduce_set)
        sums[name][var] = darray.dot(stat0, *ops, dim=dims)
        weights[name][var] = darray.dot(maskf, *ops, dim=dims)
    return AggregationState(sum_weighted_statistics=sums,
                            sum_weights=weights)

  def prepare_operands(
      self,
      abstract_statistics: Mapping[str, Mapping[Hashable, DimArray]],
  ) -> dict:
    """Host-side operand build from ABSTRACT statistics (eval_shape output).

    Applies the same bool→float32 promotion as :meth:`aggregate_stat_var`
    so operand dtypes match what the traced step contracts with.
    """
    out: dict = {}
    # Same-layout statistics get the SAME operand objects (the weights /
    # bin masks depend only on dims, shape, dtype, and coord values):
    # downstream the evaluator then uploads one device copy of e.g. the
    # 0.25°x34-bin region-mask stack instead of one per statistic
    # (a 10-statistic family held 10 copies in device memory before).
    layout_cache: dict = {}

    for name, stats in abstract_statistics.items():
      per_var: dict = {}
      for var, stat in stats.items():
        if stat is None:
          continue
        if stat.dtype == np.bool_:
          stat = DimArray(
              jax.ShapeDtypeStruct(stat.shape, np.float32), stat.dims,
              stat.coords)
        key = _layout_key(stat)
        if key not in layout_cache:
          layout_cache[key] = self.aggregation_operands(stat)
        per_var[var] = layout_cache[key]
      out[name] = per_var
    return out


def compute_metric_values_for_single_chunk(
    metrics: Mapping[str, metrics_base.Metric],
    aggregator: Aggregator,
    predictions: Mapping[Hashable, DimArray],
    targets: Mapping[Hashable, DimArray],
) -> dict[str, DimArray]:
  """stats → aggregate → finalize for one in-memory chunk.

  The semantic ground truth the distributed pipeline is tested against
  (reference ``aggregation.py:404-428``), and the unit that jits onto a
  single device.
  """
  statistics = metrics_base.compute_unique_statistics_for_all_metrics(
      metrics, predictions, targets)
  aggregation_state = aggregator.aggregate_statistics(statistics)
  return aggregation_state.metric_values(metrics)
