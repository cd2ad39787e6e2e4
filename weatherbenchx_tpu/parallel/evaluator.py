"""The jitted, mesh-sharded per-chunk evaluation step.

This is the replacement for the reference's Beam worker DoFns
(``beam_pipeline.py:68-240``): one XLA program per chunk computes every
unique statistic, fuses weighting/binning/masking into einsum reductions,
and emits the (Σ w·s, Σ w) AggregationState.

Distribution model (replacing the Beam shuffle, ``beam_pipeline.py:452-467``):

* Inputs are placed across a ``jax.sharding.Mesh`` with a dim→mesh-axis map
  (e.g. init_time→'batch', latitude→'space', number→'ensemble').
* Under ``jax.jit``, XLA's SPMD partitioner turns the fused einsum over
  sharded reduce dims into local partial reductions + all-reduce over ICI —
  exactly the CombinePerKey monoid sum, but in one compiled collective.
* Preserved dims keep their sharding in the output layout with no
  communication at all.

Retrace avoidance: per-chunk-varying time coords are converted to int64
seconds device coords (pytree leaves) by ``prepare_chunk``, and climatology
statistics consume precomputed device gather indices — so the step traces
once and replays for every chunk.
"""

import dataclasses
import logging
import os
from typing import Hashable, Mapping, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from weatherbenchx_tpu import aggregation as aggregation_lib
from weatherbenchx_tpu.darray import Coord, DimArray
from weatherbenchx_tpu.metrics import base as metrics_base

# Time coords converted host→device at the jit boundary and back on output.
_DATETIME_COORDS = ('init_time', 'valid_time')
_TIMEDELTA_COORDS = ('lead_time',)

# name → numpy dtype kind ('M' datetime / 'm' timedelta) for EVERY coord
# _convert_chunk turned into int64 seconds, so restore_time_coords can
# reverse the conversion for non-canonical names too (e.g. a sparse
# 'timeObs' coordinate variable) instead of leaving raw epoch ints in
# user-visible unaggregated output. Process-wide: conversion always happens
# before restoration in the same process, and a name is only ever one kind.
_CONVERTED_TIME_COORDS: dict[str, str] = (
    {n: 'M' for n in _DATETIME_COORDS} | {n: 'm' for n in _TIMEDELTA_COORDS})


def _resource_budget_bytes() -> int:
  """HBM budget for device-resident statistic resources (climatologies).

  ``WBX_RESOURCE_BYTES`` overrides; otherwise 45% of the device's
  reported memory limit (leaving the rest for chunk data, statistics and
  aggregation), falling back to 8 GB when the backend reports nothing
  (CPU test meshes).
  """
  env = os.environ.get('WBX_RESOURCE_BYTES')
  if env:
    return int(float(env))
  try:
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = int(stats.get('bytes_limit', 0))
  except Exception:  # noqa: BLE001 — backend-optional API
    limit = 0
  return int(0.45 * limit) if limit else 8 << 30


def prepare_chunk(
    data: Mapping[Hashable, DimArray],
    stats: Sequence[metrics_base.Statistic] = (),
    is_predictions: bool = False,
    targets: Mapping[Hashable, DimArray] | None = None,
    keep_host_coords: Sequence[str] = (),
) -> dict[Hashable, DimArray]:
  """Makes a chunk retrace-free: time coords → int64-seconds device leaves.

  Statistics first get their host-side ``prepare_chunk`` hook (e.g.
  climatology gather-index coords), while host datetime coords are still
  available. Coords named in ``keep_host_coords`` stay host-side (static)
  because binnings need their values at trace time.
  """
  converted, pending, slots = _convert_chunk(
      data, stats, is_predictions, targets, keep_host_coords)
  if pending:
    moved = jax.device_put(pending)
    _apply_moved(converted, slots, moved)
  return converted


def _convert_chunk(data, stats, is_predictions, targets, keep_host_coords):
  """Core of prepare_chunk with device placement deferred.

  Returns (converted dict, pending arrays, slots): the caller must move
  ``pending`` to the device in ONE jax.device_put and apply the results
  via ``_apply_moved`` — per-array transfers are a blocking transfer each,
  where one batched transfer pays that latency once.
  Until then the slotted coords hold host placeholders.
  """
  out = dict(data)
  if is_predictions:
    for stat in stats:
      out, _ = stat.prepare_chunk(out, targets or {})

  keep = set(keep_host_coords)
  pending: list[np.ndarray] = []
  slots: list[tuple[Hashable, str, tuple]] = []  # (var, coord name, dims)

  def convert(var, da: DimArray) -> DimArray:
    new_coords = {}
    for name, c in da.coords.items():
      v = c.values
      if name in keep:
        new_coords[name] = c
      elif isinstance(v, np.ndarray) and v.dtype.kind in 'Mm':
        if v.dtype.kind == 'M':
          secs = v.astype('datetime64[s]').astype(np.int64)
        else:
          secs = v.astype('timedelta64[s]').astype(np.int64)
        _CONVERTED_TIME_COORDS.setdefault(str(name), v.dtype.kind)
        pending.append(secs)
        slots.append((var, name, c.dims))
        new_coords[name] = c  # placeholder, replaced by _apply_moved
      elif (isinstance(v, np.ndarray)
            and str(name).startswith((metrics_base.CLIM_INDEX_PREFIX,
                                      metrics_base.CLIM_VALUE_PREFIX))):
        pending.append(v)
        slots.append((var, name, c.dims))
        new_coords[name] = c
      elif (name == 'mask' and isinstance(v, np.ndarray)
            and v.dtype == np.bool_):
        # Validity masks vary per chunk in VALUE (NaN patterns, sparse
        # padding). As a host coord they'd be static pytree aux — a
        # retrace per chunk AND an HLO constant; as a device leaf the
        # step traces once.
        pending.append(v)
        slots.append((var, name, c.dims))
        new_coords[name] = c
      else:
        new_coords[name] = c
    return DimArray(da.data, da.dims, new_coords)

  converted = {var: convert(var, da) for var, da in out.items()}
  return converted, pending, slots


def _apply_moved(converted, slots, moved) -> None:
  for (var, name, dims), dev in zip(slots, moved):
    da = converted[var]
    converted[var] = da.assign_coords(**{name: Coord(dims, dev)})


def restore_time_coords(da: DimArray) -> DimArray:
  """Converts int64-seconds device time coords back to datetime/timedelta."""
  new_coords = {}
  for name, c in da.coords.items():
    v = c.values
    if not isinstance(v, np.ndarray):
      v = np.asarray(v)
    kind = _CONVERTED_TIME_COORDS.get(str(name))
    if kind == 'M' and v.dtype.kind in 'iu':
      v = v.astype('datetime64[s]').astype('datetime64[ns]')
    elif kind == 'm' and v.dtype.kind in 'iu':
      v = v.astype('timedelta64[s]').astype('timedelta64[ns]')
    new_coords[name] = Coord(c.dims, v)
  return DimArray(np.asarray(da.data), da.dims, new_coords)


def _unique_stats(metrics) -> list:
  return list(metrics_base.unique_statistics_for_metrics(metrics).values())


@dataclasses.dataclass
class ChunkEvaluator:
  """Compiles and runs the fused stats→aggregate step for chunks.

  Attributes:
    metrics: Mapping of metric name → Metric.
    aggregator: The Aggregator (weights/bins/mask/reduce_dims).
    mesh: Optional jax Mesh for multi-chip SPMD execution.
    dim_to_axis: Map from data dim name to mesh axis name, e.g.
      {'init_time': 'batch', 'latitude': 'space', 'number': 'ensemble'}.
      Dims not listed are replicated.
  """

  metrics: Mapping[str, metrics_base.Metric]
  aggregator: aggregation_lib.Aggregator
  mesh: Optional[jax.sharding.Mesh] = None
  dim_to_axis: Optional[Mapping[str, str]] = None

  def __post_init__(self):
    self._clim_stats = _unique_stats(self.metrics)
    self._host_coords = tuple(sorted({
        name for b in (self.aggregator.bin_by or [])
        for name in b.host_coords}))
    self._operand_cache: dict = {}
    self._resource_cache = None
    self._plan_resources()
    # Number of times the evaluation step was (re)traced — one trace per
    # distinct chunk layout. The pad-to-bucket policy keeps this bounded
    # over ragged sparse runs; tests and the sparse scale demo assert on
    # it (jit's _cache_size is not reliable for custom-pytree args).
    self.trace_count = 0
    self._jitted = jax.jit(self._eval_fn)
    self._jitted_many = jax.jit(self._eval_many)
    self._jitted_accum = jax.jit(self._eval_accum_fn)

  def _eval_fn(self, predictions, targets, operands=None,
               resources=None) -> aggregation_lib.AggregationState:
    self.trace_count += 1  # runs at trace time only, not per dispatch
    with metrics_base.device_resources(resources):
      statistics = metrics_base.compute_unique_statistics_for_all_metrics(
          self.metrics, predictions, targets)
      return self.aggregator.aggregate_statistics(statistics, operands)

  def _plan_resources(self):
    """Partitions statistic resources: device-resident vs host-gathered.

    Resident resources (climatologies small enough for HBM) upload once
    and are gathered on-device per chunk — zero per-chunk transfer. When
    their total exceeds the budget (WBX_RESOURCE_BYTES env override,
    default 45% of the device's HBM, 8 GB if unknown), the largest
    gather-only arrays are demoted to HOST-GATHER: the statistic's
    prepare_chunk aligns them on the host and ships the chunk-sized slice
    as a device leaf instead (metrics_base.CLIM_VALUE_PREFIX). This is
    what lets production-arity climatologies (~85 field-levels x 366
    dayofyear x 4 hours ~= 200 GB at 0.25 degrees) evaluate at all:
    residency is a cache policy, not a correctness requirement.
    """
    sizes: dict[str, int] = {}
    gatherable: dict[str, int] = {}
    for stat in self._clim_stats:
      getter = getattr(stat, 'device_resource_arrays', None)
      if getter is None:
        continue
      for rid, arr in getter().items():
        sizes[rid] = int(getattr(arr, 'nbytes', np.asarray(arr).nbytes))
      g = getattr(stat, 'host_gatherable_resource_arrays', None)
      if g is not None:
        for rid, da in g().items():
          if rid in sizes:
            gatherable[rid] = sizes[rid]
    total = sum(sizes.values())
    budget = _resource_budget_bytes()
    hg: set = set()
    if total > budget:
      for rid, nbytes in sorted(gatherable.items(), key=lambda kv: -kv[1]):
        hg.add(rid)
        total -= nbytes
        if total <= budget:
          break
      logging.info(
          'resource plan: %d/%d climatology arrays host-gathered '
          '(resident %.0f MB <= budget %.0f MB)',
          len(hg), len(sizes), total / 2**20, budget / 2**20)
      if total > budget:
        logging.warning(
            'resident statistic resources (%.0f MB) still exceed the '
            'budget (%.0f MB) after host-gathering every eligible array',
            total / 2**20, budget / 2**20)
    self._host_gather_ids = frozenset(hg)
    for stat in self._clim_stats:
      setter = getattr(stat, 'set_host_gather_resources', None)
      if setter is not None:
        setter(self._host_gather_ids)

  def resources(self):
    """Long-lived statistic arrays (climatologies), uploaded ONCE.

    Passed into the jitted step as arguments and resolved by object
    identity while tracing (metrics_base.device_resources) — embedding
    them as trace-time constants puts >100 MB of climatology into every
    compiled program at 0.25°. Arrays demoted to host-gather by
    _plan_resources are excluded: they ride in per chunk as prepared
    device leaves instead.
    """
    if self._resource_cache is None:
      host: dict = {}
      for stat in self._clim_stats:
        getter = getattr(stat, 'device_resource_arrays', None)
        if getter is not None:
          host.update({k: v for k, v in getter().items()
                       if k not in self._host_gather_ids})
      if not host:
        self._resource_cache = {}
      else:
        keys = list(host)
        arrays = [np.asarray(host[k]) for k in keys]
        if self.mesh is not None:
          replicated = jax.sharding.NamedSharding(
              self.mesh, jax.sharding.PartitionSpec())
          moved = jax.device_put(arrays, [replicated] * len(arrays))
        else:
          moved = jax.device_put(arrays)
        self._resource_cache = dict(zip(keys, moved))
    return self._resource_cache

  # The ragged sparse dim: per-row host coords over it (station names,
  # per-row times, row labels) change VALUE every chunk and would retrace
  # the step as static pytree aux.
  RAGGED_DIMS = ('index',)

  def lean_pair(self, predictions, targets):
    """Drops per-row host coords on the ragged sparse dim when reduced.

    Station names / per-row labels cannot appear in any aggregated output
    once their dim is reduced, but as static pytree aux they force a
    retrace per sparse chunk. Operand preparation (which does need them)
    runs on the full pair BEFORE this strip. Host coords on STABLE grid
    dims (latitude labels etc.) are kept — statistics may select on them
    at trace time (wrappers.Select), and they don't vary across chunks.
    """
    rd = set(self.aggregator.reduce_dims)
    ragged = set(self.RAGGED_DIMS) & rd

    def strip(da: DimArray) -> DimArray:
      coords = {n: c for n, c in da.coords.items()
                if not (c.is_host and set(c.dims) & ragged
                        and set(c.dims) <= rd)}
      return DimArray(da.data, da.dims, coords) if len(coords) != len(
          da.coords) else da

    if not ragged:
      return predictions, targets
    return ({v: strip(da) for v, da in predictions.items()},
            {v: strip(da) for v, da in targets.items()})

  def stripped_ragged_coords(self, predictions, targets):
    """The host coords ``lean_pair`` removes, keyed by variable name.

    A chunk-stats sink (unaggregated streaming) needs the per-row station
    names / labels that were stripped for retrace-free evaluation; this
    returns them so the pipeline can re-attach them to the emitted
    statistics host-side. Targets' coords win on a name clash (both sides
    are joined on the same rows, so they should agree).
    """
    rd = set(self.aggregator.reduce_dims)
    ragged = set(self.RAGGED_DIMS) & rd
    if not ragged:
      return {}
    out: dict = {}
    for side in (predictions, targets):
      for var, da in side.items():
        for n, c in da.coords.items():
          if c.is_host and set(c.dims) & ragged and set(c.dims) <= rd:
            out.setdefault(var, {})[n] = c
    return out

  def operands_for(self, predictions, targets):
    """Device-resident weights/bin masks for this chunk LAYOUT (cached).

    Statistic layouts (dims, dtypes, host coords) are derived without any
    compute via ``jax.eval_shape`` — host coords are static pytree aux, so
    they flow through abstractly-traced statistics intact. Operands are
    then built on host, cast, placed on the mesh ONCE, and passed into the
    jitted step as arguments. Deriving them at trace time instead would
    bake them into the program as HLO constants — at 0.25° with 34 region
    bins that is ~140 MB of constants per program: oversized compile
    payloads (a remote-compile HTTP 413 in practice) and a copy per
    program in HBM.
    """
    key = batchable_signature(predictions, targets)
    hit = self._operand_cache.get(key)
    if hit is not None:
      return hit
    abstract = jax.eval_shape(
        lambda p, t: metrics_base.compute_unique_statistics_for_all_metrics(
            self.metrics, p, t), predictions, targets)
    host_ops = self.aggregator.prepare_operands(abstract)
    rd = set(self.aggregator.reduce_dims)
    arrays, slots = [], []
    # Same-layout statistics share operand objects (prepare_operands
    # dedups them): upload ONE device copy per distinct host array — at
    # 0.25° with 34 bins each duplicate would be another ~141 MB on the
    # wire and in HBM (a 10-statistic family held 10 copies before).
    array_slot_by_id: dict = {}
    for sname, per_var in host_ops.items():
      for var, ops in per_var.items():
        if ops is None:
          continue
        for i, op in enumerate(ops):
          # Reduced-dim coords on operands (latitude labels, per-row
          # station/time coords of bin masks) are contracted away and, as
          # static aux, would retrace the step per chunk — keep only the
          # surviving (bin-dim) coords.
          coords = {n: c for n, c in op.coords.items()
                    if not (c.dims and set(c.dims) <= rd)}
          op = DimArray(op.data, op.dims, coords)
          # Never np.asarray a possibly-device leaf here: that is a
          # blocking device-to-host fetch.
          arr_id = id(op.data)
          if arr_id not in array_slot_by_id:
            array_slot_by_id[arr_id] = len(arrays)
            arrays.append(op.data)
          slots.append((sname, var, i, op, array_slot_by_id[arr_id]))
    if not arrays:
      moved = []
    elif self.mesh is not None:
      # Replicated across the mesh: a sharded mask would make the einsum's
      # contracting-dim sharding ambiguous (jax sharding-in-types rejects
      # it); with the statistic sharded and the mask replicated, GSPMD
      # partitions the contraction and inserts the psum exactly as before.
      replicated = jax.sharding.NamedSharding(
          self.mesh, jax.sharding.PartitionSpec())
      moved = jax.device_put(arrays, [replicated] * len(arrays))
    else:
      moved = jax.device_put(arrays)
    out = {s: {v: (None if ops is None else list(ops))
               for v, ops in per_var.items()}
           for s, per_var in host_ops.items()}
    placed: dict = {}
    for sname, var, i, op, arr_slot in slots:
      if arr_slot not in placed:
        placed[arr_slot] = DimArray(moved[arr_slot], op.dims, op.coords)
      out[sname][var][i] = placed[arr_slot]
    if len(self._operand_cache) >= 32:  # bound: ragged runs rebuild per key
      self._operand_cache.pop(next(iter(self._operand_cache)))
    self._operand_cache[key] = out
    return out

  def _eval_accum_fn(self, predictions, targets, prev_state, operands=None,
                     resources=None):
    """Chunk evaluation fused with the running-bucket add: one dispatch.

    Adds DimArray data only — device coords (e.g. int64-seconds time
    coords) are pytree leaves and must not be summed across chunks.
    """
    state = self._eval_fn(predictions, targets, operands, resources)
    return jax.tree_util.tree_map(
        lambda x, y: x.copy(data=x.data + y.data), state, prev_state,
        is_leaf=lambda n: isinstance(n, DimArray))

  def eval_accum(self, pair, prev_state):
    """Evaluates a prepared pair and adds it to ``prev_state`` (fused)."""
    ops = self.operands_for(*pair)
    lean = self.lean_pair(*pair)
    return self._jitted_accum(lean[0], lean[1], prev_state, ops,
                              self.resources())

  def _eval_many(self, chunks, operands=None, resources=None):
    """Evaluates N structurally-identical chunks in ONE XLA program.

    ``chunks`` is a tuple of (predictions, targets) pairs. Inputs are
    stacked along a new leading axis inside the program and the single-chunk
    step is vmapped over it — one dispatch (and one host↔device round trip)
    instead of N. Returns a state pytree whose leaves carry the leading
    chunk axis; ``_split_states`` peels it back apart. Aggregation
    operands are shared (not batched) across the chunks.
    """
    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *chunks)
    return jax.vmap(
        lambda pair, ops, res: self._eval_fn(pair[0], pair[1], ops, res),
        in_axes=(0, None, None))(stacked, operands, resources)

  def _axis_for(self, dim: str, size: int) -> Optional[str]:
    """Mesh axis for a dim, or None (replicate) if unmapped/indivisible."""
    axis = (self.dim_to_axis or {}).get(dim)
    if axis is None:
      return None
    n = dict(self.mesh.shape).get(axis, 1)
    if n <= 1 or size % n != 0:
      return None
    return axis

  def _named_sharding(self, dims, shape) -> jax.sharding.NamedSharding:
    axes = [self._axis_for(d, s) for d, s in zip(dims, shape)]
    return jax.sharding.NamedSharding(
        self.mesh, jax.sharding.PartitionSpec(*axes))

  def _shard(self, data: Mapping[Hashable, DimArray]):
    """Places chunk arrays across the mesh (device coords follow their dims).

    All arrays move in ONE device_put call (per-array transfers are a
    blocking transfer each).
    """
    arrays, shardings, slots = [], [], []  # slots: (var, coord name or None)
    for var, da in data.items():
      arrays.append(da.data)
      shardings.append(self._named_sharding(da.dims, da.shape))
      slots.append((var, None))
      for name, c in da.coords.items():
        if c.is_host:
          continue
        if str(name).startswith(metrics_base.CLIM_INDEX_PREFIX):
          # Climatology gather indices stay replicated: a gather with
          # sharded indices into a replicated operand has no unambiguous
          # output sharding (jax raises ShardingTypeError); the gather
          # output is resharded to match the statistic downstream.
          spec = jax.sharding.NamedSharding(
              self.mesh, jax.sharding.PartitionSpec())
        else:
          spec = self._named_sharding(c.dims, np.shape(c.values))
        arrays.append(c.values)
        shardings.append(spec)
        slots.append((var, name))
    moved = jax.device_put(arrays, shardings)
    out = {var: da for var, da in data.items()}
    for (var, name), dev in zip(slots, moved):
      da = out[var]
      if name is None:
        out[var] = DimArray(dev, da.dims, da.coords)
      else:
        da = out[var]
        out[var] = da.assign_coords(
            **{name: Coord(da.coords[name].dims, dev)})
    return out

  def eval_chunk(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> aggregation_lib.AggregationState:
    """Prepares, shards, and evaluates one chunk on the mesh."""
    pair = self.prepare_pair(predictions, targets)
    ops = self.operands_for(*pair)
    return self._jitted(*self.lean_pair(*pair), ops, self.resources())

  def prepare_pair(self, predictions, targets):
    """Host-side chunk preparation + ONE batched device placement.

    Coords (time seconds, climatology indices) and data arrays for both
    sides of the pair move in a single jax.device_put — per-array
    transfers are a blocking transfer each.
    """
    p, p_pending, p_slots = _convert_chunk(
        predictions, self._clim_stats, True, targets, self._host_coords)
    t, t_pending, t_slots = _convert_chunk(
        targets, (), False, None, self._host_coords)
    if self.mesh is not None:
      # The mesh path batches placement (with shardings) inside _shard;
      # resolve the pending coords through the same batched puts.
      if p_pending:
        _apply_moved(p, p_slots, jax.device_put(p_pending))
      if t_pending:
        _apply_moved(t, t_slots, jax.device_put(t_pending))
      return self._shard(p), self._shard(t)
    moved = jax.device_put((p_pending, t_pending, p, t))
    p_moved, t_moved, p, t = moved
    _apply_moved(p, p_slots, p_moved)
    _apply_moved(t, t_slots, t_moved)
    return p, t

  def eval_chunks(
      self,
      pairs: Sequence[tuple],
  ) -> list[aggregation_lib.AggregationState]:
    """Evaluates several (predictions, targets) chunks in one dispatch.

    All chunks must share pytree structure and leaf shapes (the pipeline
    groups them that way); a single chunk falls through to ``eval_chunk``.
    Amortizes per-dispatch host↔device latency, which dominates for
    small chunks.
    """
    prepared = [self.prepare_pair(p, t) for p, t in pairs]
    return self.eval_prepared(prepared)

  def eval_prepared(
      self, prepared: Sequence[tuple],
  ) -> list[aggregation_lib.AggregationState]:
    """Evaluates already-prepared (predictions, targets) pairs."""
    res = self.resources()
    if len(prepared) == 1:
      ops = self.operands_for(*prepared[0])
      return [self._jitted(*self.lean_pair(*prepared[0]), ops, res)]
    sigs = {batchable_signature(*pair) for pair in prepared}
    if len(sigs) > 1:
      # Shapes/structure diverged after preparation (e.g. a ragged tail
      # chunk): evaluate one-by-one rather than failing the stack.
      return [self._jitted(*self.lean_pair(*pair), self.operands_for(*pair),
                           res)
              for pair in prepared]
    ops = self.operands_for(*prepared[0])
    stacked_state = self._jitted_many(
        tuple(self.lean_pair(*pair) for pair in prepared), ops, res)
    return _split_states(stacked_state, len(prepared))


def _split_states(stacked_state, n: int) -> list:
  """Splits a batched AggregationState (leading chunk axis on every leaf)."""
  return [
      jax.tree_util.tree_map(lambda x, k=k: x[k], stacked_state)
      for k in range(n)
  ]


def batchable_signature(predictions, targets) -> tuple:
  """Hashable key: chunks with equal keys can share one batched dispatch."""
  leaves, treedef = jax.tree_util.tree_flatten((predictions, targets))
  # Metadata only — never np.asarray a (possibly sharded device) leaf here.
  shapes = tuple(
      (getattr(l, 'shape', ()), str(getattr(l, 'dtype', type(l))))
      for l in leaves)
  return treedef, shapes
