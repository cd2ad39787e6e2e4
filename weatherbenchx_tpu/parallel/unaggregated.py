"""Unaggregated statistics pipeline: stream raw per-point statistics out.

The equivalent of the reference's ``define_unaggregated_pipeline``
(``beam_pipeline.py:610-681``), which rechunks per-chunk statistics into a
Zarr store via xarray_beam with a template inferred from chunk 0. Here the
same thing happens without Beam: chunks are prepared and placed through the
same batched-transfer / mesh-sharding path as the aggregated evaluator, the
statistics are computed in one jitted step, and each chunk streams straight
into its cell of a Zarr v2 store (``out_path`` ending in ``.zarr``;
TimeChunks offsets map 1:1 onto the zarr chunk grid, so no rechunk shuffle
is needed). A ``.wbx`` shard-directory mode remains for ragged/sparse
statistics that don't fit a fixed grid.
"""

import dataclasses
import itertools
import json
import os
from typing import Hashable, Mapping, Optional

import jax
import numpy as np

from weatherbenchx_tpu import aggregation as aggregation_lib
from weatherbenchx_tpu import fileio
from weatherbenchx_tpu import io as io_lib
from weatherbenchx_tpu import observability
from weatherbenchx_tpu import time_chunks as time_chunks_lib
from weatherbenchx_tpu import zarr_io
from weatherbenchx_tpu.darray import Coord, DimArray
from weatherbenchx_tpu.data import base as data_base
from weatherbenchx_tpu.metrics import base as metrics_base
from weatherbenchx_tpu.parallel import evaluator as evaluator_lib
from weatherbenchx_tpu.parallel import pipeline as pipeline_lib


class ZarrStatsStore:
  """Streaming '<stat>.<var>' Zarr store writer keyed by TimeChunks cells.

  The template (shapes, dtypes, coords) comes from the first chunk with
  init/lead expanded to the full evaluation extent — the reference's
  ``_get_template_dataset`` (``beam_pipeline.py:543-605``). Usable either
  through :class:`UnaggregatedPipeline` (its own storage pass) or as the
  aggregated pipeline's ``chunk_stats_sink`` (statistics stream out of the
  SAME pass that accumulates the aggregation state — one storage scan, one
  set of device transfers).
  """

  def __init__(self, times: time_chunks_lib.TimeChunks, path: str,
               compressor: Optional[str] = None,
               distributed: bool = False,
               zarr_chunks: Optional[Mapping[str, int]] = None,
               zarr_format: int = 2,
               zarr_shards: Optional[Mapping[str, int]] = None) -> None:
    if isinstance(times.lead_times, slice):
      raise ValueError(
          'Zarr unaggregated output needs exact lead_times: a lead '
          'interval has unknown extent until load time')
    self._path = path.rstrip('/')
    fileio.makedirs(self._path)
    self._init_times = times.init_times
    self._lead_times = times.lead_times
    self._init_chunk = times.init_time_chunk_size
    self._lead_chunk = (times.lead_time_chunk_size
                        or max(len(times.lead_times), 1))
    # Output (store) chunking decoupled from the COMPUTE chunking — the
    # reference rechunks per-chunk statistics to user-chosen zarr chunks
    # before writing (beam_pipeline.py:671-677, xbeam.Rechunk(...
    # zarr_chunks ...)). Without this, init_chunk=1 runs write one-init
    # zarr chunks: pathological for downstream readers. Compute blocks
    # whose extent doesn't cover a whole output cell are assembled in
    # host-side buffers and flushed when the cell completes.
    self._zarr_chunks = {k: int(v) for k, v in (zarr_chunks or {}).items()}
    # v3 sharding_indexed output: shards group output cells into shard
    # objects; a shard, like a straddling output cell, must be assembled
    # by one process/writer (encoded cells buffer until it completes).
    self._zarr_shards = {k: int(v) for k, v in (zarr_shards or {}).items()}
    if self._zarr_shards and int(zarr_format) != 3:
      raise ValueError('zarr_shards (sharding_indexed) needs zarr_format=3')
    if distributed:
      for d, cc in (('init_time', self._init_chunk),
                    ('lead_time', self._lead_chunk)):
        zc = self._zarr_chunks.get(d)
        if zc is not None and (zc > cc or cc % zc != 0):
          raise ValueError(
              f'distributed zarr output needs zarr_chunks[{d!r}]={zc} to '
              f'divide the compute chunk size {cc}: otherwise one output '
              'cell spans compute chunks owned by different processes and '
              'no single process can assemble it')
        zs = self._zarr_shards.get(d)
        if zs is not None and (zs > cc or cc % zs != 0):
          raise ValueError(
              f'distributed zarr output needs zarr_shards[{d!r}]={zs} to '
              f'divide the compute chunk size {cc}: otherwise one shard '
              'object spans compute chunks owned by different processes '
              'and no single process can assemble it')
    self._compressor = compressor
    self._zarr_format = int(zarr_format)
    self._distributed = distributed
    if self._zarr_format == 3:
      # v3 root node, written eagerly for the same crash-resume reason as
      # the coordinates below. v3 has no consolidated-metadata file; the
      # reader scans per-array zarr.json nodes.
      fileio.write_bytes(
          os.path.join(self._path, 'zarr.json'),
          json.dumps({'zarr_format': 3, 'node_type': 'group',
                      'attributes': {}}).encode())
    self._writers: dict[str, zarr_io.ZarrArrayWriter] = {}
    # (key, cell) -> [partial ndarray buffer, covered element count]
    self._buffers: dict = {}
    self._coord_arrays: dict[str, Coord] = {}
    self._coord_meta: dict[str, dict] = {}
    # Coordinate arrays are written EAGERLY (here and in _make_writer), not
    # in finalize: a run that crashes after all cells are written and then
    # resumes replaying zero chunks has empty _writers/_coord_arrays, and
    # finalize must still be able to consolidate a complete store from
    # disk. In distributed mode every process writes identical bytes.
    self._write_coord('init_time', Coord(('init_time',), self._init_times))
    self._write_coord('lead_time', Coord(('lead_time',), self._lead_times))

  def _out_chunk(self, dim: str, default: int) -> int:
    return self._zarr_chunks.get(dim, default)

  def _write_coord(self, cname: str, c: Coord) -> None:
    self._coord_meta.update(zarr_io._write_array(
        self._path, cname, np.asarray(c.values), c.dims,
        [self._out_chunk(d, self._init_chunk) if d == 'init_time' else
         self._out_chunk(d, self._lead_chunk) if d == 'lead_time' else
         self._out_chunk(d, s)
         for d, s in zip(c.dims, np.shape(c.values))],
        zarr_format=self._zarr_format))

  def _full_size(self, dim: str, chunk_size: int) -> tuple[int, int]:
    if dim == 'init_time':
      return len(self._init_times), self._out_chunk(dim, self._init_chunk)
    if dim == 'lead_time':
      return len(self._lead_times), self._out_chunk(dim, self._lead_chunk)
    return chunk_size, self._out_chunk(dim, chunk_size)

  def _make_writer(self, key: str, da: DimArray) -> zarr_io.ZarrArrayWriter:
    if da.has_coord('mask'):
      raise ValueError(
          f'{key} carries a mask coord; masks have no cell in an '
          'unaggregated store (reference rejects them too, '
          'beam_pipeline.py:592-599). Use masked aggregation instead.')
    shape, chunks = zip(*(self._full_size(d, s)
                          for d, s in zip(da.dims, da.shape)))
    aux = []
    for cname, c in da.coords.items():
      if cname in ('init_time', 'lead_time'):
        continue  # written whole from TimeChunks at the end
      if set(c.dims) & {'init_time', 'lead_time'} and cname != 'valid_time':
        continue  # chunk-local coord with no stable global layout
      if cname not in da.dims:
        aux.append(str(cname))
      if cname in self._coord_arrays:
        continue
      if cname == 'valid_time':
        full = self._init_times[:, None] + self._lead_times[None, :]
        self._coord_arrays[cname] = Coord(('init_time', 'lead_time'), full)
      else:
        self._coord_arrays[cname] = Coord(c.dims, np.asarray(c.values))
      self._write_coord(cname, self._coord_arrays[cname])
    shards = None
    if self._zarr_shards and any(d in self._zarr_shards for d in da.dims):
      shards = [self._zarr_shards.get(d, c)
                for d, c in zip(da.dims, chunks)]
    return zarr_io.ZarrArrayWriter(
        self._path, key, shape, chunks, np.asarray(da.values).dtype,
        da.dims, extra_attrs={'coordinates': ' '.join(aux)} if aux else None,
        compressor=self._compressor, zarr_format=self._zarr_format,
        shards=shards)

  def write_chunk(self, i: int,
                  offsets: time_chunks_lib.TimeChunkOffsets,
                  flat_stats: Mapping[str, DimArray]) -> None:
    """Scatters one compute chunk's '<stat>.<var>' arrays into the store.

    Output cells fully covered by this block are written immediately; cells
    straddling compute-chunk boundaries (zarr_chunks larger than / not
    aligned to the compute grid) accumulate in host buffers until complete
    (the in-process analog of the reference's xbeam.Rechunk shuffle,
    beam_pipeline.py:671-677).
    """
    for key, da in flat_stats.items():
      if key not in self._writers:
        self._writers[key] = self._make_writer(key, da)
      w = self._writers[key]
      starts = []
      for ax, (d, n) in enumerate(zip(da.dims, da.shape)):
        if d == 'init_time':
          starts.append(offsets.init_time)
        elif d == 'lead_time':
          starts.append(offsets.lead_time)
        else:
          starts.append(0)
          if n != w.shape[ax]:
            raise ValueError(
                f'{key}: dim {d!r} is {n} in chunk {i} but {w.shape} in '
                'the template; only init_time/lead_time may vary across '
                'chunks in zarr mode (use the shard-directory mode for '
                'ragged statistics)')
      self._scatter(key, w, starts, np.asarray(da.values))

  def _scatter(self, key: str, w: zarr_io.ZarrArrayWriter,
               starts: list, vals: np.ndarray) -> None:
    grid_ranges = []
    for ax, (st, n) in enumerate(zip(starts, vals.shape)):
      c = w.chunks[ax]
      grid_ranges.append(range(st // c, (st + max(n, 1) - 1) // c + 1))
    for cell in itertools.product(*grid_ranges):
      in_vals, in_buf, cell_shape = [], [], []
      full_cover = True
      for ax, ci in enumerate(cell):
        c = w.chunks[ax]
        cs, ce = ci * c, min((ci + 1) * c, w.shape[ax])
        s0 = max(cs, starts[ax])
        s1 = min(ce, starts[ax] + vals.shape[ax])
        in_vals.append(slice(s0 - starts[ax], s1 - starts[ax]))
        in_buf.append(slice(s0 - cs, s1 - cs))
        cell_shape.append(ce - cs)
        if s0 != cs or s1 != ce:
          full_cover = False
      sub = vals[tuple(in_vals)]
      if full_cover:
        w.write_block(cell, sub)
        continue
      bkey = (key, cell)
      if bkey not in self._buffers:
        buf = np.full(cell_shape,
                      np.nan if w.dtype.kind == 'f' else 0, dtype=w.dtype)
        self._buffers[bkey] = [buf, 0]
      entry = self._buffers[bkey]
      entry[0][tuple(in_buf)] = sub
      entry[1] += sub.size  # TimeChunks tiles disjointly: no double count
      if entry[1] >= int(np.prod(cell_shape)):
        w.write_block(cell, entry[0])
        del self._buffers[bkey]

  def finalize(self) -> str:
    """Writes coordinates + consolidated metadata; returns the path.

    In distributed mode processes own disjoint chunk cells of the same
    store; coordinates/metadata are identical everywhere, so process 0
    writes them after a barrier ensures all cells are on disk.
    """
    # Incomplete output cells (chunks dropped by skip_failed, or a ragged
    # coverage pattern) are flushed as-is: the uncovered region keeps the
    # store's fill value, matching the skip-failed contract.
    for (key, cell), (buf, _) in list(self._buffers.items()):
      self._writers[key].write_block(cell, buf)
    self._buffers.clear()
    # Sharded (v3) writers: flush partial shard objects — absent cells
    # keep the missing-chunk sentinel (readers see the fill value), the
    # same contract as the uncovered-cell fill above.
    for w in self._writers.values():
      w.close()
    if self._distributed and jax.process_count() > 1:
      from jax.experimental import multihost_utils
      multihost_utils.sync_global_devices('wbx_unaggregated_zarr_cells')
      if jax.process_index() != 0:
        return self._path
    path = self._path
    if self._zarr_format == 3:
      # No consolidated metadata in v3: the eager root zarr.json plus the
      # per-array nodes written as cells streamed make the store complete.
      return path
    if not self._writers and fileio.exists(os.path.join(path, '.zmetadata')):
      # A rerun that wrote no chunks (e.g. checkpoint-resume of a finished
      # run): the store on disk is complete — rewriting .zmetadata from
      # this process's empty template would destroy it.
      return path
    metadata: dict = {'.zgroup': {'zarr_format': 2}, '.zattrs': {}}
    fileio.write_bytes(os.path.join(path, '.zgroup'),
                       json.dumps(metadata['.zgroup']).encode())
    metadata.update(self._coord_meta)  # coord arrays were written eagerly
    for key, w in self._writers.items():
      metadata.update(w.metadata)
    # Arrays written by a previous (crashed or resumed) run exist on disk
    # but not in self._writers; fold their per-array metadata in so the
    # consolidated index covers the whole store, not just this process's
    # writes.
    for akey, ameta in zarr_io._read_store_metadata(path).items():
      metadata.setdefault(akey, ameta)
    fileio.write_bytes_atomic(
        os.path.join(path, '.zmetadata'),
        json.dumps({'metadata': metadata, 'zarr_consolidated_format': 1},
                   default=zarr_io._json_default).encode())
    return path



@dataclasses.dataclass
class UnaggregatedPipeline:
  """Computes per-chunk statistics and streams them to a store.

  Attributes:
    metrics: metric name → Metric (statistics are deduplicated across them).
    predictions_loader / targets_loader / times: as in EvaluationPipeline.
    out_path: ``*.zarr`` → streaming Zarr v2 store (standard format, open
      with xarray or ``zarr_io.open_dataset_zarr``); anything else → a
      directory of per-chunk ``.wbx`` shards + manifest.
    mesh / dim_to_axis: optional SPMD placement, same contract as
      ChunkEvaluator.
  """

  metrics: Mapping[str, metrics_base.Metric]
  predictions_loader: data_base.DataLoader
  targets_loader: data_base.DataLoader
  times: time_chunks_lib.TimeChunks
  out_path: str
  prefetch: int = 2
  mesh: Optional[jax.sharding.Mesh] = None
  dim_to_axis: Optional[Mapping[str, str]] = None
  distributed: bool = False
  compressor: Optional[str] = None  # zarr cells: None/'zlib'/'zstd'/'blosc'
  zarr_format: int = 2  # 3: zarr v3 store layout (zarr.json nodes)
  # Output store chunk sizes per dim (e.g. {'init_time': 64}); defaults to
  # the compute chunking. The reference's xbeam.Rechunk zarr_chunks analog.
  zarr_chunks: Optional[Mapping[str, int]] = None
  # v3 only: shard object sizes per dim (elements, rounded up to a chunk
  # multiple) — emits the sharding_indexed codec layout zarr-python 3
  # consumers default to for many-small-chunk stores.
  zarr_shards: Optional[Mapping[str, int]] = None
  # Transient-failure policy for chunk loads (see pipeline.RetryPolicy).
  # With ``skip_failed`` a dropped chunk's cells keep the store's fill
  # value (NaN) and are listed in ``failed_chunks`` after the run.
  retry: Optional[pipeline_lib.RetryPolicy] = None
  failed_chunks: list = dataclasses.field(default_factory=list, init=False)

  def __post_init__(self):
    # Reuse the evaluator's host preparation + single-put (optionally
    # mesh-sharded) placement; only the jitted step differs (raw
    # statistics, no aggregation).
    self._evaluator = evaluator_lib.ChunkEvaluator(
        metrics=self.metrics,
        aggregator=aggregation_lib.Aggregator(reduce_dims=()),
        mesh=self.mesh, dim_to_axis=self.dim_to_axis)
    self._stats_fn = jax.jit(self._compute_stats)

  def _compute_stats(self, predictions, targets, resources=None):
    # Climatologies (and any other long-lived statistic arrays) arrive as
    # device ARGUMENTS, not trace-time constants — otherwise every compiled
    # program embeds >100 MB of dayofyear×hour climatology at 0.25°, the
    # same oversized-payload failure ChunkEvaluator._eval_fn avoids.
    with metrics_base.device_resources(resources):
      return metrics_base.compute_unique_statistics_for_all_metrics(
          self.metrics, predictions, targets)

  def _chunk_stats(self, predictions, targets) -> dict[str, DimArray]:
    p, t = self._evaluator.prepare_pair(predictions, targets)
    stats = self._stats_fn(p, t, self._evaluator.resources())
    # One overlapped device→host fetch of the whole stats tree (vs a
    # blocking round trip per leaf inside restore_time_coords).
    stats = jax.device_get(stats)
    flat = {}
    for stat_name, stat_vars in stats.items():
      for var_name, da in stat_vars.items():
        flat[f'{stat_name}.{var_name}'] = (
            evaluator_lib.restore_time_coords(da))
    return flat

  def _load(self, chunk):
    return pipeline_lib.load_chunk_pair(
        self.predictions_loader, self.targets_loader, chunk)

  def _stream(self):
    return pipeline_lib.stream_chunk_pairs(
        self._load, self.times, prefetch=self.prefetch,
        distributed=self.distributed, retry=self.retry,
        obs=observability.default_metrics,
        on_failure=lambda i, offsets, e: self.failed_chunks.append(
            (i, offsets, f'{type(e).__name__}: {e}')))

  def run(self) -> str:
    self.failed_chunks = []
    if self.out_path.rstrip('/').endswith('.zarr'):
      return self._run_zarr()
    if self.distributed and jax.process_count() > 1:
      raise ValueError(
          'distributed unaggregated output needs a *.zarr out_path: '
          'each process writes its own disjoint cells of one store (the '
          'shard-directory manifest has a single writer)')
    return self._run_shards()

  # -- Zarr mode ---------------------------------------------------------------

  def _run_zarr(self) -> str:
    """One zarr chunk per (TimeChunk, variable): no rechunk shuffle."""
    store = ZarrStatsStore(self.times, self.out_path,
                           compressor=self.compressor,
                           distributed=self.distributed,
                           zarr_chunks=self.zarr_chunks,
                           zarr_format=self.zarr_format,
                           zarr_shards=self.zarr_shards)
    for i, offsets, (predictions, targets) in self._stream():
      store.write_chunk(i, offsets,
                        self._chunk_stats(predictions, targets))
    return store.finalize()

  # -- shard-directory mode ------------------------------------------------------

  def _run_shards(self) -> str:
    """One .wbx shard per chunk + manifest (ragged/sparse-safe)."""
    os.makedirs(self.out_path, exist_ok=True)
    manifest = {'version': 1, 'shards': []}
    for i, offsets, (predictions, targets) in self._stream():
      flat = self._chunk_stats(predictions, targets)
      shard = f'chunk_{i:06d}.wbx'
      io_lib.save_dataset(os.path.join(self.out_path, shard), flat)
      manifest['shards'].append({
          'path': shard,
          'init_time_offset': offsets.init_time,
          'lead_time_offset': offsets.lead_time,
      })
    tmp = os.path.join(self.out_path, 'manifest.json.tmp')
    with open(tmp, 'w') as f:
      json.dump(manifest, f)
    os.replace(tmp, os.path.join(self.out_path, 'manifest.json'))
    return self.out_path


def load_unaggregated(path: str) -> dict[str, DimArray]:
  """Assembles unaggregated statistics into full arrays (either mode)."""
  from weatherbenchx_tpu import darray

  if path.rstrip('/').endswith('.zarr'):
    ds = zarr_io.open_dataset_zarr(path.rstrip('/'))
    return {k: v.copy(data=np.asarray(v.data)) for k, v in ds.items()}

  with open(os.path.join(path, 'manifest.json')) as f:
    manifest = json.load(f)
  shards = sorted(manifest['shards'],
                  key=lambda s: (s['init_time_offset'],
                                 s['lead_time_offset']))
  # Group shards into rows by init offset, concat leads, then concat inits.
  by_init: dict[int, list] = {}
  for s in shards:
    by_init.setdefault(s['init_time_offset'], []).append(
        io_lib.load_dataset(os.path.join(path, s['path'])))

  out: dict[str, DimArray] = {}
  first_row = next(iter(by_init.values()))
  for key in first_row[0].keys():
    rows = []
    for init_offset in sorted(by_init):
      row = [ds[key] for ds in by_init[init_offset]]
      if len(row) > 1 and 'lead_time' in row[0].dims:
        rows.append(darray.concat(row, 'lead_time'))
      else:
        rows.append(row[0])
    if len(rows) > 1 and 'init_time' in rows[0].dims:
      out[key] = darray.concat(rows, 'init_time')
    else:
      out[key] = rows[0]
  return out


def define_unaggregated_pipeline(
    metrics: Mapping[str, metrics_base.Metric],
    predictions_loader: data_base.DataLoader,
    targets_loader: data_base.DataLoader,
    times: time_chunks_lib.TimeChunks,
    out_path: str,
    **kwargs,
) -> str:
  """One-call unaggregated run (the reference API's entry-point shape)."""
  return UnaggregatedPipeline(
      metrics=metrics, predictions_loader=predictions_loader,
      targets_loader=targets_loader, times=times, out_path=out_path,
      **kwargs).run()
