"""The evaluation driver loop: TimeChunks → load → eval → reduce → write.

This replaces the reference's Beam pipeline (``beam_pipeline.py:407-485``)
with a single-controller loop:

* ``beam.Create`` fan-out          → host enumeration of TimeChunks, with
                                     async double-buffered loading
                                     (ThreadPoolExecutor prefetch).
* Beam ``CombinePerKey`` sum       → on-device tree add per offset bucket
                                     (XLA collectives across the mesh).
* ``ConcatPerStatisticPerVariable``→ host zero-filled outer-join of bucket
                                     states (preserved chunked dims concat).
* ``WriteMetrics`` atomic netCDF   → atomic npz write (tmp + rename).
* (new) checkpoint/resume          → running state persisted every K chunks;
                                     the monoid makes resume exact.
"""

import dataclasses
import json
import logging
import os
import time
from concurrent import futures
from typing import Callable, Hashable, Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from weatherbenchx_tpu import aggregation as aggregation_lib
from weatherbenchx_tpu import fileio
from weatherbenchx_tpu import io as io_lib
from weatherbenchx_tpu import observability
from weatherbenchx_tpu import time_chunks as time_chunks_lib
from weatherbenchx_tpu import tree
from weatherbenchx_tpu.darray import Coord, DimArray
from weatherbenchx_tpu.data import base as data_base
from weatherbenchx_tpu.metrics import base as metrics_base
from weatherbenchx_tpu.parallel import evaluator as evaluator_lib

logger = logging.getLogger(__name__)


def _cpu_device():
  """The local CPU device, on which host-side chunk preparation runs.

  Raises rather than falling back to the accelerator: loader work placed
  on the GPU would cost a device round trip per eager op, silently.
  """
  try:
    return jax.local_devices(backend='cpu')[0]
  except RuntimeError as e:
    raise RuntimeError(
        'The host CPU backend is not available. Leave JAX_PLATFORMS unset '
        "or include cpu in it (e.g. JAX_PLATFORMS='cuda,cpu').") from e


def atomic_write_dataset(path: str, dataset: Mapping[str, DimArray]) -> None:
  """tmp+rename write, safe against duplicate/straggler attempts.

  Mirrors reference ``beam_utils.py:64-101``; remote URLs (gs://, s3://,
  memory://, ...) go through fsspec (``fileio.py``).
  """
  fileio.save_dataset_atomic(path, dataset)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
  """Transient-failure policy for chunk loads.

  The reference delegates worker fault tolerance entirely to the Beam
  runner (Dataflow retries a failed bundle 4 times, then fails the job —
  ``docs/source/beam_dataflow.md:20-57``; nothing in-repo). Here the
  policy is explicit and in-repo: each chunk load retries transient
  errors with exponential backoff, and — opt-in — chunks that still fail
  can be skipped and reported instead of failing the run. Because the
  accumulated ``AggregationState`` is a monoid, a run with skipped chunks
  is exactly recoverable: re-run just the failed chunks (e.g. from the
  failures sidecar written by ``run_and_write``) and sum the saved states.

  Attributes:
    retries: max re-attempts per chunk load after the first failure.
    backoff_s: first retry delay; attempt k sleeps ``backoff_s * 2**k``.
    max_backoff_s: delay cap.
    retryable: exception classes classified as transient. Defaults to the
      I/O family (OSError covers ConnectionError/TimeoutError and
      fsspec/network errors); programming errors (KeyError, shape
      mismatches, ...) are never retried or skipped — they fail fast.
    skip_failed: if True, a chunk whose retries are exhausted is dropped
      from the stream (recorded via the pipeline's ``failed_chunks`` and
      the observability counter ``chunks_failed``) instead of raising.
  """
  retries: int = 3
  backoff_s: float = 1.0
  max_backoff_s: float = 30.0
  retryable: tuple = (OSError,)
  skip_failed: bool = False


def _load_with_retries(load_fn, chunk, retry: RetryPolicy, obs=None):
  attempt = 0
  while True:
    try:
      return load_fn(chunk)
    except retry.retryable as e:
      if attempt >= retry.retries:
        raise
      delay = min(retry.backoff_s * (2 ** attempt), retry.max_backoff_s)
      attempt += 1
      if obs is not None:
        obs.counter('load_retries')
      logger.warning('chunk load failed (%s: %s); retry %d/%d in %.1fs',
                     type(e).__name__, e, attempt, retry.retries, delay)
      time.sleep(delay)


def load_chunk_pair(
    predictions_loader: data_base.DataLoader,
    targets_loader: data_base.DataLoader,
    chunk: time_chunks_lib.TimeChunk,
    obs: Optional[observability.Metrics] = None,
):
  """Loads one (predictions, targets) chunk pair on the host CPU backend.

  Loader-side eager ops (selection, interpolation gathers) run on the
  local CPU backend: dispatching them to the accelerator costs a
  host round trip per op and wastes device time. The jitted eval step
  transfers the prepared chunk to the mesh in one hop.
  """
  init_times, lead_times = chunk
  t0 = time.monotonic()
  with jax.default_device(_cpu_device()):
    targets = targets_loader.load_chunk(init_times, lead_times)
    t1 = time.monotonic()
    predictions = predictions_loader.load_chunk(
        init_times, lead_times, reference=targets)
  t2 = time.monotonic()
  if obs is not None:
    obs.record('load_targets_seconds', t1 - t0)
    obs.record('load_predictions_seconds', t2 - t1)
  logger.info('loaded chunk: targets %.0fms predictions %.0fms',
              (t1 - t0) * 1e3, (t2 - t1) * 1e3)
  return predictions, targets


def stream_chunk_pairs(
    load_fn: Callable,
    times: time_chunks_lib.TimeChunks,
    prefetch: int = 2,
    distributed: bool = False,
    start_chunk: int = 0,
    retry: Optional[RetryPolicy] = None,
    obs: Optional[observability.Metrics] = None,
    on_failure: Optional[Callable] = None,
):
  """Yields (index, offsets, load_fn(chunk)) with threaded prefetch.

  Shared by the aggregated and unaggregated pipelines (the Beam fan-out +
  worker-local prefetch analog). In distributed mode each process keeps
  the chunk indices with ``index % process_count == process_index``.

  ``retry`` applies :class:`RetryPolicy` to each load; with
  ``retry.skip_failed`` a chunk whose (transient-classified) failure
  survives all retries is reported via ``on_failure(index, offsets, exc)``
  and dropped from the stream instead of raising.
  """
  if retry is not None and retry.retries > 0:
    inner, load_fn = load_fn, (
        lambda chunk: _load_with_retries(inner, chunk, retry, obs))
  items = list(enumerate(times.iter_with_chunk_offsets()))
  if distributed:
    pc, pi = jax.process_count(), jax.process_index()
    items = [it for it in items if it[0] % pc == pi]
  items = [it for it in items if it[0] >= start_chunk]
  if not items:
    return
  with futures.ThreadPoolExecutor(max_workers=max(prefetch, 1)) as ex:
    pending = []
    it = iter(items)
    for _ in range(max(prefetch, 1)):
      try:
        i, (offsets, chunk) = next(it)
        pending.append((i, offsets, ex.submit(load_fn, chunk)))
      except StopIteration:
        break
    while pending:
      i, offsets, fut = pending.pop(0)
      try:
        result = fut.result()
      except BaseException as e:
        # Only transient-classified failures are skippable; programming
        # errors always fail the run (a bug that skipped every chunk
        # would otherwise masquerade as a clean empty result).
        if not (retry is not None and retry.skip_failed
                and isinstance(e, retry.retryable)):
          raise
        logger.error('chunk %d failed after %d retries, skipping: %s: %s',
                     i, retry.retries, type(e).__name__, e)
        if obs is not None:
          obs.counter('chunks_failed')
        if on_failure is not None:
          on_failure(i, offsets, e)
        result = None
      if result is not None:
        yield i, offsets, result
      try:
        j, (offs2, chunk2) = next(it)
        pending.append((j, offs2, ex.submit(load_fn, chunk2)))
      except StopIteration:
        pass


class _InflightWindow:
  """Backpressure window over asynchronously-dispatched chunks.

  Async accelerator queues would otherwise accept the ENTIRE dataset:
  every staged host->device transfer stays referenced until its step
  runs, so host RSS grows with the store, defeating streaming.
  Bound the STAGED BYTES in flight: when the window exceeds
  ``max_bytes``, fetch one tiny state leaf (weights) of the oldest windowed
  chunk — state is a dependency chain, so the fetch synchronizes everything
  up to that chunk. The byte gate keeps small-chunk workloads free of the
  per-fetch host round trip while still capping memory for year-scale
  chunks.

  The per-chunk state-leaf tokens are additionally capped at
  ``max_tokens`` so a long run doesn't pin one historical device buffer per
  chunk: entries past the cap drop the buffer reference (the live state
  chain no longer needs it) but KEEP their staged-bytes accounting — those
  host->device transfers are still pending, and forgetting them would let
  the byte total plateau below the budget so the synchronizing fetch never
  fires (unbounded dispatch). Only the newest ``max_tokens`` entries ever
  hold tokens: each push nulls the one entry crossing the boundary, and
  front-pops preserve the invariant.
  """

  def __init__(self, max_bytes: int, max_tokens: int = 64,
               fetch=lambda token: np.asarray(jax.device_get(token))):
    self.max_bytes = max_bytes
    self.max_tokens = max_tokens
    self._fetch = fetch
    self.entries: list = []  # (state leaf token | None, staged bytes)
    self.total_bytes = 0

  def push(self, token, staged_bytes: int) -> None:
    self.entries.append((token, staged_bytes))
    self.total_bytes += staged_bytes
    if len(self.entries) > self.max_tokens:
      j = len(self.entries) - self.max_tokens - 1
      self.entries[j] = (None, self.entries[j][1])
    while self.total_bytes > self.max_bytes and len(self.entries) > 1:
      # Bytes may only leave the accounting once a fetch PROVES the device
      # consumed them: advance to the first tokened entry (trimmed,
      # token-less entries can't synchronize on their own, but fetching a
      # later token synchronizes everything before it in the state chain)
      # and drop it together with its token-less prefix.
      j = next(i for i, (t, _) in enumerate(self.entries) if t is not None)
      if j >= len(self.entries) - 1:
        break  # only the newest entry holds a token; keep pipeline depth 1
      token = self.entries[j][0]
      for _ in range(j + 1):
        _, nbytes = self.entries.pop(0)
        self.total_bytes -= nbytes
      self._fetch(token)


@dataclasses.dataclass
class EvaluationPipeline:
  """Chunked, sharded, restartable evaluation.

  Attributes:
    metrics: metric name → Metric.
    aggregator: the Aggregator.
    predictions_loader / targets_loader: DataLoaders.
    times: TimeChunks enumeration.
    mesh: optional device mesh for SPMD execution.
    dim_to_axis: dim → mesh axis map (see ChunkEvaluator).
    prefetch: number of chunks to load ahead of the device (host threads).
    chunks_per_dispatch: number of structurally-identical chunks evaluated
      per XLA dispatch (vmapped inside one program). >1 amortizes the
      per-dispatch host↔device round trip, which dominates for small
      chunks.
    checkpoint_path: if set, running state is saved here every
      ``checkpoint_every`` chunks and resumed from on restart.
    distributed: multi-host mode — with ``jax.distributed`` initialized,
      each process owns the chunk indices with
      ``index %% process_count == process_index`` (data parallelism over
      time chunks, the Beam fan-out across workers), accumulates its own
      partial state, and the final monoid sum is taken across processes
      via an all-gather over DCN. Each process writes (and resumes from)
      its own per-process checkpoint; the manifest records the process
      count and resume validates it.
  """

  metrics: Mapping[str, metrics_base.Metric]
  aggregator: aggregation_lib.Aggregator
  predictions_loader: data_base.DataLoader
  targets_loader: data_base.DataLoader
  times: time_chunks_lib.TimeChunks
  mesh: Optional[jax.sharding.Mesh] = None
  dim_to_axis: Optional[Mapping[str, str]] = None
  prefetch: int = 2
  chunks_per_dispatch: int = 1
  checkpoint_path: Optional[str] = None
  checkpoint_every: int = 0
  metrics_registry: Optional[observability.Metrics] = None
  profile_dir: Optional[str] = None
  distributed: bool = False
  max_in_flight_bytes: int = 2 << 30
  # Transient-failure policy for chunk loads (retry with backoff; optional
  # skip-and-report). After a run with ``retry.skip_failed``, the chunks
  # that were dropped are listed in ``self.failed_chunks`` as
  # (chunk index, offsets, error string); ``run_and_write`` additionally
  # persists them next to the metrics output so the failed slice can be
  # re-run and monoid-summed into the saved AggregationState.
  retry: Optional[RetryPolicy] = None
  failed_chunks: list = dataclasses.field(default_factory=list, init=False)
  # Optional per-chunk raw-statistics sink, called as
  # sink(i, offsets, {'<stat>.<var>': DimArray}) with the SAME prepared,
  # device-placed chunk the aggregated step consumes — unaggregated output
  # streams from one storage pass instead of a second pipeline (reference
  # computes both in one Beam graph, ``beam_pipeline.py:449-540``).
  chunk_stats_sink: Optional[Callable] = None

  def __post_init__(self):
    self._obs = self.metrics_registry or observability.default_metrics
    self._evaluator = evaluator_lib.ChunkEvaluator(
        metrics=self.metrics, aggregator=self.aggregator,
        mesh=self.mesh, dim_to_axis=self.dim_to_axis)
    reduce_dims = set(self.aggregator.reduce_dims)
    self._bucket_dims = tuple(
        d for d in ('init_time', 'lead_time') if d not in reduce_dims)
    self._eval_and_stats_fn = None
    if self.chunk_stats_sink is not None:
      # ONE program returning (state, raw statistics): XLA computes each
      # statistic once and feeds both the fused aggregation and the sink
      # outputs — no second dispatch, no duplicate compute.
      def eval_and_stats(p, t, operands=None, resources=None):
        with metrics_base.device_resources(resources):
          stats = metrics_base.compute_unique_statistics_for_all_metrics(
              self.metrics, p, t)
          return self.aggregator.aggregate_statistics(stats, operands), stats
      self._eval_and_stats_fn = jax.jit(eval_and_stats)

  # -- chunk loading ---------------------------------------------------------

  def _load(self, chunk: time_chunks_lib.TimeChunk):
    return load_chunk_pair(self.predictions_loader, self.targets_loader,
                           chunk, obs=self._obs)

  def _chunk_stream(self, start_chunk: int = 0):
    """Yields (index, offsets, (predictions, targets)) with async prefetch.

    ``start_chunk`` filters already-completed chunks BEFORE their loads are
    submitted, so resuming a mostly-done run doesn't re-read (and discard)
    every completed chunk from storage.
    """
    # self._load looked up per call so tests/wrappers can substitute it.
    yield from stream_chunk_pairs(
        lambda chunk: self._load(chunk), self.times,
        prefetch=self.prefetch, distributed=self.distributed,
        start_chunk=start_chunk, retry=self.retry, obs=self._obs,
        on_failure=lambda i, offsets, e: self.failed_chunks.append(
            (i, offsets, f'{type(e).__name__}: {e}')))

  def _prepared_stream(self, start_chunk: int = 0):
    """Chunk stream with host preparation + device staging pipelined.

    ``prepare_pair`` (host dtype/coord conversion + the single batched
    device_put) runs one chunk ahead in a worker thread, overlapping the
    next chunk's transfer with the current chunk's dispatch/accumulate.
    """
    def prep(pair):
      prepared = self._evaluator.prepare_pair(*pair)
      return prepared, evaluator_lib.batchable_signature(*prepared)

    with futures.ThreadPoolExecutor(max_workers=1) as ex:
      pending: list = []
      for i, offsets, chunk_pair in self._chunk_stream(start_chunk):
        pending.append((i, offsets, ex.submit(prep, chunk_pair)))
        if len(pending) > 1:
          j, offs, fut = pending.pop(0)
          prepared, sig = fut.result()
          yield j, offs, prepared, sig
      for j, offs, fut in pending:
        prepared, sig = fut.result()
        yield j, offs, prepared, sig

  # -- checkpointing -----------------------------------------------------------

  def _ckpt_prefix(self) -> str:
    """Checkpoint file prefix; per-process in distributed mode.

    In distributed mode every process owns its own modulo-slice of the
    chunk list, so each process must checkpoint (and resume) its OWN
    partial state — a shared checkpoint would make every process resume
    from process 0's partial sums, multiply-counting them in the final
    all-gather while dropping everyone else's.
    """
    if self.distributed and jax.process_count() > 1:
      return f'{self.checkpoint_path}.p{jax.process_index()}'
    return self.checkpoint_path

  def _ckpt_manifest(self) -> str:
    return f'{self._ckpt_prefix()}.manifest.json'

  def _save_checkpoint(self, buckets, next_chunk: int) -> None:
    # Bucket files alternate between two generations so a save never
    # overwrites the files the CURRENT manifest points at: a crash anywhere
    # before the final atomic manifest replace leaves the previous
    # (manifest, buckets) set fully intact. Overwriting in place instead
    # would let a crash between bucket writes and the manifest write leave
    # the OLD next_chunk pointing at NEW bucket sums — resume would then
    # re-add already-counted chunks.
    gen = 1 - getattr(self, '_ckpt_gen', 1)
    manifest = {
        'next_chunk': next_chunk,
        'generation': gen,
        'process_index': jax.process_index() if self.distributed else 0,
        'process_count': jax.process_count() if self.distributed else 1,
        'buckets': [],
    }
    for k, (key, state) in enumerate(sorted(buckets.items())):
      # .wbx: thread-parallel raw block writes (native core) — checkpoints
      # are the pipeline's hottest host I/O. Remote checkpoint paths write
      # portable npz bytes through fsspec instead.
      path = f'{self._ckpt_prefix()}.g{gen}.bucket{k}.wbx'
      ds = state.to_host().to_dataset()
      if fileio.is_remote(path):
        fileio.write_bytes_atomic(path, io_lib.dumps_dataset(ds))
      else:
        tmp = f'{path}.tmp.wbx'  # suffix picks the block container
        io_lib.save_dataset(tmp, ds)
        os.replace(tmp, path)
      # Live (pre-float64-upcast) dtypes, so resume restores exactly.
      dtypes = {}
      for part, mapping in (('ws', state.sum_weighted_statistics),
                            ('w', state.sum_weights)):
        for p, leaf in tree.flatten_with_paths(mapping).items():
          dtypes['#'.join((part,) + tuple(map(str, p)))] = str(
              np.asarray(leaf.data).dtype
              if isinstance(leaf.data, np.ndarray) else leaf.data.dtype)
      manifest['buckets'].append(
          {'key': list(key), 'path': path, 'dtypes': dtypes})
    fileio.write_text_atomic(self._ckpt_manifest(), json.dumps(manifest))
    self._ckpt_gen = gen  # flip only once the manifest commit succeeded

  def _load_checkpoint(self):
    if not self.checkpoint_path or not fileio.exists(self._ckpt_manifest()):
      return {}, 0
    manifest = json.loads(fileio.read_text(self._ckpt_manifest()))
    # Next save writes the OTHER generation, preserving the files this
    # manifest references until the new manifest lands.
    self._ckpt_gen = manifest.get('generation', 1)
    want_count = jax.process_count() if self.distributed else 1
    have_count = manifest.get('process_count', 1)
    if have_count != want_count:
      raise ValueError(
          f'Checkpoint {self._ckpt_manifest()} was written by a run with '
          f'{have_count} processes, but this run has {want_count}. The '
          'chunk→process assignment (index % process_count) would differ, '
          'so resuming would double-count or drop chunks. Restart with the '
          'same process count or remove the checkpoint.')
    buckets = {}
    for b in manifest['buckets']:
      state = aggregation_lib.AggregationState.from_dataset(
          fileio.load_dataset_any(b['path']))
      buckets[tuple(b['key'])] = _restore_state_to_device(
          state, b.get('dtypes'))
    logger.info('resuming from checkpoint at chunk %d', manifest['next_chunk'])
    return buckets, manifest['next_chunk']

  # -- main loop -----------------------------------------------------------------

  def run(self) -> aggregation_lib.AggregationState:
    """Evaluates all chunks; returns the total AggregationState."""
    self.failed_chunks: list = []
    buckets, start_chunk = self._load_checkpoint()
    n = len(self.times)

    bucket_sigs: dict = {}  # bucket key -> prepared-pair signature

    def bucket_key(offsets):
      return tuple(
          getattr(offsets, d) if d in self._bucket_dims else -1
          for d in ('init_time', 'lead_time'))

    window = _InflightWindow(self.max_in_flight_bytes)

    def throttle(state, staged_bytes: int):
      if self.max_in_flight_bytes <= 0:
        return
      for leaf in tree.flatten_with_paths(state.sum_weights).values():
        window.push(leaf.data, staged_bytes)
        break

    def pair_bytes(pair) -> int:
      return sum(getattr(leaf, 'nbytes', 0)
                 for leaf in jax.tree_util.tree_leaves(pair))

    local_done = [0]

    def bookkeeping(i, key, staged_bytes):
      self._obs.counter('chunks_done')
      throttle(buckets[key], staged_bytes)
      # Each process checkpoints its own partial state (see _ckpt_prefix).
      # Cadence counts chunks THIS process completed, not the global chunk
      # index: in distributed mode a process only sees indices with its
      # residue mod process_count, which may never satisfy a global
      # (i+1) % checkpoint_every == 0 test.
      local_done[0] += 1
      if (self.checkpoint_path and self.checkpoint_every
          and local_done[0] % self.checkpoint_every == 0):
        with self._obs.timed('checkpoint_seconds'):
          buckets[key].block_until_ready()
          self._save_checkpoint(buckets, i + 1)
      logger.info('chunk %d/%d done', i + 1, n)

    def emit_stats(i, offsets, stats, stripped_coords):
      # Statistics were computed from the lean (retrace-free) pair; put the
      # stripped per-row host coords (station names, row labels) back so the
      # sink's output stays interpretable.
      # One overlapped device→host fetch of the whole stats tree: fetching
      # leaf-by-leaf inside restore_time_coords would pay a blocking
      # transfer per statistic×variable×coord.
      stats = jax.device_get(stats)
      flat = {}
      for stat_name, stat_vars in stats.items():
        for var_name, da in stat_vars.items():
          da = evaluator_lib.restore_time_coords(da)
          for cname, c in (stripped_coords.get(var_name) or {}).items():
            if not da.has_coord(cname) and all(
                da.sizes.get(d) == n
                for d, n in zip(c.dims, np.shape(c.values))):
              da = da.assign_coords(**{cname: c})
          flat[f'{stat_name}.{var_name}'] = da
      with self._obs.timed('chunk_stats_sink_seconds'):
        self.chunk_stats_sink(i, offsets, flat)

    def absorb(i, offsets, pair, pair_sig):
      """Folds one prepared chunk into its bucket.

      Same-layout follow-up chunks fuse evaluation with the running-bucket
      add in ONE dispatch; first-of-bucket or layout-changed chunks take
      the eval + general-add path.
      """
      key = bucket_key(offsets)
      # Fusing evaluation with the bucket add saves one dispatch per chunk
      # but passes the ~40 on-device bucket-state leaves as arguments;
      # opt-in until measured on the card (ROADMAP 1.1).
      fused = os.environ.get('WBX_FUSED_ACCUM', '0') == '1'
      if self._eval_and_stats_fn is not None:
        ops = self._evaluator.operands_for(*pair)
        stripped = self._evaluator.stripped_ragged_coords(*pair)
        lean = self._evaluator.lean_pair(*pair)
        state, stats = self._eval_and_stats_fn(
            lean[0], lean[1], ops, self._evaluator.resources())
        emit_stats(i, offsets, stats, stripped)
        if key in buckets:
          buckets[key] = _device_add(buckets[key], state)
        else:
          buckets[key] = state
      elif fused and key in buckets and bucket_sigs.get(key) == pair_sig:
        buckets[key] = self._evaluator.eval_accum(pair, buckets[key])
      else:
        state = self._evaluator.eval_prepared([pair])[0]
        if key in buckets:
          buckets[key] = _device_add(buckets[key], state)
        else:
          buckets[key] = state
      bucket_sigs[key] = pair_sig
      bookkeeping(i, key, pair_bytes(pair))

    batch: list = []  # buffered (i, offsets, prepared_pair, sig)

    def flush():
      if not batch:
        return
      with self._obs.timed('eval_chunk_seconds'):
        states = self._evaluator.eval_prepared([p for _, _, p, _ in batch])
      for (i, offsets, pair, _), state in zip(batch, states):
        key = bucket_key(offsets)
        if key in buckets:
          buckets[key] = _device_add(buckets[key], state)
        else:
          buckets[key] = state
        bookkeeping(i, key, pair_bytes(pair))
      batch.clear()

    group = max(int(self.chunks_per_dispatch), 1)
    sig = None
    with observability.maybe_profile(self.profile_dir):
      for i, offsets, pair, this_sig in self._prepared_stream(start_chunk):
        if group == 1 or self._eval_and_stats_fn is not None:
          with self._obs.timed('eval_chunk_seconds'):
            absorb(i, offsets, pair, this_sig)
          continue
        if batch and this_sig != sig:
          flush()  # layout changed (e.g. ragged tail): don't mix dispatches
        sig = this_sig
        batch.append((i, offsets, pair, this_sig))
        if len(batch) >= group:
          flush()
      flush()

    # Final cross-bucket combine on host (outer join concat of preserved
    # chunked dims), with time coords restored to datetime64/timedelta64.
    # ONE batched device_get for every bucket: a per-bucket to_host() loop
    # pays a blocking transfer per bucket; to_host() on the already-fetched
    # states is then just the float64 upcast.
    host_buckets = jax.device_get(list(buckets.values()))
    states = [
        s.to_host().map(evaluator_lib.restore_time_coords)
        for s in host_buckets
    ]
    total = aggregation_lib.AggregationState.sum(states)
    if self.distributed and jax.process_count() > 1:
      total = _allgather_sum_states(total)
    return total

  def run_and_write(
      self,
      out_path: Optional[str] = None,
      aggregation_state_out_path: Optional[str] = None,
  ) -> dict[str, DimArray]:
    """Runs the pipeline, writes metric values (and optionally the state)."""
    state = self.run()
    values = state.metric_values(self.metrics)
    if out_path:
      atomic_write_dataset(out_path, values)
      if self.failed_chunks:
        # Sidecar listing the skipped chunks so the failed slice can be
        # re-run and monoid-summed into the saved state.
        fileio.write_text_atomic(
            f'{out_path}.failures.json',
            json.dumps([
                {'chunk': i,
                 'offsets': dataclasses.asdict(o) if dataclasses.is_dataclass(o)
                 else str(o),
                 'error': err}
                for i, o, err in self.failed_chunks
            ], indent=2, default=str))
    if aggregation_state_out_path:
      atomic_write_dataset(aggregation_state_out_path, state.to_dataset())
    return values


def _allgather_bytes(payload: bytes) -> list[bytes]:
  """All-gathers one variable-length byte string per process over DCN.

  Two collectives total: a length exchange, then one padded uint8 gather.
  """
  from jax.experimental import multihost_utils

  lengths = np.asarray(multihost_utils.process_allgather(
      np.array([len(payload)], dtype=np.int64))).reshape(-1)
  max_len = max(int(lengths.max()), 1)
  padded = np.zeros(max_len, dtype=np.uint8)
  padded[:len(payload)] = np.frombuffer(payload, dtype=np.uint8)
  gathered = np.asarray(multihost_utils.process_allgather(padded))
  gathered = gathered.reshape(len(lengths), max_len)
  return [gathered[p, :int(lengths[p])].tobytes() for p in range(len(lengths))]


def _allgather_sum_states(
    total: aggregation_lib.AggregationState,
) -> aggregation_lib.AggregationState:
  """Monoid sum of per-process partial states over DCN.

  Serializes each process's (tiny, aggregated) state to bytes and
  all-gathers once, then takes the generic zero-filled outer-join sum on
  the host. Serialization makes the collective layout-independent: ragged
  per-process results (different station sets, different preserved-dim
  coords) and chunk-starved processes holding the zero state all
  participate in the same fixed-shape byte gather, and the outer-join sum
  aligns whatever comes back.
  """
  payload = (b'' if total.sum_weighted_statistics is None
             else io_lib.dumps_dataset(total.to_dataset()))
  parts = []
  for blob in _allgather_bytes(payload):
    if not blob:
      continue  # a process that processed zero chunks
    parts.append(aggregation_lib.AggregationState.from_dataset(
        io_lib.loads_dataset(blob)))
  return aggregation_lib.AggregationState.sum(parts)


def _restore_state_to_device(
    state: aggregation_lib.AggregationState,
    dtypes: Optional[Mapping[str, str]] = None,
) -> aggregation_lib.AggregationState:
  """Places a checkpoint-loaded (host/float64) state back on device.

  Restores the running-bucket layout the evaluator produces — float32 data
  and int64-seconds time coords as device leaves — so accumulation resumes
  on the device fast path (bit-identical to the uninterrupted run) instead
  of falling back to host outer-joins for every remaining chunk. One
  batched device_put for the whole state.
  """
  def convert(x: DimArray, want: Optional[str]) -> DimArray:
    d = np.asarray(x.data)
    if want is not None:
      d = d.astype(want)
    elif d.dtype == np.float64:
      d = d.astype(np.float32)
    coords = {}
    pending_names = []
    for name, c in x.coords.items():
      v = np.asarray(c.values)
      if (evaluator_lib._CONVERTED_TIME_COORDS.get(str(name))
          and v.dtype.kind in 'iu'):
        pending_names.append(name)
      coords[name] = Coord(c.dims, v)
    return DimArray(d, x.dims, coords), pending_names

  converted = {}
  pendings = {}
  for path, leaf in tree.flatten_with_paths(
      {'ws': state.sum_weighted_statistics, 'w': state.sum_weights}).items():
    want = (dtypes or {}).get('#'.join(map(str, path)))
    converted[path], pendings[path] = convert(leaf, want)
  moved = jax.device_put(
      [(converted[p].data, [np.asarray(converted[p].coords[n].values)
                            for n in pendings[p]]) for p in converted])
  out = {}
  for (path, da), (data_dev, coord_devs) in zip(converted.items(), moved):
    coords = dict(da.coords)
    for name, dev in zip(pendings[path], coord_devs):
      coords[name] = Coord(da.coords[name].dims, dev)
    out[path] = DimArray(data_dev, da.dims, coords)
  nested = tree.unflatten_from_paths(out)
  return aggregation_lib.AggregationState(nested['ws'], nested['w'])


@jax.jit
def _tree_add_jitted(a, b):
  # Add DimArray .data only — device coords (e.g. int64-seconds lead_time)
  # are pytree leaves too and must NOT be summed across chunks.
  return jax.tree_util.tree_map(
      lambda x, y: x.copy(data=x.data + y.data), a, b,
      is_leaf=lambda n: isinstance(n, DimArray))


def _device_add(a: aggregation_lib.AggregationState,
                b: aggregation_lib.AggregationState
                ) -> aggregation_lib.AggregationState:
  """Tree add of same-structure chunk states (device fast path).

  Same-layout states (the common case: both came from the same jitted
  eval program) add in ONE jitted dispatch — the eager per-leaf add in
  ``combining_sum`` would cost a dispatch per leaf per chunk. Mismatched
  layouts (ragged sparse chunks) fall back to the general outer-join sum.
  """
  sa = jax.tree_util.tree_structure(a)
  sb = jax.tree_util.tree_structure(b)
  if sa == sb:
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    if all(getattr(x, 'shape', None) == getattr(y, 'shape', None)
           and getattr(x, 'dtype', None) == getattr(y, 'dtype', None)
           for x, y in zip(la, lb)):
      return _tree_add_jitted(a, b)
  return aggregation_lib.AggregationState.sum([a, b])


def evaluate(
    metrics: Mapping[str, metrics_base.Metric],
    aggregator: aggregation_lib.Aggregator,
    predictions_loader: data_base.DataLoader,
    targets_loader: data_base.DataLoader,
    times: time_chunks_lib.TimeChunks,
    out_path: Optional[str] = None,
    aggregation_state_out_path: Optional[str] = None,
    **kwargs,
) -> dict[str, DimArray]:
  """One-call evaluation (the ``define_pipeline`` equivalent)."""
  pipe = EvaluationPipeline(
      metrics=metrics, aggregator=aggregator,
      predictions_loader=predictions_loader, targets_loader=targets_loader,
      times=times, **kwargs)
  return pipe.run_and_write(out_path, aggregation_state_out_path)
