"""Lightweight observability: stage timers, counters, profiler traces.

The reference's observability is Beam metric distributions — per-chunk load
times and per-statistic compute/aggregate times viewed in the Dataflow UI
(``beam_pipeline.py:54-59,191-214``; ``docs/source/beam_dataflow.md:78-83``).
The equivalent here: a process-local ``Metrics`` registry of counters
and timing distributions that the pipeline reports into, a summary printer,
and an optional ``jax.profiler`` trace context for device-level profiling
(view with TensorBoard / xprof).
"""

import collections
import contextlib
import dataclasses
import math
import threading
import time
from typing import Iterator, Mapping


@dataclasses.dataclass
class Distribution:
  """Streaming distribution (count/sum/min/max + sum of squares)."""

  count: int = 0
  total: float = 0.0
  min: float = math.inf
  max: float = -math.inf
  total_sq: float = 0.0

  def update(self, value: float) -> None:
    self.count += 1
    self.total += value
    self.total_sq += value * value
    self.min = min(self.min, value)
    self.max = max(self.max, value)

  @property
  def mean(self) -> float:
    return self.total / self.count if self.count else 0.0

  @property
  def std(self) -> float:
    if self.count < 2:
      return 0.0
    var = self.total_sq / self.count - self.mean ** 2
    return math.sqrt(max(var, 0.0))

  def __repr__(self):
    return (f'n={self.count} mean={self.mean * 1e3:.1f}ms '
            f'min={self.min * 1e3:.1f}ms max={self.max * 1e3:.1f}ms')


class Metrics:
  """Thread-safe counters and timing distributions, keyed by name."""

  def __init__(self):
    self._lock = threading.Lock()
    self._counters: dict[str, int] = collections.defaultdict(int)
    self._timings: dict[str, Distribution] = collections.defaultdict(
        Distribution)

  def counter(self, name: str, increment: int = 1) -> None:
    with self._lock:
      self._counters[name] += increment

  @contextlib.contextmanager
  def timed(self, name: str) -> Iterator[None]:
    t0 = time.monotonic()
    try:
      yield
    finally:
      with self._lock:
        self._timings[name].update(time.monotonic() - t0)

  def record(self, name: str, seconds: float) -> None:
    with self._lock:
      self._timings[name].update(seconds)

  @property
  def counters(self) -> Mapping[str, int]:
    with self._lock:
      return dict(self._counters)

  @property
  def timings(self) -> Mapping[str, Distribution]:
    # Snapshot the Distribution objects too: handing out the live instances
    # would let a concurrent update() mutate count/total field-by-field
    # under a reader computing mean/std from a torn pair.
    with self._lock:
      return {name: dataclasses.replace(dist)
              for name, dist in self._timings.items()}

  def summary(self) -> str:
    lines = []
    for name, value in sorted(self.counters.items()):
      lines.append(f'{name}: {value}')
    for name, dist in sorted(self.timings.items()):
      lines.append(f'{name}: {dist!r}')
    return '\n'.join(lines)


# Process-global default registry (mirrors Beam's global metric namespace).
default_metrics = Metrics()


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None) -> Iterator[None]:
  """jax.profiler trace context when a directory is given, no-op otherwise.

  The resulting trace opens in TensorBoard/xprof and shows per-op device
  time — the replacement for Dataflow's worker dashboards.
  """
  if not trace_dir:
    yield
    return
  import jax

  jax.profiler.start_trace(trace_dir)
  try:
    yield
  finally:
    jax.profiler.stop_trace()
