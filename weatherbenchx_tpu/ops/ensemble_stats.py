"""Fused ensemble statistics: one pass over an (M, …) ensemble.

For every gridpoint the kernel reads the M members and the target once and
returns the four sums the probabilistic scorecard needs:

* ``spread_sum = Σ_{i≠j} |x_i − x_j|`` — through a sorting network over
  the members and the Zamo & Naveau order-statistic identity
  ``Σ_{i≠j} |x_i − x_j| = 2 Σ_k (2k − M − 1) x_(k)``;
* ``skill_sum = Σ_i |x_i − y|``;
* ``mean = Σ_i x_i / M``;
* ``sq_dev_sum = Σ_i (x_i − mean)²``.

The plain XLA form of the same statistics transposes the ensemble to
member-last, runs a multi-pass sort, and sweeps the ensemble again for the
skill and the moments. The kernel is a Pallas kernel for the Triton route:
the data axes are flattened (a free reshape on the GPU), a 1-D grid walks
blocks of ``BLOCK`` gridpoints, each member row of a block is one masked,
coalesced load, and all M rows stay in registers while the network runs.

Which implementation runs is decided per backend by :func:`kernel_for`:
the kernel on ``gpu``; elsewhere the statistics keep their plain jnp forms.
Tests run the kernel on the CPU with ``interpret=True``.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

# Gridpoints per program and warps per program, chosen by timing the
# launch shapes at M=50 on (50, 1, 4, 721, 1440) f32 (see PERF.md). The
# kernel has no loop, so Triton's pipeline stages do not apply.
BLOCK = 128
NUM_WARPS = 4

SUPPORTED_DTYPES = (jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16))


def kernel_for(backend: str):
  """The fused-statistics implementation for ``backend``, or None.

  None means the statistics take their plain jnp forms (XLA's own
  lowering). The kernel is compiled by Triton, so it exists only on 'gpu'.
  """
  return fused_ensemble_stats if backend == 'gpu' else None


def applies(m: int, n_data_dims: int, dtype) -> bool:
  """Whether the kernel takes inputs of this member count, rank and dtype."""
  return m >= 2 and n_data_dims >= 1 and jnp.dtype(dtype) in SUPPORTED_DTYPES


def _oem_network(p: int) -> list[tuple[int, int]]:
  """Batcher odd-even mergesort on p = 2^k wires: [(lo, hi)] pairs."""
  ces = []
  length = 1
  while length < p:
    k = length
    while k >= 1:
      for j in range(k % length, p - k, 2 * k):
        for i in range(0, min(k, p - j - k)):
          if (i + j) // (length * 2) == (i + j + k) // (length * 2):
            ces.append((i + j, i + j + k))
      k //= 2
    length *= 2
  return ces


_PAD = object()  # a +inf wire: folded away while the network is traced


def _ce(a, b):
  """(min, max) of two wires, with +inf pad wires folded symbolically."""
  if a is _PAD:
    return b, _PAD
  if b is _PAD:
    return a, _PAD
  return jnp.minimum(a, b), jnp.maximum(a, b)


def _spread_sum(rows: list, m: int):
  """Σ_{i≠j}|x_i − x_j| of the rows, NaN-blind (the caller poisons NaNs).

  The network is padded to the next power of two with symbolic +inf wires
  that sort above every real row and cost no instructions. The GPU's
  min/max drop a NaN operand, so NaN propagation is left to the caller.
  """
  p = 1 << (m - 1).bit_length()
  wires = list(rows) + [_PAD] * (p - m)
  for lo, hi in _oem_network(p):
    wires[lo], wires[hi] = _ce(wires[lo], wires[hi])
  acc = None
  for k in range(m):
    coeff = 2 * (k + 1) - m - 1
    if coeff:
      term = wires[k] * float(coeff)
      acc = term if acc is None else acc + term
  return 2 * acc


def _kernel(x_ref, y_ref, spread_ref, skill_ref, mean_ref, sqdev_ref, *,
            m: int, n: int, block: int):
  from jax.experimental import pallas as pl
  from jax.experimental.pallas import triton as plgpu

  start = pl.program_id(0) * block
  cols = pl.ds(start, block)
  valid = start + jnp.arange(block) < n
  rows = [plgpu.load(x_ref.at[k, cols], mask=valid, other=0.0
                     ).astype(jnp.float32) for k in range(m)]
  y = plgpu.load(y_ref.at[cols], mask=valid, other=0.0).astype(jnp.float32)
  total = functools.reduce(jnp.add, rows)
  skill = functools.reduce(jnp.add, [jnp.abs(r - y) for r in rows])
  # Two passes over the resident rows: the one-pass moment form
  # Σx² − (Σx)²/M cancels catastrophically in f32 when |mean| ≫ std
  # (temperatures: 288² against a variance of ~9). The spread is taken on
  # the same centred rows: its coefficients sum to zero, so the shift
  # changes nothing but the size of the partial sums it rounds.
  mean = total / m
  dev = [r - mean for r in rows]
  sqdev = functools.reduce(jnp.add, [d * d for d in dev])
  # A NaN member poisons its own gridpoint and only that one. The sum
  # carries it, so the NaN-blind network result is overridden from it.
  spread = jnp.where(jnp.isnan(total), jnp.nan, _spread_sum(dev, m))
  for ref, val in ((spread_ref, spread), (skill_ref, skill),
                   (mean_ref, mean), (sqdev_ref, sqdev)):
    plgpu.store(ref.at[cols], val.astype(ref.dtype), mask=valid)


def _fused_flat(x, y, *, interpret: bool):
  """The kernel on x: (M, N), y: (N,) → four (N,) arrays of x.dtype."""
  from jax.experimental import pallas as pl
  from jax.experimental.pallas import triton as plgpu

  m, n = x.shape
  out = jax.ShapeDtypeStruct((n,), x.dtype)
  return pl.pallas_call(
      functools.partial(_kernel, m=m, n=n, block=BLOCK),
      out_shape=(out,) * 4,
      grid=(pl.cdiv(n, BLOCK),),
      backend='triton',
      compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
      interpret=interpret,
      name=f'ensemble_stats_m{m}',
  )(x, y)


def _fused_impl(x, y, interpret: bool):
  m, rest = x.shape[0], x.shape[1:]
  n = math.prod(rest)
  outs = _fused_flat(x.reshape(m, n), y.reshape(n), interpret=interpret)
  return tuple(o.reshape(rest) for o in outs)


def _norm_spec(spec, ndim):
  parts = tuple(spec) if spec is not None else ()
  return parts + (None,) * (ndim - len(parts))


@functools.lru_cache(maxsize=None)
def _partitioned(interpret: bool, ndim: int):
  """The kernel under jit with a sharding rule for meshes.

  Every gridpoint is independent, so any data axis may be sharded and each
  device runs the kernel on its own shard. All members of a gridpoint
  must be on one device: the member axis is gathered when a mesh shards it.
  """
  from jax.experimental.custom_partitioning import custom_partitioning
  from jax.sharding import NamedSharding, PartitionSpec

  @custom_partitioning
  def fn(x, y):
    return _fused_impl(x, y, interpret)

  def infer_sharding(mesh, arg_infos, result_infos):
    del result_infos
    spec = _norm_spec(arg_infos[0].sharding.spec, ndim)
    return (NamedSharding(mesh, PartitionSpec(*spec[1:])),) * 4

  def partition(mesh, arg_infos, result_infos):
    del result_infos
    spec = _norm_spec(arg_infos[0].sharding.spec, ndim)
    data = NamedSharding(mesh, PartitionSpec(*spec[1:]))
    members = NamedSharding(mesh, PartitionSpec(None, *spec[1:]))

    def lower(x, y):
      return _fused_impl(x, y, interpret)
    return mesh, lower, (data,) * 4, (members, data)

  data_axes = ' '.join(f'd{i}' for i in range(ndim - 1))
  fn.def_partition(
      infer_sharding_from_operands=infer_sharding, partition=partition,
      sharding_rule=f'm {data_axes}, {data_axes} -> '
      + ', '.join([data_axes] * 4))
  return jax.jit(fn)


def fused_ensemble_stats(x: jnp.ndarray, y: jnp.ndarray,
                         interpret: bool = False) -> tuple:
  """One ensemble pass → (spread_sum, skill_sum, mean, sq_dev_sum).

  Args:
    x: (M, *rest) ensemble, members leading; float32 or bfloat16.
    y: (*rest) deterministic target of the same dtype.
    interpret: run the Pallas interpreter instead of compiling for the GPU.

  Returns:
    Four ``rest``-shaped arrays of ``x.dtype`` (see the module docstring).
    The sums are taken in float32.
  """
  if x.ndim != y.ndim + 1 or x.shape[1:] != y.shape:
    raise ValueError(f'ensemble {x.shape} does not match target {y.shape}')
  if not applies(x.shape[0], y.ndim, x.dtype):
    raise ValueError(f'unsupported ensemble {x.shape} {x.dtype}')
  fn = _partitioned(bool(interpret), x.ndim)
  sharding = jax.typeof(y).sharding
  if jax.sharding.AxisType.Explicit not in sharding.mesh.axis_types:
    return fn(x, y)
  # Under a mesh with explicit axes every array type carries its sharding,
  # and the flattening reshape inside has none to give. The call runs with
  # those axes automatic; the outputs take the target's sharding.
  with jax.sharding.use_abstract_mesh(sharding.mesh):
    return jax.sharding.auto_axes(fn, out_sharding=(sharding.spec,) * 4)(x, y)

