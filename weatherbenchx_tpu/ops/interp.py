"""Gather-based rectilinear interpolation kernels.

JAX replacement for the reference's ``xr.DataArray.interp`` (scipy
interpn under the hood, ``interpolations.py:89-113``): fractional indices
are computed host-side from monotonic source coords, the (multi)linear
combination is a handful of device gathers + lerps that XLA fuses.

Two indexing modes, matching xarray semantics:
* outer: each target axis is an independent 1-D coordinate array → the
  result has one axis per interpolated dim (regridding).
* pointwise: all target arrays share the same dims (e.g. ('index',)) → the
  interpolated dims collapse into those dims (grid → sparse stations).
"""

from typing import Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def _xp_for(data):
  """numpy for host arrays, jnp for device/traced arrays.

  The gather kernels are called from two very different places: inside
  jitted evaluation (device arrays — use jnp) and inside HOST-side data
  loaders (numpy arrays — grid→sparse prep). Forcing jnp for the latter
  dispatches each gather/lerp as an eager op on the attached device, one
  host round trip per op, and the loader immediately fetches the result
  back anyway.
  """
  return jnp if isinstance(data, (jax.Array, jax.core.Tracer)) else np


def fractional_indices(
    source: np.ndarray,
    targets: np.ndarray,
    extrapolate: bool,
) -> tuple[np.ndarray, np.ndarray]:
  """(lower index, fraction) of targets within a monotonic 1-D source grid.

  With extrapolate=True the fraction is unclamped (linear extrapolation,
  matching scipy fill_value='extrapolate'); otherwise out-of-bounds
  fractions are marked NaN.
  """
  source = np.asarray(source)
  targets = np.asarray(targets)
  descending = source.size > 1 and source[0] > source[-1]
  s = source[::-1] if descending else source
  if s.size == 0:
    raise ValueError('Cannot interpolate along an empty dim.')
  if s.size > 1 and not np.all(np.diff(s) > 0):
    # searchsorted on a non-monotonic grid returns meaningless indices (and
    # duplicate values divide by zero) — fail loudly instead of silently
    # corrupting every interpolated value. Callers sort first (CropToBox
    # does, wrap-around-unsorted longitudes are the typical culprit).
    raise ValueError(
        'Interpolation source coordinate must be strictly monotonic.')
  if s.size == 1:
    # Degenerate single-point grid (e.g. chunked init/lead dims of size 1
    # interpolated pointwise with method='nearest'): everything maps to it.
    idx = np.zeros(targets.shape, dtype=np.int32)
    frac = np.zeros(targets.shape, dtype=np.float64)
    if not extrapolate:
      frac = np.where(targets == s[0], frac, np.nan)
    return idx, frac
  idx = np.searchsorted(s, targets, side='right') - 1
  idx = np.clip(idx, 0, s.size - 2)
  frac = (targets - s[idx]) / (s[idx + 1] - s[idx])
  if not extrapolate:
    oob = (targets < s[0]) | (targets > s[-1])
    frac = np.where(oob, np.nan, frac)
  if descending:
    idx = source.size - 2 - idx
    frac = 1.0 - frac
  return idx.astype(np.int32), frac.astype(np.float64)


def interp_1d_along_axis(
    data: jnp.ndarray,
    axis: int,
    idx: np.ndarray,
    frac: np.ndarray,
    method: str,
) -> jnp.ndarray:
  """Linear/nearest interp along one axis at (idx, frac) positions."""
  xp = _xp_for(data)
  n = data.shape[axis]
  if method == 'nearest':
    take = np.minimum(np.where(frac > 0.5, idx + 1, idx), n - 1)
    nan_mask = np.isnan(frac)
    out = xp.take(data, xp.asarray(take), axis=axis)
    if nan_mask.any():
      shape = [1] * out.ndim
      shape[axis] = nan_mask.size
      out = xp.where(xp.asarray(nan_mask).reshape(shape), xp.nan, out)
    return out
  if method != 'linear':
    raise ValueError(f'Unsupported interpolation method: {method}')
  lo = xp.take(data, xp.asarray(idx), axis=axis)
  hi = xp.take(data, xp.asarray(np.minimum(idx + 1, n - 1)), axis=axis)
  shape = [1] * lo.ndim
  shape[axis] = frac.size
  f = xp.asarray(frac, lo.dtype if np.issubdtype(
      np.dtype(lo.dtype), np.floating) else np.float32).reshape(shape)
  return lo * (1 - f) + hi * f


def interp_outer(
    data: jnp.ndarray,
    dims: Sequence[str],
    dim_targets: Mapping[str, np.ndarray],
    source_coords: Mapping[str, np.ndarray],
    method: str,
    extrapolate: bool,
) -> jnp.ndarray:
  """Separable interpolation: each dim to its own 1-D target coords."""
  out = data if isinstance(data, (jax.Array, jax.core.Tracer)) \
      else np.asarray(data)
  for d, targets in dim_targets.items():
    ax = list(dims).index(d)
    idx, frac = fractional_indices(
        np.asarray(source_coords[d]), np.asarray(targets), extrapolate)
    out = interp_1d_along_axis(out, ax, idx, frac, method)
  return out


def interp_pointwise(
    data: jnp.ndarray,
    dims: Sequence[str],
    dim_targets: Mapping[str, np.ndarray],
    source_coords: Mapping[str, np.ndarray],
    method: str,
    extrapolate: bool,
) -> jnp.ndarray:
  """Joint pointwise interpolation: all targets share one flat point axis.

  The interpolated dims are moved last and replaced by a single point axis
  of the targets' common shape; the multilinear combination sums the 2^k
  corner gathers (k = number of interpolated dims, typically 2).
  """
  if method not in ('nearest', 'linear'):
    # The gather kernels implement nearest/(multi)linear only; anything
    # else (e.g. the reference's scipy 'cubic') must fail loudly rather
    # than silently lerping.
    raise ValueError(f'Unsupported interpolation method: {method}')
  interp_dims = list(dim_targets.keys())
  k = len(interp_dims)
  other_dims = [d for d in dims if d not in interp_dims]
  order = [list(dims).index(d) for d in other_dims + interp_dims]
  xp = _xp_for(data)
  arr = xp.transpose(xp.asarray(data), order)
  grid_shape = arr.shape[-k:]
  arr_flat = arr.reshape(arr.shape[:-k] + (-1,))

  idx_list, frac_list = [], []
  point_shape = None
  for d in interp_dims:
    t = np.asarray(dim_targets[d]).reshape(-1)
    point_shape = np.asarray(dim_targets[d]).shape
    idx, frac = fractional_indices(
        np.asarray(source_coords[d]), t, extrapolate)
    idx_list.append(idx)
    frac_list.append(frac)

  strides = np.cumprod([1] + list(grid_shape[::-1][:-1]))[::-1]

  if method == 'nearest':
    flat_idx = np.zeros_like(idx_list[0], dtype=np.int64)
    nan_mask = np.zeros_like(frac_list[0], dtype=bool)
    for idx, frac, stride, size in zip(idx_list, frac_list, strides,
                                       grid_shape):
      nearest = np.minimum(
          np.where(np.nan_to_num(frac) > 0.5, idx + 1, idx), size - 1)
      flat_idx += nearest * int(stride)
      nan_mask |= np.isnan(frac)
    out = xp.take(arr_flat, xp.asarray(flat_idx), axis=-1)
    if nan_mask.any():
      out = xp.where(xp.asarray(nan_mask), xp.nan, out)
  else:
    out = 0.0
    for corner in range(2 ** k):
      flat_idx = np.zeros_like(idx_list[0], dtype=np.int64)
      weight = np.ones_like(frac_list[0])
      for j, (idx, frac, stride) in enumerate(
          zip(idx_list, frac_list, strides)):
        bit = (corner >> j) & 1
        # Clamp the upper corner on degenerate (size-1) axes; its weight
        # is zero there, but jnp.take's out-of-bounds mode fills NaN.
        flat_idx += np.minimum(idx + bit, grid_shape[j] - 1) * int(stride)
        weight = weight * (frac if bit else (1.0 - frac))
      gathered = xp.take(arr_flat, xp.asarray(flat_idx), axis=-1)
      wdtype = gathered.dtype if np.issubdtype(
          np.dtype(gathered.dtype), np.floating) else np.float32
      out = out + gathered * xp.asarray(weight, wdtype)

  return out.reshape(arr.shape[:-k] + tuple(point_shape))
