"""Base data loader.

Reference semantics: ``weatherbenchX/data_loaders/base.py:25-163``. Loaders
return chunks as ``dict[var, DimArray]`` with canonical dims
(init_time/lead_time/valid_time/latitude/longitude[/number]). The load
pipeline per chunk: source load → process_chunk_fn → interpolation against a
reference chunk → optional NaN mask coord → optional values-as-coord.

Note: the NaN ``mask`` coord is attached as a DEVICE coordinate so it
traces straight into the jitted aggregation (masked values are zeroed in
one fused op; see ``aggregation.Aggregator.aggregate_stat_var``).
"""

import abc
from typing import Callable, Collection, Hashable, Mapping, Optional, Union

import numpy as np

from weatherbenchx_tpu import tree
from weatherbenchx_tpu.darray import Coord, DimArray


def add_nan_mask_to_data(
    data: Mapping[Hashable, DimArray],
    variable_subset: Collection[str] | None = None,
) -> dict[Hashable, DimArray]:
  """Adds a boolean 'mask' coord to each variable, False marking NaNs.

  Preferred over skipna so unexpected NaNs still propagate loudly
  (reference ``data_loaders/base.py:25-56``).
  """
  out = dict(data)
  for var in out:
    if variable_subset is None or var in variable_subset:
      da = out[var]
      mask = ~np.isnan(np.asarray(da.values))
      out[var] = da.assign_coords(mask=Coord(da.dims, mask))
  return out


def pad_dim_to_multiple(
    data: Mapping[Hashable, DimArray],
    dim: str,
    multiple: int,
) -> dict[Hashable, DimArray]:
  """Pads a ragged dim up to a bucket size, masking padded entries.

  Sparse chunks have a variable-length ``index`` dim, which would retrace
  the jitted pipeline step every chunk. Padding to the next multiple bounds
  the number of distinct compile shapes to a handful of buckets. Padded
  positions get mask=False (use masked=True aggregation) and fill data of
  NaN for floats / 0 for integer, bool and datetime data — dtypes are
  preserved so exact-multiple and padded chunks of the same variable stay
  layout-identical (one compile bucket, combinable states). Numeric coords
  are padded with their first value (weights/bins see valid values; the
  mask excludes them), string coords with ''.
  """
  out = {}
  for var, da in data.items():
    if dim not in da.dims:
      out[var] = da
      continue
    n = da.sizes[dim]
    target = max(-(-n // multiple) * multiple, multiple)
    pad = target - n
    ax = da.dims.index(dim)
    if pad == 0 and da.has_coord('mask'):
      out[var] = da
      continue
    widths = [(0, pad if d == dim else 0) for d in da.dims]
    vals = np.asarray(da.values)
    if np.issubdtype(vals.dtype, np.floating):
      new_data = np.pad(vals, widths, constant_values=np.nan)
    elif vals.dtype.kind in 'US':
      new_data = np.pad(vals, widths, constant_values='')
    elif vals.dtype.kind in 'Mm':
      new_data = np.pad(vals.view('i8'), widths,
                        constant_values=0).view(vals.dtype)
    else:
      new_data = np.pad(vals, widths, constant_values=0)
    coords = {}
    for name, c in da.coords.items():
      v = np.asarray(c.values)
      if dim in c.dims:
        cax = c.dims.index(dim)
        cw = [(0, pad if d == dim else 0) for d in c.dims]
        if v.dtype.kind in 'US':
          v = np.pad(v, cw, constant_values='')
        elif v.size:
          first = v.take([0], axis=cax)
          fill = np.broadcast_to(
              first, v.shape[:cax] + (pad,) + v.shape[cax + 1:])
          v = np.concatenate([v, fill], axis=cax)
        else:
          v = np.zeros(v.shape[:cax] + (target,) + v.shape[cax + 1:],
                       dtype=v.dtype)
        coords[name] = Coord(c.dims, v)
      else:
        coords[name] = c
    # Extend (or create) the validity mask.
    if 'mask' in da.coords:
      m = np.asarray(da.coords['mask'].values)
      mw = [(0, pad if d == dim else 0) for d in da.coords['mask'].dims]
      mask = np.pad(m, mw, constant_values=False)
      coords['mask'] = Coord(da.coords['mask'].dims, mask)
    else:
      mask = np.ones(new_data.shape, bool)
      sl = [slice(None)] * new_data.ndim
      sl[ax] = slice(n, None)
      mask[tuple(sl)] = False
      coords['mask'] = Coord(da.dims, mask)
    out[var] = DimArray(new_data, da.dims, coords)
  return out


class DataLoader(abc.ABC):
  """Base class for data loaders.

  Loaders return prediction/target chunks that broadcast against each other;
  when mapping one dataset onto another (e.g. grid → sparse points), the
  other chunk is passed as ``reference`` for interpolation.
  """

  def __init__(
      self,
      interpolation=None,
      compute: bool = True,
      add_nan_mask: bool = False,
      process_chunk_fn: Optional[Callable[
          [Mapping[Hashable, DimArray]], Mapping[Hashable, DimArray]]] = None,
      add_values_to_coords: bool = False,
      pad_index_multiple: Optional[int] = None,
  ):
    self._interpolation = interpolation
    self._compute = compute
    self._add_nan_mask = add_nan_mask
    self._process_chunk_fn = process_chunk_fn
    self._add_values_to_coords = add_values_to_coords
    self._pad_index_multiple = pad_index_multiple

  @abc.abstractmethod
  def _load_chunk_from_source(
      self,
      init_times: np.ndarray,
      lead_times: Optional[Union[np.ndarray, slice]] = None,
  ) -> Mapping[Hashable, DimArray]:
    """Loader-specific source read."""

  def load_chunk(
      self,
      init_times: np.ndarray,
      lead_times: Optional[Union[np.ndarray, slice]] = None,
      reference: Optional[Mapping[Hashable, DimArray]] = None,
  ) -> Mapping[Hashable, DimArray]:
    """Shared chunk-loading pipeline (reference ``base.py:111-163``)."""
    chunk = self._load_chunk_from_source(init_times, lead_times)

    if self._process_chunk_fn is not None:
      chunk = self._process_chunk_fn(chunk)

    if self._interpolation is not None:
      chunk = self._interpolation.interpolate(chunk, reference)

    if self._compute:
      # Materialize any lazy views into contiguous host arrays, preserving
      # dtype. For lazy-opened stores this is the per-chunk windowed read
      # (reference per-chunk .compute(), ``data_loaders/base.py:146-153``).
      def _compute_one(da: DimArray) -> DimArray:
        d = da.data
        if getattr(d, '__wbx_lazy__', False):
          return da.copy(data=np.asarray(d))
        if isinstance(d, np.ndarray) and not d.flags.c_contiguous:
          return da.copy(data=np.ascontiguousarray(d))
        return da
      chunk = tree.map_structure(_compute_one, chunk)

    if self._add_nan_mask:
      chunk = add_nan_mask_to_data(chunk)

    if self._pad_index_multiple:
      # Bucket the ragged 'index' dim so the jitted evaluation step sees a
      # bounded set of shapes across a long run (each distinct padded
      # length is one XLA compile). Padded rows carry NaN data and
      # mask=False; requires masked=True aggregation.
      chunk = pad_dim_to_multiple(chunk, 'index', self._pad_index_multiple)

    if self._add_values_to_coords:
      chunk = tree.map_structure(
          lambda da: da.assign_coords(
              values_as_coord=Coord(da.dims, np.asarray(da.values))), chunk)

    return chunk
