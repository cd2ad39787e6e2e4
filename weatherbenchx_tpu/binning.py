"""Binning: boolean bin-mask factories multiplied into the aggregation.

Reference semantics: ``weatherbenchX/binning.py:22-705``. Each Binning adds
one named bin dimension; the masks are multiplied into the fused
aggregation contraction (see ``aggregation.Aggregator``), so disaggregation
costs one extra einsum axis rather than a data-dependent group-by.

Masks over static host coords (lat/lon boxes, station sets, time units of
host datetime coords) are computed in numpy at trace time and lowered as
constants. ``ByTimeUnitFromSeconds`` operates on device int-seconds coords
for fully traced, retrace-free binning inside the jitted pipeline step
(reference motivation: ``binning.py:517-524``).
"""

import abc
from typing import Any, Hashable, Mapping, Optional, Sequence, Tuple

import numpy as np

from weatherbenchx_tpu import darray
from weatherbenchx_tpu import datetimes
from weatherbenchx_tpu.darray import Coord, DimArray


class Binning(abc.ABC):
  """Binning base class."""

  def __init__(self, bin_dim_name: str):
    self.bin_dim_name = bin_dim_name

  @property
  def host_coords(self) -> tuple:
    """Coord names whose HOST values this binning needs at trace time.

    The pipeline keeps these coords on the host (static) instead of
    converting them to device leaves; changing values retrace the step,
    which is bounded by the number of distinct chunk layouts.
    """
    return ()

  @abc.abstractmethod
  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    """Boolean mask broadcastable against the statistic, with the bin dim."""


def _lat_mask(lat: np.ndarray, lat_lims: Tuple[float, float]) -> np.ndarray:
  if lat_lims[0] >= lat_lims[1]:
    raise ValueError(
        f'`lat_lims[0]` must be smaller than `lat_lims[1]`, got {lat_lims}')
  return (lat >= lat_lims[0]) & (lat <= lat_lims[1])


def _lon_mask(lon: np.ndarray, lon_lims: Tuple[float, float]) -> np.ndarray:
  lon = np.mod(lon, 360)
  lo, hi = np.mod(lon_lims[0], 360), np.mod(lon_lims[1], 360)
  if hi > lo:
    return (lon >= lo) & (lon <= hi)
  # Wraps around the dateline.
  return (lon <= hi) | (lon >= lo)


def _region_mask(lat, lon, lat_lims, lon_lims) -> np.ndarray:
  """Outer AND of a latitude band and a (possibly wrapping) longitude band."""
  return _lat_mask(lat, lat_lims)[:, None] & _lon_mask(lon, lon_lims)[None, :]


def _align_axis(values: np.ndarray, axis: int, have: np.ndarray,
                want: np.ndarray, what: str) -> np.ndarray:
  """Reorders ``values`` along ``axis`` from label order ``have`` to ``want``.

  The aggregation einsum contracts bin masks against statistics purely by
  position (darray.dot does no coordinate alignment, unlike the xr.dot the
  reference relies on), so masks built from externally-stored fields MUST
  be label-aligned here — e.g. an ascending-latitude land mask against a
  descending-latitude statistic would otherwise mirror land north/south.
  """
  if np.array_equal(have, want):
    return values
  if not np.array_equal(np.sort(have), np.sort(want)):
    raise ValueError(
        f'{what} coordinates do not match the statistic: '
        f'{have[:4]}... vs {want[:4]}...')
  pos = {v: i for i, v in enumerate(have.tolist())}
  idx = np.array([pos[v] for v in want.tolist()])
  return np.take(values, idx, axis=axis)


class Regions(Binning):
  """Rectangular lat/lon-box regions, optionally with {region}_land bins.

  Coordinates must be named 'latitude' and 'longitude'
  (reference ``binning.py:147-201``).
  """

  def __init__(
      self,
      regions: Mapping[Hashable, Tuple[Tuple[float, float],
                                       Tuple[float, float]]],
      bin_dim_name: str = 'region',
      land_sea_mask: Optional[DimArray] = None,
  ):
    super().__init__(bin_dim_name)
    self._regions = dict(regions)
    self._land_sea_mask = land_sea_mask

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    lat = statistic.coord_values('latitude')
    lon = statistic.coord_values('longitude')
    masks = np.stack([
        _region_mask(lat, lon, lat_lims, lon_lims)
        for lat_lims, lon_lims in self._regions.values()
    ])
    labels = np.array([str(k) for k in self._regions.keys()])
    if self._land_sea_mask is not None:
      ls = self._land_sea_mask
      # Pure-numpy transpose: a jnp op here would create a tracer when the
      # mask is built inside the jitted evaluation step.
      order = [ls.dims.index('latitude'), ls.dims.index('longitude')]
      ls_np = np.transpose(np.asarray(ls.values), order).astype(bool)
      ls_np = _align_axis(ls_np, 0, ls.coord_values('latitude'), lat,
                          'Land/sea mask latitude')
      ls_np = _align_axis(ls_np, 1, ls.coord_values('longitude'), lon,
                          'Land/sea mask longitude')
      masks = np.concatenate([masks, masks & ls_np[None]], axis=0)
      labels = np.concatenate([labels, np.array(
          [f'{k}_land' for k in self._regions.keys()])])
    return DimArray(
        masks, (self.bin_dim_name, 'latitude', 'longitude'),
        {self.bin_dim_name: labels,
         'latitude': statistic.coords['latitude'],
         'longitude': statistic.coords['longitude']})


class LandSea(Binning):
  """land/sea (optionally + global) bins from a land fraction field."""

  def __init__(
      self,
      land_sea_fraction: DimArray,
      land_sea_threshold: float = 0.5,
      bin_dim_name: str = 'land_sea',
      include_global_mask: bool = False,
  ):
    super().__init__(bin_dim_name)
    self._land_mask = np.asarray(land_sea_fraction.values
                                 ) >= land_sea_threshold
    self._dims = land_sea_fraction.dims
    self._coords = land_sea_fraction.coords
    self._include_global_mask = include_global_mask

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    # Label-align the land fraction to the statistic's coordinate order:
    # the aggregation contraction is positional (see _align_axis).
    land = self._land_mask
    coords = dict(self._coords)
    for ax, d in enumerate(self._dims):
      if d in self._coords and statistic.has_coord(d):
        have = np.asarray(self._coords[d].values)
        want = statistic.coord_values(d)
        land = _align_axis(land, ax, have, want, f'land_sea_fraction {d}')
        coords[d] = statistic.coords[d]
    masks = [land, ~land]
    labels = ['land', 'sea']
    if self._include_global_mask:
      masks.append(np.ones_like(land))
      labels.append('global')
    coords[self.bin_dim_name] = Coord((self.bin_dim_name,), np.array(labels))
    return DimArray(
        np.stack(masks), (self.bin_dim_name,) + self._dims, coords)


class LatitudeBins(Binning):
  """Binning by latitude bands (reference ``binning.py:204-243``)."""

  def __init__(
      self,
      degrees: float,
      lat_range: Tuple[float, float] = (-90, 90),
      bin_dim_name: str = 'latitude_bins',
  ):
    super().__init__(bin_dim_name)
    self._degrees = degrees
    self._lat_bins = np.arange(
        lat_range[0], lat_range[1] + degrees, degrees)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    lat = statistic.coord_values('latitude')
    starts = self._lat_bins[:-1]
    masks = np.stack([
        _lat_mask(lat, (s, s + self._degrees)) for s in starts])
    return DimArray(
        masks, (self.bin_dim_name, 'latitude'),
        {self.bin_dim_name: starts,
         'latitude': statistic.coords['latitude']})


class LongitudeBins(Binning):
  """Binning by longitude bands (reference ``binning.py:246-288``)."""

  def __init__(
      self,
      degrees: float,
      lon_range: Tuple[float, float] = (0, 360),
      bin_dim_name: str = 'longitude_bins',
  ):
    super().__init__(bin_dim_name)
    self._degrees = degrees
    lon_end = lon_range[1] + (360 if lon_range[0] >= lon_range[1] else 0)
    self._lon_bins = np.arange(lon_range[0], lon_end + degrees, degrees)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    lon = statistic.coord_values('longitude')
    starts = self._lon_bins[:-1]
    masks = np.stack([
        _lon_mask(lon, (s, s + self._degrees)) for s in starts])
    return DimArray(
        masks, (self.bin_dim_name, 'longitude'),
        {self.bin_dim_name: np.mod(starts, 360),
         'longitude': statistic.coords['longitude']})


def vectorized_coord_mask(
    coord_values: np.ndarray,
    coord_dims: tuple[str, ...],
    bin_dim_name: str,
    add_global_bin: bool = False,
    parent_coords: Mapping[str, Coord] | None = None,
) -> DimArray:
  """Bin masks for each unique value of a host coordinate.

  Reference ``binning.py:291-320``. Handles empty inputs (zero bins).
  """
  unique = np.unique(coord_values)
  masks = np.equal(
      coord_values[None], unique.reshape((-1,) + (1,) * coord_values.ndim))
  labels = unique
  if add_global_bin:
    if labels.dtype.kind not in 'US':
      labels = labels.astype(str)
    labels = np.concatenate([np.array(['global']), labels])
    masks = np.concatenate(
        [np.ones((1,) + coord_values.shape, bool), masks], axis=0)
  coords = {bin_dim_name: Coord((bin_dim_name,), labels)}
  for name, c in (parent_coords or {}).items():
    if name not in coords and set(c.dims).issubset(coord_dims):
      coords[name] = c
  return DimArray(masks, (bin_dim_name,) + coord_dims, coords)


class ByExactCoord(Binning):
  """One bin per unique value of a (non-dimension) coordinate.

  E.g. per unique lead_time of sparse observations where lead_time is a
  coordinate over the `index` dim (reference ``binning.py:323-355``).
  """

  def __init__(self, coord: str, add_global_bin: bool = False):
    super().__init__(coord)
    self.coord = coord
    self.add_global_bin = add_global_bin

  @property
  def host_coords(self) -> tuple:
    return (self.coord,)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    assert self.coord not in statistic.dims, (
        'For dimensions, specify reduce_dims in aggregation.')
    c = statistic.coords[self.coord]
    return vectorized_coord_mask(
        np.asarray(c.values), tuple(c.dims), self.coord,
        self.add_global_bin, statistic.coords)


def _extract_time_unit(values: np.ndarray, unit: str) -> np.ndarray:
  """Extract a time unit from datetime64/timedelta64 values (host-side)."""
  if values.dtype.kind == 'm':  # timedelta
    seconds = values.astype('timedelta64[ns]').astype(np.int64) / 1e9
    divisors = {'second': 1, 'minute': 60, 'hour': 3600, 'day': 86400,
                'week': 86400 * 7, 'year': 86400 * 365}
    if unit not in divisors:
      raise ValueError(f'Unsupported unit for timedelta: {unit}')
    out = seconds // divisors[unit] if unit != 'second' else seconds
    return out.astype(np.int64)
  return datetimes.datetime_field(values, unit)


class ByTimeUnit(Binning):
  """Bin by a calendar unit of a host datetime/timedelta coordinate.

  Reference ``binning.py:396-441``. Works for datetime64 coords (any
  ``datetimes.FIELDS`` entry: 'hour', 'dayofyear', 'month', ...) and
  timedelta64 coords ('second'/'minute'/'hour'/'day'/'week'/'year' as
  integer multiples).
  """

  def __init__(self, unit: str, time_dim: str, add_global_bin: bool = False):
    super().__init__(f'{time_dim}_{unit}')
    self.unit = unit
    self.time_dim = time_dim
    self.add_global_bin = add_global_bin

  @property
  def host_coords(self) -> tuple:
    return (self.time_dim,)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    c = statistic.coords[self.time_dim]
    unit_values = _extract_time_unit(np.asarray(c.values), self.unit)
    return vectorized_coord_mask(
        unit_values, tuple(c.dims), self.bin_dim_name,
        self.add_global_bin, statistic.coords)


class ByTimeUnitSets(Binning):
  """Bin by named sets of time-unit values (reference ``binning.py:444-514``)."""

  def __init__(
      self,
      sets: Mapping[str, Sequence[Any] | Any],
      unit: str,
      dim: str,
      bin_dim_name: Optional[str] = None,
      add_global_bin: bool = False,
  ):
    super().__init__(bin_dim_name or f'{dim}_{unit}_sets')
    self.sets = dict(sets)
    self.unit = unit
    self.dim = dim
    self.add_global_bin = add_global_bin

  @property
  def host_coords(self) -> tuple:
    return (self.dim,)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    c = statistic.coords[self.dim]
    unit_values = _extract_time_unit(np.asarray(c.values), self.unit)
    masks, labels = [], []
    for name, s in self.sets.items():
      s = list(s) if isinstance(s, Sequence) and not isinstance(s, str) else [s]
      masks.append(np.isin(unit_values, np.array(s)))
      labels.append(name)
    if self.add_global_bin:
      masks.append(np.ones_like(unit_values, dtype=bool))
      labels.append('global')
    coords = {self.bin_dim_name: Coord(
        (self.bin_dim_name,), np.array(labels))}
    for name, cc in statistic.coords.items():
      if name not in coords and set(cc.dims).issubset(tuple(c.dims)):
        coords[name] = cc
    return DimArray(np.stack(masks), (self.bin_dim_name,) + tuple(c.dims),
                    coords)


class ByTimeUnitFromSeconds(Binning):
  """Bin by a time unit of an int-seconds coordinate — fully jit-traced.

  The device-side counterpart of ByTimeUnit for the hot pipeline path: time
  enters the jitted step as an int seconds array (device coord / leaf), so
  changing chunk times never retraces. Reference: ``binning.py:517-567``.
  """

  def __init__(self, unit: str, time_dim: str,
               bins: Sequence[int] | None = None):
    super().__init__(f'{time_dim}_{unit}')
    self.unit = unit
    self.time_dim = time_dim
    self.bins = bins

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    import jax.numpy as jnp

    c = statistic.coords[self.time_dim]
    coord = jnp.asarray(c.values)
    bins = self.bins
    if self.unit == 'second':
      bins = bins if bins is not None else np.arange(0, 60)
    elif self.unit == 'minute':
      coord = coord // 60
      bins = bins if bins is not None else np.arange(0, 60)
    elif self.unit == 'hour':
      coord = coord // 3600
      bins = bins if bins is not None else np.arange(0, 24)
    elif self.unit == 'day':
      coord = coord // 86400
      if bins is None:
        raise ValueError('bins must be given for unit="day"')
    else:
      raise ValueError(f'Unsupported unit: {self.unit}')
    bins = np.asarray(bins)
    masks = coord[None] == jnp.asarray(bins).reshape(
        (-1,) + (1,) * coord.ndim)
    coords = {self.bin_dim_name: Coord((self.bin_dim_name,), bins)}
    for name, cc in statistic.coords.items():
      if name not in coords and set(cc.dims).issubset(tuple(c.dims)):
        coords[name] = cc
    return DimArray(masks, (self.bin_dim_name,) + tuple(c.dims), coords)


class ByCoordBins(Binning):
  """Binning a coordinate into [left, right) edge intervals.

  Reference ``binning.py:570-637``. Bin labels are the left edges; with
  add_global_bin they become strings plus a 'global' bin.
  """

  def __init__(
      self,
      dim_name: str,
      bin_edges: np.ndarray,
      add_global_bin: bool = False,
  ):
    super().__init__(dim_name)
    self.dim_name = dim_name
    self.bin_edges = np.asarray(bin_edges)
    self.add_global_bin = add_global_bin

  @property
  def host_coords(self) -> tuple:
    return (self.dim_name,)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    c = statistic.coords[self.dim_name]
    values = np.asarray(c.values)
    starts, stops = self.bin_edges[:-1], self.bin_edges[1:]
    masks = (values[None] >= starts.reshape((-1,) + (1,) * values.ndim)) & (
        values[None] < stops.reshape((-1,) + (1,) * values.ndim))
    labels = starts.astype(str) if self.add_global_bin else starts
    if self.add_global_bin:
      masks = np.concatenate(
          [masks, np.ones((1,) + values.shape, bool)], axis=0)
      labels = np.concatenate([labels, np.array(['global'])])
    coords = {
        self.dim_name: Coord((self.dim_name,), labels),
        self.dim_name + '_left_edge': Coord((self.dim_name,), np.concatenate(
            [starts, [np.nan]]) if self.add_global_bin else starts),
        self.dim_name + '_right_edge': Coord((self.dim_name,), np.concatenate(
            [stops, [np.nan]]) if self.add_global_bin else stops),
    }
    for name, cc in statistic.coords.items():
      if name not in coords and set(cc.dims).issubset(tuple(c.dims)):
        coords[name] = cc
    return DimArray(masks, (self.dim_name,) + tuple(c.dims), coords)


class BySets(Binning):
  """Bin by named sets of coordinate values (e.g. station-name sets).

  Reference ``binning.py:640-705``; supports per-set complements and a
  global bin.
  """

  def __init__(
      self,
      sets: Mapping[str, Sequence[Any] | Any],
      coord_name: str,
      bin_dim_name: Optional[str] = None,
      add_set_complements: bool = False,
      add_global_bin: bool = False,
  ):
    if bin_dim_name is None or bin_dim_name == coord_name:
      raise ValueError(
          'bin_dim_name must be defined and be different from coord_name.')
    super().__init__(bin_dim_name)
    self.sets = dict(sets)
    self.coord_name = coord_name
    self.add_set_complements = add_set_complements
    self.add_global_bin = add_global_bin

  @property
  def host_coords(self) -> tuple:
    return (self.coord_name,)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    c = statistic.coords[self.coord_name]
    values = np.asarray(c.values)
    masks, labels = [], []
    for name, s in self.sets.items():
      s = list(s) if isinstance(s, Sequence) and not isinstance(s, str) else [s]
      m = np.isin(values, np.array(s))
      masks.append(m)
      labels.append(name)
      if self.add_set_complements:
        masks.append(~m)
        labels.append(f'not_in_{name}')
    if self.add_global_bin:
      masks.append(np.ones_like(values, dtype=bool))
      labels.append('global')
    coords = {self.bin_dim_name: Coord(
        (self.bin_dim_name,), np.array(labels))}
    for name, cc in statistic.coords.items():
      if name not in coords and set(cc.dims).issubset(tuple(c.dims)):
        coords[name] = cc
    return DimArray(np.stack(masks), (self.bin_dim_name,) + tuple(c.dims),
                    coords)
