"""Minimal numpy/pandas-backed xarray shim for running the REFERENCE code.

Purpose: the round-3 reference-parity harness (tests/test_reference_parity.py)
must execute the actual upstream weatherbenchX code (/root/reference) against
this repo's independent JAX implementation on identical fixtures. The
upstream code depends on the real ``xarray`` package, which is not installable
in this environment (no network egress). This shim implements the subset of the
xarray API that the reference's *single-chunk ground-truth path* uses
(reference ``aggregation.py:404-428`` and everything below it: metrics/*,
binning, weighting, xarray_tree, test_utils).

Design rules:
  * numpy + pandas only on the COMPUTE path. No numeric semantics may come
    from ``weatherbenchx_tpu`` (that would make the parity comparison
    circular). Sole exception: ``to_netcdf``/``open_dataset('.nc')`` reuse
    the repo's self-contained netCDF3 writer/reader as a byte transport —
    there a corrupting bug FAILS the upstream beam-pipeline test (direct,
    never-serialized values are compared against the serialized ones), it
    cannot manufacture a pass.
  * Faithful semantics for the operations actually exercised: named-dim
    broadcasting, inner-join label alignment for arithmetic, outer-join
    zero-fill for ``xr.align``, skipna defaults (True for float dtypes),
    vectorized ``.sel`` with DataArray indexers, ``.dt`` accessors, ``xr.dot``,
    ``apply_ufunc(vectorize=True)``, ``DataTree`` round-trips.
  * Anything not implemented raises loudly instead of guessing, so a parity
    "pass" can never come from silently-wrong shim behavior.

This file is a test harness component, not part of the shipped framework.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import operator
from typing import Any, Hashable, Iterable, Mapping, Sequence

import numpy as np
import pandas as pd

__version__ = '2025.1.0+wbx-refshim'

_OPTIONS = {'keep_attrs': False}


@contextlib.contextmanager
def set_options(**kwargs):
  old = {k: _OPTIONS.get(k) for k in kwargs}
  _OPTIONS.update(kwargs)
  try:
    yield
  finally:
    _OPTIONS.update(old)


def _as_values(obj) -> np.ndarray:
  """Coerce coordinate-ish input (ndarray, list, pd.Index, DataArray)."""
  if isinstance(obj, DataArray):
    return obj._data
  if isinstance(obj, (pd.Index, pd.Series)):
    return np.asarray(obj)
  return np.asarray(obj)


def _is_jaxish(x) -> bool:
  """Array-like that must NOT be converted to numpy (jax array / tracer)."""
  return 'jax' in type(x).__module__


def _ufunc_for(op, *operands):
  """The jnp counterpart of a numpy ufunc when any operand is jax-backed.

  The reference's statistical_inference/autodiff.py traces metric
  finalizers with jax.linearize THROUGH the (shim) xarray layer; numpy
  ufuncs called on tracers raise TracerArrayConversionError, so arithmetic
  must route through jax.numpy there.
  """
  if not any(_is_jaxish(o) for o in operands):
    return op
  import jax.numpy as jnp
  name = getattr(op, '__name__', None)
  fn = getattr(jnp, name, None) if name else None
  if fn is None:
    raise NotImplementedError(f'no jnp counterpart for {op}')
  return fn


def _is_scalar(v) -> bool:
  return np.ndim(v) == 0 and not isinstance(v, (list, tuple, DataArray))


def _check_coord_shape(owner, key, dims, vals):
  """Rejects coords whose length disagrees with the owner's dim sizes.

  xarray raises on a wrong-length dim coord; accepting one here would
  create an internally inconsistent array whose sel/align misbehaves far
  from the cause (shim rule: raise loudly, never be silently wrong).
  """
  sizes = owner.sizes
  shape = np.shape(vals)
  for ax, d in enumerate(dims):
    if d in sizes and ax < len(shape) and shape[ax] != sizes[d]:
      raise ValueError(
          f'conflicting size for coord {key!r} along dim {d!r}: '
          f'{shape[ax]} vs {sizes[d]}')


class _Coords(Mapping):
  """Mapping view over a DataArray/Dataset's coords, mutable via __setitem__."""

  def __init__(self, owner):
    self._owner = owner

  def __getitem__(self, key):
    if key not in self._owner._coords:
      # Real xarray (_get_virtual_variable): coords[dim] for a sized
      # dimension WITHOUT a coordinate returns a default 0..n-1 range
      # coordinate (relied on by statistical_inference/utils.py:48).
      sizes = self._owner.sizes
      if key in sizes:
        vals = np.arange(sizes[key])
        return DataArray._construct(vals, (key,), {key: ((key,), vals)}, key)
      raise KeyError(key)
    return self._owner._wrap_coord(key)

  def __setitem__(self, key, value):
    owner = self._owner
    if isinstance(value, DataArray):
      dims, vals = value._dims, value._data
    elif (isinstance(value, tuple) and len(value) == 2
          and isinstance(value[0], (str, tuple, list))):
      # xarray's (dims, values) coord tuple form.
      dims = (value[0],) if isinstance(value[0], str) else tuple(value[0])
      vals = _as_values(value[1])
      _check_coord_shape(owner, key, dims, vals)
      owner._coords[key] = (dims, vals)
      return
    else:
      vals = _as_values(value)
      if vals.ndim == 0:
        dims = ()
      elif vals.ndim == 1 and key in owner.dims:
        dims = (key,)
      elif key in owner._coords and len(owner._coords[key][0]) == vals.ndim:
        dims = owner._coords[key][0]
      else:
        raise NotImplementedError(
            f'cannot infer dims for coord {key!r} with shape {vals.shape}')
    _check_coord_shape(owner, key, tuple(dims), vals)
    owner._coords[key] = (tuple(dims), vals)

  def __delitem__(self, key):
    del self._owner._coords[key]

  def __iter__(self):
    return iter(self._owner._coords)

  def __len__(self):
    return len(self._owner._coords)

  def __contains__(self, key):
    return key in self._owner._coords

  def keys(self):
    return self._owner._coords.keys()

  def __or__(self, other):
    out = {k: self[k] for k in self}
    out.update(dict(other))
    return out


def _merge_coords(*coord_dicts, result_dims=None):
  """Union of coords; conflicting values are dropped (xarray arithmetic rule)."""
  out = {}
  dropped = set()
  for cd in coord_dicts:
    for name, (dims, vals) in cd.items():
      if name in dropped:
        continue
      if result_dims is not None and not set(dims).issubset(result_dims):
        continue
      if name in out:
        odims, ovals = out[name]
        if odims != dims or ovals.shape != vals.shape or not _values_equal(
            ovals, vals):
          del out[name]
          dropped.add(name)
      else:
        out[name] = (dims, vals)
  return out


def _values_equal(a, b) -> bool:
  if a.dtype != b.dtype:
    return False
  if a.dtype.kind == 'f':
    return bool(np.array_equal(a, b, equal_nan=True))
  return bool(np.array_equal(a, b))


def _default_skipna(dtype) -> bool:
  return dtype.kind in 'fcO'


class DataArray:
  """numpy-backed named-dimension array with coords, xarray-compatible subset."""

  __slots__ = ('_data', '_dims', '_coords', '_name', '_attrs')

  def __init__(self, data=None, coords=None, dims=None, name=None, attrs=None):
    if data is None and coords is None and dims is None:
      # Real xarray: DataArray() is a 0-d float NaN scalar (the reference's
      # empty-input sentinel, beam_pipeline.py:294).
      data = np.nan
    if isinstance(data, DataArray):
      dims_tuple = ((dims,) if isinstance(dims, str) else
                    tuple(dims) if dims is not None else None)
      if coords is None and (dims_tuple is None or dims_tuple == data._dims):
        # Re-wrap with same dims (real xarray allows restating them).
        self._data = data._data
        self._dims = data._dims
        self._coords = dict(data._coords)
        self._name = name if name is not None else data._name
        self._attrs = dict(attrs if attrs is not None else data._attrs)
        return
      # New dims/coords: rebuild from the values, like real xarray.
      data = data._data
    if isinstance(data, (pd.Index, pd.Series)):
      data = np.asarray(data)
    if not _is_jaxish(data):
      data = np.asarray(data)
    self._name = name
    self._attrs = dict(attrs or {})
    coord_map = {}
    if dims is None:
      if coords is not None and not isinstance(coords, Mapping):
        # coords as sequence of (dim, values) pairs / 1-d arrays per dim.
        seq = list(coords)
        dims = []
        for i, c in enumerate(seq):
          if isinstance(c, tuple) and len(c) == 2:
            dims.append(c[0])
          elif isinstance(c, DataArray):
            dims.append(c._name or c._dims[0])
          elif isinstance(c, pd.Index) and c.name:
            dims.append(c.name)
          else:
            raise NotImplementedError('unnamed coords sequence')
        coords = {d: (c[1] if isinstance(c, tuple) else c)
                  for d, c in zip(dims, seq)}
      elif data.ndim == 0:
        dims = ()
      elif (isinstance(coords, Mapping) and len(coords) == data.ndim
            and all(np.ndim(_as_values(v)) == 1
                    and len(_as_values(v)) == n
                    for v, n in zip(coords.values(), data.shape))):
        # xarray sugar: dims inferred from 1-D coords entries, in order.
        dims = tuple(coords.keys())
      else:
        raise NotImplementedError('DataArray without dims for ndim>0')
    if isinstance(dims, str):
      dims = (dims,)
    dims = tuple(dims)
    if data.ndim == 0 and dims and isinstance(coords, Mapping) and all(
        d in coords for d in dims):
      # Real xarray broadcasts scalar data to the shape implied by coords
      # (e.g. DataArray(0.5, dims=['threshold'], coords={'threshold': [0.5]})).
      shape = tuple(len(np.atleast_1d(_as_values(coords[d]))) for d in dims)
      data = np.full(shape, data[()])
    if len(dims) != data.ndim:
      raise ValueError(f'dims {dims} do not match data shape {data.shape}')
    if coords is not None:
      if not isinstance(coords, Mapping):
        raise NotImplementedError('coords must be a mapping here')
      for cname, cval in coords.items():
        if isinstance(cval, DataArray):
          coord_map[cname] = (cval._dims, cval._data)
        elif isinstance(cval, tuple) and len(cval) == 2 and (
            isinstance(cval[0], (tuple, list, str))):
          cdims = (cval[0],) if isinstance(cval[0], str) else tuple(cval[0])
          coord_map[cname] = (cdims, _as_values(cval[1]))
        else:
          vals = _as_values(cval)
          if vals.ndim == 0:
            coord_map[cname] = ((), vals)
          elif vals.ndim == 1 and cname in dims:
            coord_map[cname] = ((cname,), vals)
          else:
            raise NotImplementedError(
                f'cannot infer dims for coord {cname!r}')
    for cname, (cdims, cvals) in coord_map.items():
      for d, n in zip(cdims, cvals.shape):
        if d in dims and n != data.shape[dims.index(d)]:
          raise ValueError(f'coord {cname!r} conflicts on dim {d!r}')
    self._data = data
    self._dims = dims
    self._coords = coord_map

  # -- construction helpers ----------------------------------------------------

  @classmethod
  def _construct(cls, data, dims, coords, name=None, attrs=None):
    out = cls.__new__(cls)
    out._data = data if _is_jaxish(data) else np.asarray(data)
    out._dims = tuple(dims)
    out._coords = dict(coords)
    out._name = name
    out._attrs = dict(attrs or {})
    return out

  def _wrap_coord(self, name) -> 'DataArray':
    dims, vals = self._coords[name]
    # Like xarray: the wrapped coord carries ALL coords whose dims are a
    # subset of its own (e.g. station 'elevation' rides on ref['latitude']
    # over 'index' — the altitude-adjustment interpolation relies on it).
    sub = {n: c for n, c in self._coords.items()
           if set(c[0]).issubset(dims)}
    sub[name] = (dims, vals)
    return DataArray._construct(vals, dims, sub, name=name)

  # -- basic properties --------------------------------------------------------

  @property
  def data(self):
    return self._data

  @data.setter
  def data(self, value):
    value = np.asarray(value)
    if value.shape != self._data.shape:
      raise ValueError('shape mismatch in .data setter')
    self._data = value

  @property
  def values(self):
    return self._data

  @property
  def dims(self):
    return self._dims

  @property
  def shape(self):
    return self._data.shape

  @property
  def ndim(self):
    return self._data.ndim

  @property
  def size(self):
    return self._data.size

  @property
  def dtype(self):
    return self._data.dtype

  @property
  def sizes(self):
    return dict(zip(self._dims, self._data.shape))

  @property
  def name(self):
    return self._name

  @name.setter
  def name(self, value):
    self._name = value

  @property
  def attrs(self):
    return self._attrs

  @property
  def coords(self):
    return _Coords(self)

  @property
  def indexes(self):
    return {d: pd.Index(self._coords[d][1]) for d in self._dims
            if d in self._coords and self._coords[d][0] == (d,)}

  def _index(self, dim) -> pd.Index | None:
    c = self._coords.get(dim)
    if c is not None and c[0] == (dim,):
      return pd.Index(c[1])
    return None

  def __repr__(self):
    coords = ', '.join(f'{k}{list(v[0])}' for k, v in self._coords.items())
    return (f'<shim.DataArray {self._name or ""}{list(self._dims)} '
            f'shape={self._data.shape} dtype={self._data.dtype} '
            f'coords=[{coords}]>\n{self._data!r}')

  def __len__(self):
    if not self._dims:
      raise TypeError('len() of 0-d DataArray')
    return self._data.shape[0]

  def __iter__(self):
    # Without this, iter() falls back to the legacy __getitem__ protocol,
    # which never raises IndexError for a 0-d array (label indexing) and
    # loops forever. Real xarray raises TypeError on 0-d iteration.
    if not self._dims:
      raise TypeError('iteration over a 0-d array')
    return (self[i] for i in range(self._data.shape[0]))

  # -- attribute/coord access --------------------------------------------------

  def __getattr__(self, name):
    if name.startswith('_'):
      raise AttributeError(name)
    coords = object.__getattribute__(self, '_coords')
    if name in coords:
      return self._wrap_coord(name)
    raise AttributeError(name)

  def __getitem__(self, key):
    if isinstance(key, str):
      if key in self._coords:
        return self._wrap_coord(key)
      raise KeyError(key)
    if isinstance(key, dict):
      return self.isel(key)
    # Positional indexing along leading dims (ints/slices only).
    if not isinstance(key, tuple):
      key = (key,)
    if any(isinstance(k, (list, np.ndarray, DataArray)) for k in key):
      raise NotImplementedError('positional fancy indexing')
    indexers = {}
    for d, k in zip(self._dims, key):
      indexers[d] = k
    return self.isel(indexers)

  def __setitem__(self, key, value):
    # In-place assignment à la real xarray: dict keys are dim->positional
    # indexers; plain keys index leading dims positionally.
    if isinstance(value, DataArray):
      value = value._data
    if isinstance(key, dict):
      sl = [slice(None)] * self._data.ndim
      for d, k in key.items():
        if d not in self._dims:
          raise KeyError(d)
        if isinstance(k, DataArray):
          k = k._data
        sl[self._dims.index(d)] = k
      key = tuple(sl)
    # No silent copy-on-write: callers (e.g. ds['var'][{'time': 0}] = x)
    # rely on mutating the buffer shared with the parent Dataset.
    self._data[key] = value

  # -- conversions -------------------------------------------------------------

  def __array__(self, dtype=None, copy=None):
    arr = self._data
    if dtype is not None:
      arr = arr.astype(dtype)
    return np.array(arr, copy=True) if copy else np.asarray(arr)

  def __float__(self):
    return float(self._data)

  def __int__(self):
    return int(self._data)

  def __bool__(self):
    return bool(self._data)

  def item(self):
    return self._data.item()

  def astype(self, dtype, **kwargs):
    if dtype in ('str', str):
      dtype = np.str_
    return DataArray._construct(self._data.astype(dtype), self._dims,
                                self._coords, self._name, self._attrs)

  def copy(self, deep=True, data=None):
    new = np.array(self._data, copy=True) if data is None else np.asarray(data)
    if data is not None and new.shape != self._data.shape:
      raise ValueError('copy(data=...) shape mismatch')
    return DataArray._construct(new, self._dims, dict(self._coords),
                                self._name, dict(self._attrs))

  def compute(self):
    return self

  def load(self):
    return self

  def chunk(self, *args, **kwargs):
    return self

  def rename(self, new_name_or_name_dict=None, **names):
    if isinstance(new_name_or_name_dict, (str, type(None))) and not names:
      # Real xarray: rename(None) (or rename() with no args) clears the name.
      out = self.copy(deep=False)
      out._name = new_name_or_name_dict
      return out
    mapping = dict(new_name_or_name_dict or {})
    mapping.update(names)
    new_dims = tuple(mapping.get(d, d) for d in self._dims)
    new_coords = {}
    for cname, (cdims, cvals) in self._coords.items():
      new_coords[mapping.get(cname, cname)] = (
          tuple(mapping.get(d, d) for d in cdims), cvals)
    return DataArray._construct(self._data, new_dims, new_coords,
                                self._name, self._attrs)

  def to_dataset(self, name=None):
    nm = name or self._name
    if nm is None:
      raise ValueError('cannot convert unnamed DataArray to Dataset')
    ds = Dataset()
    ds[nm] = self
    return ds

  # -- arithmetic --------------------------------------------------------------

  def _align_with(self, other: 'DataArray'):
    """Inner-join label alignment on shared dims that both index."""
    a, b = self, other
    for dim in set(a._dims) & set(b._dims):
      ia, ib = a._index(dim), b._index(dim)
      if ia is None or ib is None:
        if a.sizes[dim] != b.sizes[dim]:
          raise ValueError(
              f'dim {dim!r} has mismatched sizes and no indexes to align')
        continue
      if len(ia) == len(ib) and _values_equal(np.asarray(ia), np.asarray(ib)):
        continue
      common = ia.intersection(ib)
      a = a.sel({dim: np.asarray(common)})
      b = b.sel({dim: np.asarray(common)})
    return a, b

  def _binary_op(self, other, op, reflexive=False):
    if isinstance(other, Dataset):
      return NotImplemented
    if not isinstance(other, DataArray):
      if isinstance(other, (pd.Index, pd.Series)):
        other = np.asarray(other)
      oarr = other if _is_jaxish(other) else np.asarray(other)
      op = _ufunc_for(op, oarr, self._data)
      res = op(oarr, self._data) if reflexive else op(self._data, oarr)
      return DataArray._construct(res, self._dims, self._coords,
                                  self._name, self._attrs)
    a, b = self._align_with(other)
    dims = tuple(a._dims) + tuple(d for d in b._dims if d not in a._dims)
    av = _reshape_for(a, dims)
    bv = _reshape_for(b, dims)
    op = _ufunc_for(op, av, bv)
    res = op(bv, av) if reflexive else op(av, bv)
    coords = _merge_coords(a._coords, b._coords, result_dims=set(dims))
    # Trim dims tuple if broadcasting dropped nothing (it can't), keep order.
    return DataArray._construct(res, dims, coords)

  __add__ = lambda s, o: s._binary_op(o, np.add)
  __radd__ = lambda s, o: s._binary_op(o, np.add, True)
  __sub__ = lambda s, o: s._binary_op(o, np.subtract)
  __rsub__ = lambda s, o: s._binary_op(o, np.subtract, True)
  __mul__ = lambda s, o: s._binary_op(o, np.multiply)
  __rmul__ = lambda s, o: s._binary_op(o, np.multiply, True)
  __truediv__ = lambda s, o: s._binary_op(o, np.true_divide)
  __rtruediv__ = lambda s, o: s._binary_op(o, np.true_divide, True)
  __floordiv__ = lambda s, o: s._binary_op(o, np.floor_divide)
  __mod__ = lambda s, o: s._binary_op(o, np.mod)
  __pow__ = lambda s, o: s._binary_op(o, np.power)
  __rpow__ = lambda s, o: s._binary_op(o, np.power, True)
  __and__ = lambda s, o: s._binary_op(o, np.logical_and)
  __rand__ = lambda s, o: s._binary_op(o, np.logical_and, True)
  __or__ = lambda s, o: s._binary_op(o, np.logical_or)
  __ror__ = lambda s, o: s._binary_op(o, np.logical_or, True)
  __xor__ = lambda s, o: s._binary_op(o, np.logical_xor)
  __lt__ = lambda s, o: s._binary_op(o, np.less)
  __le__ = lambda s, o: s._binary_op(o, np.less_equal)
  __gt__ = lambda s, o: s._binary_op(o, np.greater)
  __ge__ = lambda s, o: s._binary_op(o, np.greater_equal)
  __eq__ = lambda s, o: s._binary_op(o, np.equal)
  __ne__ = lambda s, o: s._binary_op(o, np.not_equal)

  __hash__ = None

  def __invert__(self):
    return DataArray._construct(np.logical_not(self._data)
                                if self._data.dtype == bool
                                else np.invert(self._data),
                                self._dims, self._coords, self._name)

  def __neg__(self):
    return DataArray._construct(-self._data, self._dims, self._coords,
                                self._name)

  def as_numpy(self):
    d = self._data
    if _is_jaxish(d):
      d = np.asarray(d)
    return DataArray._construct(d, self._dims, self._coords, self._name,
                                self._attrs)

  def __pos__(self):
    return self

  def __abs__(self):
    return DataArray._construct(_ufunc_for(np.abs, self._data)(self._data),
                                self._dims, self._coords, self._name)

  def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
    if method != '__call__' or kwargs.get('out') is not None:
      return NotImplemented
    das = [x for x in inputs if isinstance(x, DataArray)]
    if len(inputs) == 1:
      fn = _ufunc_for(ufunc, self._data)
      return DataArray._construct(
          fn(self._data, **kwargs), self._dims, self._coords, self._name,
          self._attrs)
    if len(inputs) == 2:
      a, b = inputs
      if isinstance(a, DataArray):
        return a._binary_op(b, lambda x, y: ufunc(x, y, **kwargs))
      else:
        return b._binary_op(a, lambda x, y: ufunc(x, y, **kwargs),
                            reflexive=True)
    return NotImplemented

  def clip(self, min=None, max=None):
    return DataArray._construct(np.clip(self._data, min, max), self._dims,
                                self._coords, self._name, self._attrs)

  def round(self, decimals=0):
    return DataArray._construct(np.round(self._data, decimals), self._dims,
                                self._coords, self._name, self._attrs)

  def isnull(self):
    d = self._data
    if d.dtype.kind in 'fc':
      res = _ufunc_for(np.isnan, d)(d)
    elif d.dtype.kind in 'mM':
      res = np.isnat(d)
    else:
      res = np.zeros(d.shape, dtype=bool)
    return DataArray._construct(res, self._dims, self._coords, self._name)

  def notnull(self):
    return self.isnull().__invert__()

  def fillna(self, value):
    return self.where(self.notnull(), value)

  def equals(self, other):
    if not isinstance(other, DataArray):
      return False
    if self._dims != other._dims or self.shape != other.shape:
      return False
    if self.dtype != other.dtype or not _values_equal(self._data, other._data):
      return False
    for d in self._dims:
      ia, ib = self._index(d), other._index(d)
      if (ia is None) != (ib is None):
        return False
      if ia is not None and not _values_equal(np.asarray(ia), np.asarray(ib)):
        return False
    return True

  def identical(self, other):
    return self.equals(other)

  def isin(self, values):
    vals = np.asarray(_as_values(values))
    if vals.dtype == object:
      # np.array([...]) over a 0-d DataArray element wraps the DataArray
      # itself (numpy's sequence-protocol discovery can't use __array__
      # there); unwrap such elements to their scalar values so membership
      # matches real xarray behavior.
      def _unwrap(e):
        if isinstance(e, DataArray):
          e = e._data
        if isinstance(e, np.ndarray) and e.ndim == 0:
          e = e.item()
        return e
      vals = np.array([_unwrap(e) for e in vals.ravel()], dtype=object)
    return DataArray._construct(np.isin(self._data, vals), self._dims,
                                self._coords, self._name)

  # -- reductions --------------------------------------------------------------

  def _reduce_dims(self, dim):
    if dim is None or dim is Ellipsis:
      return list(self._dims)
    if isinstance(dim, str):
      return [dim]
    return list(dim)

  def _reduce(self, dim, skipna, nanfunc, func, dtype_out=None, **kwargs):
    # numpy's np.all(da)/np.sum(da)/... protocol passes axis/out/keepdims.
    axis = kwargs.pop('axis', None)
    if axis is not None:
      if dim is not None:
        raise ValueError('pass either dim or axis, not both')
      dim = self._dims[axis] if isinstance(axis, int) else [
          self._dims[a] for a in axis]
    if kwargs.pop('out', None) is not None:
      raise NotImplementedError('out=')
    if kwargs.pop('keepdims', False):
      raise NotImplementedError('keepdims=')
    kwargs.pop('where', None)
    dims = self._reduce_dims(dim)
    if dim is not None and not isinstance(dim, str) and not dims:
      # Explicit empty dim collection: reduce over nothing — a no-op in
      # xarray, NOT a reduce-over-everything (which `axis=None` would do).
      return DataArray._construct(
          self._data, self._dims, dict(self._coords), self._name,
          self._attrs if _OPTIONS['keep_attrs'] else {})
    for d in dims:
      if d not in self._dims:
        raise ValueError(f'dim {d!r} not found in {self._dims}')
    axes = tuple(self._dims.index(d) for d in dims)
    if skipna is None:
      skipna = _default_skipna(self._data.dtype)
    f = nanfunc if (skipna and self._data.dtype.kind in 'fc') else func
    if _is_jaxish(self._data):
      import jax.numpy as jnp
      f = getattr(jnp, f.__name__)
    res = f(self._data, axis=axes, **kwargs) if axes else (
        f(self._data, axis=None, **kwargs) if _is_jaxish(self._data)
        else np.asarray(f(self._data, axis=None, **kwargs)))
    if dtype_out is not None:
      res = res.astype(dtype_out)
    new_dims = tuple(d for d in self._dims if d not in dims)
    coords = {n: c for n, c in self._coords.items()
              if not (set(c[0]) & set(dims))}
    return DataArray._construct(res, new_dims, coords, self._name,
                                self._attrs if _OPTIONS['keep_attrs'] else {})

  def mean(self, dim=None, *, skipna=None, **kwargs):
    kwargs.pop('keep_attrs', None)
    return self._reduce(dim, skipna, np.nanmean, np.mean, **kwargs)

  def sum(self, dim=None, *, skipna=None, **kwargs):
    kwargs.pop('keep_attrs', None)
    return self._reduce(dim, skipna, np.nansum, np.sum, **kwargs)

  def std(self, dim=None, *, skipna=None, ddof=0, **kwargs):
    return self._reduce(dim, skipna, np.nanstd, np.std, ddof=ddof, **kwargs)

  def var(self, dim=None, *, skipna=None, ddof=0, **kwargs):
    return self._reduce(dim, skipna, np.nanvar, np.var, ddof=ddof, **kwargs)

  def min(self, dim=None, *, skipna=None, **kwargs):
    return self._reduce(dim, skipna, np.nanmin, np.min, **kwargs)

  def max(self, dim=None, *, skipna=None, **kwargs):
    return self._reduce(dim, skipna, np.nanmax, np.max, **kwargs)

  def prod(self, dim=None, *, skipna=None, **kwargs):
    return self._reduce(dim, skipna, np.nanprod, np.prod, **kwargs)

  def median(self, dim=None, *, skipna=None, **kwargs):
    return self._reduce(dim, skipna, np.nanmedian, np.median, **kwargs)

  def any(self, dim=None, **kwargs):
    return self._reduce(dim, False, np.any, np.any, **kwargs)

  def all(self, dim=None, **kwargs):
    return self._reduce(dim, False, np.all, np.all, **kwargs)

  def count(self, dim=None):
    notnull = self.notnull()
    return notnull._reduce(dim, False, np.sum, np.sum, dtype_out=np.int64)

  def cumsum(self, dim=None, *, skipna=None):
    dims = self._reduce_dims(dim)
    if len(dims) != 1:
      raise NotImplementedError('cumsum over multiple dims')
    axis = self._dims.index(dims[0])
    if skipna is None:
      skipna = _default_skipna(self._data.dtype)
    f = np.nancumsum if (skipna and self._data.dtype.kind in 'fc') else \
        np.cumsum
    return DataArray._construct(f(self._data, axis=axis), self._dims,
                                self._coords, self._name, self._attrs)

  def quantile(self, q, dim=None, *, skipna=None, **kwargs):
    kwargs.pop('keep_attrs', None)
    method = kwargs.pop('method', 'linear')
    if kwargs:
      raise NotImplementedError(f'quantile kwargs {kwargs}')
    dims = self._reduce_dims(dim)
    axes = tuple(self._dims.index(d) for d in dims)
    if skipna is None:
      skipna = _default_skipna(self._data.dtype)
    f = np.nanquantile if skipna else np.quantile
    qarr = np.asarray(q, dtype=np.float64)
    res = f(self._data, qarr, axis=axes, method=method)
    new_dims = tuple(d for d in self._dims if d not in dims)
    coords = {n: c for n, c in self._coords.items()
              if not (set(c[0]) & set(dims))}
    if qarr.ndim == 0:
      coords['quantile'] = ((), qarr)
      return DataArray._construct(res, new_dims, coords, self._name)
    coords['quantile'] = (('quantile',), qarr)
    return DataArray._construct(res, ('quantile',) + new_dims, coords,
                                self._name)

  def diff(self, dim, n=1, *, label='upper'):
    axis = self._dims.index(dim)
    res = np.diff(self._data, n=n, axis=axis)
    coords = dict(self._coords)
    for cname, (cdims, cvals) in list(coords.items()):
      if dim in cdims:
        ax = cdims.index(dim)
        sl = [slice(None)] * cvals.ndim
        sl[ax] = slice(n, None) if label == 'upper' else slice(None, -n)
        coords[cname] = (cdims, cvals[tuple(sl)])
    return DataArray._construct(res, self._dims, coords, self._name,
                                self._attrs)

  def argmax(self, dim=None, *, skipna=None):
    dims = self._reduce_dims(dim)
    if len(dims) != 1:
      raise NotImplementedError('argmax over multiple dims')
    axis = self._dims.index(dims[0])
    res = np.argmax(self._data, axis=axis).astype(np.int64)
    new_dims = tuple(d for d in self._dims if d != dims[0])
    coords = {n: c for n, c in self._coords.items() if dims[0] not in c[0]}
    return DataArray._construct(res, new_dims, coords, self._name)

  def idxmax(self, dim, *, skipna=None):
    index = self._index(dim)
    if index is None:
      raise ValueError(f'idxmax requires an index on {dim!r}')
    arg = self.argmax(dim)
    labels = np.asarray(index)[arg._data]
    return DataArray._construct(labels, arg._dims, arg._coords, self._name)

  # -- selection ---------------------------------------------------------------

  def isel(self, indexers=None, drop=False, **kwargs):
    indexers = dict(indexers or {})
    indexers.update(kwargs)
    for d in indexers:
      if d not in self._dims:
        raise ValueError(f'isel dim {d!r} not in {self._dims}')
      v = indexers[d]
      if (isinstance(v, (list, tuple, np.ndarray))
          and np.asarray(v).size == 0):
        # Empty positional indexers default to float64 via np.asarray; keep
        # them integer so np.take (data and coords paths alike) accepts them.
        indexers[d] = np.asarray(v, dtype=np.intp)
    vec = {d: v for d, v in indexers.items() if isinstance(v, DataArray)
           and v.ndim > 0}
    if vec:
      return self._isel_vectorized(indexers, drop=drop)
    data = self._data
    out_dims = []
    idx = []
    for d in self._dims:
      k = indexers.get(d, slice(None))
      if isinstance(k, DataArray):
        k = k._data.item() if k.ndim == 0 else k._data
      if _is_scalar(k) and not isinstance(k, slice):
        idx.append(int(k))
      elif isinstance(k, slice):
        idx.append(k)
        out_dims.append(d)
      else:
        k = np.asarray(k)
        if k.size == 0 and k.dtype != bool:
          # np.asarray([]) defaults to float64; empty positional indexers
          # (e.g. isel(index=[])) must still be integer for np.take.
          k = k.astype(np.intp)
        if k.dtype == bool:
          # Boolean indexers are selection masks, not integer indices.
          if k.shape != (self.sizes[d],):
            raise IndexError(
                f'boolean indexer for dim {d!r} has shape {k.shape}, '
                f'expected ({self.sizes[d]},)')
          k = np.flatnonzero(k)
        idx.append(k)
        out_dims.append(d)
    # Apply orthogonal indexing one axis at a time to avoid advanced-index
    # broadcasting interactions.
    res = data
    offset = 0
    for ax, k in enumerate(idx):
      take_ax = ax - offset
      if isinstance(k, slice):
        if k != slice(None):
          sl = [slice(None)] * res.ndim
          sl[take_ax] = k
          res = res[tuple(sl)]
      elif np.ndim(k) == 0:
        res = np.take(res, k, axis=take_ax)
        if data.dtype == object and not isinstance(res, np.ndarray):
          # np.take with a scalar index on an object array returns the bare
          # element (e.g. a str); keep dtype=object like real xarray does.
          res = np.array(res, dtype=object)
        offset += 1
      else:
        res = np.take(res, k, axis=take_ax)
    coords = {}
    for cname, (cdims, cvals) in self._coords.items():
      csel = []
      new_cdims = []
      for cd in cdims:
        k = indexers.get(cd, slice(None))
        if isinstance(k, DataArray):
          k = k._data.item() if k.ndim == 0 else k._data
        if _is_scalar(k) and not isinstance(k, slice):
          csel.append(int(k))
        else:
          if isinstance(k, slice):
            csel.append(k)
          else:
            k = np.asarray(k)
            if k.dtype == bool:
              k = np.flatnonzero(k)
            csel.append(k)
          new_cdims.append(cd)
      cv = cvals
      off = 0
      for ax, k in enumerate(csel):
        if isinstance(k, slice):
          if k != slice(None):
            sl = [slice(None)] * cv.ndim
            sl[ax - off] = k
            cv = cv[tuple(sl)]
        elif np.ndim(k) == 0:
          cv = np.take(cv, k, axis=ax - off)
          off += 1
        else:
          cv = np.take(cv, k, axis=ax - off)
      if not (drop and not new_cdims and cdims):
        coords[cname] = (tuple(new_cdims), cv)
    return DataArray._construct(res, tuple(out_dims), coords, self._name,
                                self._attrs)

  def _isel_vectorized(self, indexers, drop=False):
    sel_dims = [d for d in self._dims if d in indexers]
    kept = [d for d in self._dims if d not in indexers]
    idx_das = []
    for d in sel_dims:
      v = indexers[d]
      if not isinstance(v, DataArray):
        v = DataArray(np.asarray(v), dims=(f'_pos_{d}',))
      idx_das.append(v)
    indexer_dims = []
    for v in idx_das:
      for d in v._dims:
        if d not in indexer_dims:
          indexer_dims.append(d)
    # Result dims: kept dims in order, then indexer dims not already kept.
    # Indexer dims matching kept dims select pointwise (xarray diagonal rule).
    out_dims = tuple(kept) + tuple(d for d in indexer_dims if d not in kept)
    sizes = {}
    for d in kept:
      sizes[d] = self.sizes[d]
    for v in idx_das:
      for d in v._dims:
        if d in sizes:
          if sizes[d] != v.sizes[d]:
            raise ValueError(
                f'indexer dim {d!r} size {v.sizes[d]} conflicts with '
                f'array dim size {sizes[d]}')
        else:
          sizes[d] = v.sizes[d]
    out_shape = tuple(sizes[d] for d in out_dims)

    def place(arr: np.ndarray, dims: Sequence[str]) -> np.ndarray:
      """Reshape arr (with named dims) to broadcast within out_dims space."""
      shape = [sizes[d] if d in dims else 1 for d in out_dims]
      order = [d for d in out_dims if d in dims]
      t = np.transpose(arr, [list(dims).index(d) for d in order])
      return t.reshape(shape)

    index_tuple = []
    for d in self._dims:
      if d in indexers:
        v = idx_das[sel_dims.index(d)]
        index_tuple.append(place(v._data, v._dims))
      else:
        n = self.sizes[d]
        index_tuple.append(place(np.arange(n), (d,)))
    res = np.broadcast_to(
        self._data[tuple(np.broadcast_arrays(*index_tuple))], out_shape)
    coords = {}
    for cname, (cdims, cvals) in self._coords.items():
      if set(cdims) & set(sel_dims):
        if cdims == (cname,) and cname in sel_dims:
          # Label coord for a selected dim → non-dim coord over indexer dims.
          i = sel_dims.index(cname)
          v = idx_das[i]
          coords[cname] = (v._dims, cvals[v._data])
        continue
      coords[cname] = (cdims, cvals)
    for v in idx_das:
      for cname, (cdims, cvals) in v._coords.items():
        if cname in coords or cname in self._dims:
          continue
        if set(cdims).issubset(out_dims):
          coords[cname] = (cdims, cvals)
    return DataArray._construct(np.array(res), out_dims, coords, self._name,
                                self._attrs)

  def _label_to_positional(self, dim, key, method=None, tolerance=None):
    index = self._index(dim)
    if index is None:
      # Real xarray: sel along a dimension WITHOUT an index falls back to
      # positional (isel) semantics — labels must be integers
      # (e.g. metrics/base.py:403 selecting into an expand_dims(dayofyear=366)
      # climatology).
      if method is not None or tolerance is not None:
        raise KeyError(f'no index for dim {dim!r}')
      if isinstance(key, slice):
        return key
      if isinstance(key, DataArray):
        pos = key._data.astype(np.intp)
        return DataArray._construct(pos, key._dims, key._coords, key._name)
      if _is_scalar(key):
        return int(key)
      return _as_values(key).astype(np.intp)
    if isinstance(key, slice):
      start, stop = key.start, key.stop
      res = index.slice_indexer(start, stop, key.step)
      return res
    if isinstance(key, DataArray):
      vals = key._data
      pos = index.get_indexer(np.ravel(vals), method=method,
                              tolerance=tolerance)
      if (pos < 0).any():
        missing = np.ravel(vals)[pos < 0][:5]
        raise KeyError(f'labels {missing} not found in index for {dim!r}')
      return DataArray._construct(pos.reshape(vals.shape), key._dims,
                                  key._coords, key._name)
    if _is_scalar(key):
      if method is None:
        loc = index.get_loc(key)
      else:
        loc = index.get_indexer([key], method=method,
                                tolerance=tolerance)[0]
        if loc < 0:
          raise KeyError(key)
      if not isinstance(loc, (int, np.integer)):
        raise NotImplementedError('non-unique index scalar sel')
      return int(loc)
    vals = _as_values(key)
    pos = index.get_indexer(vals, method=method, tolerance=tolerance)
    if (pos < 0).any():
      missing = vals[pos < 0][:5]
      raise KeyError(f'labels {missing} not found in index for {dim!r}')
    return pos

  def sel(self, indexers=None, method=None, tolerance=None, drop=False,
          **kwargs):
    indexers = dict(indexers or {})
    indexers.update(kwargs)
    pos = {}
    for d, key in indexers.items():
      p = self._label_to_positional(d, key, method=method,
                                    tolerance=tolerance)
      pos[d] = p
    return self.isel(pos, drop=drop)

  def where(self, cond, other=np.nan):
    if not isinstance(cond, DataArray):
      cond = DataArray(np.asarray(cond))
    a, c = self._align_with(cond)
    o = None
    if isinstance(other, DataArray):
      # Three-way inner alignment: aligning with `other` can shrink `a`, which
      # in turn invalidates the earlier a/c alignment (and vice versa), so
      # re-align until consistent.  Crucially the *aligned* `o` must be used
      # below — using the raw `other` would mix label orders.
      a, o = a._align_with(other)
      a, c = a._align_with(c)
      a, o = a._align_with(o)
    dims = tuple(a._dims) + tuple(d for d in c._dims if d not in a._dims)
    if o is not None:
      dims = dims + tuple(d for d in o._dims if d not in dims)
    av = _reshape_for(a, dims)
    cv = _reshape_for(c, dims)
    if o is not None:
      ov = _reshape_for(o, dims)
      coords = _merge_coords(a._coords, c._coords, o._coords,
                             result_dims=set(dims))
    else:
      ov = other
      coords = _merge_coords(a._coords, c._coords, result_dims=set(dims))
    res = _ufunc_for(np.where, cv, ov)(cv, av, ov)
    return DataArray._construct(res, dims, coords, a._name, a._attrs)

  # -- reshaping ---------------------------------------------------------------

  def expand_dims(self, dim=None, axis=None, **dim_kwargs):
    if isinstance(dim, str):
      dims_map = {dim: 1}
    elif isinstance(dim, Mapping):
      dims_map = dict(dim)
    elif isinstance(dim, (list, tuple)):
      dims_map = {d: 1 for d in dim}
    elif dim is None:
      dims_map = {}
    else:
      raise NotImplementedError(f'expand_dims dim={dim!r}')
    dims_map.update(dim_kwargs)
    out = self
    pos = axis if axis is not None else 0
    if not isinstance(pos, int):
      raise NotImplementedError('expand_dims with non-int axis')
    for name, val in reversed(list(dims_map.items())):
      if isinstance(val, int):
        n = val
        coord_vals = None
      else:
        coord_vals = _as_values(val)
        n = len(coord_vals)
      data = np.expand_dims(out._data, pos)
      if n != 1:
        data = np.broadcast_to(
            data, data.shape[:pos] + (n,) + data.shape[pos + 1:]).copy()
      new_dims = out._dims[:pos] + (name,) + out._dims[pos:]
      coords = dict(out._coords)
      if coord_vals is not None:
        coords[name] = ((name,), coord_vals)
      elif name in coords and coords[name][0] == ():
        coords[name] = ((name,), coords[name][1].reshape(1))
      out = DataArray._construct(data, new_dims, coords, out._name,
                                 out._attrs)
    return out

  def squeeze(self, dim=None, drop=False):
    if dim is None:
      dims = [d for d in self._dims if self.sizes[d] == 1]
    elif isinstance(dim, str):
      dims = [dim]
    else:
      dims = list(dim)
    indexers = {d: 0 for d in dims}
    return self.isel(indexers, drop=drop)

  def transpose(self, *dims):
    if not dims:
      dims = tuple(reversed(self._dims))
    if Ellipsis in dims:
      listed = [d for d in dims if d is not Ellipsis]
      rest = [d for d in self._dims if d not in listed]
      i = dims.index(Ellipsis)
      dims = tuple(listed[:i]) + tuple(rest) + tuple(listed[i:])
    order = [self._dims.index(d) for d in dims]
    return DataArray._construct(np.transpose(self._data, order), tuple(dims),
                                self._coords, self._name, self._attrs)

  def broadcast_like(self, other: 'DataArray'):
    dims = tuple(other._dims) + tuple(d for d in self._dims
                                      if d not in other._dims)
    a, b = self._align_with(other)
    shape = []
    for d in dims:
      if d in b._dims:
        shape.append(b.sizes[d])
      else:
        shape.append(a.sizes[d])
    av = np.broadcast_to(_reshape_for(a, dims), tuple(shape))
    coords = _merge_coords(a._coords, b._coords, result_dims=set(dims))
    return DataArray._construct(av.copy(), dims, coords, a._name, a._attrs)

  def assign_coords(self, coords=None, **kwargs):
    out = self.copy(deep=False)
    mapping = dict(coords or {})
    mapping.update(kwargs)
    for k, v in mapping.items():
      _Coords(out)[k] = v
    return out

  def assign_attrs(self, *args, **kwargs):
    out = self.copy(deep=False)
    out._attrs.update(dict(*args, **kwargs))
    return out

  def drop_vars(self, names, *, errors='raise'):
    if isinstance(names, str):
      names = [names]
    coords = dict(self._coords)
    for n in names:
      if n in coords:
        del coords[n]
      elif errors == 'raise':
        raise ValueError(f'cannot drop {n!r}: not a coord')
    return DataArray._construct(self._data, self._dims, coords, self._name,
                                self._attrs)

  def drop(self, names, *, errors='raise'):
    return self.drop_vars(names, errors=errors)

  def reset_coords(self, names=None, drop=False):
    if not drop:
      raise NotImplementedError('reset_coords(drop=False)')
    if names is None:
      names = [n for n in self._coords if n not in self._dims]
    return self.drop_vars(names)

  def stack(self, dimensions=None, **kwargs):
    mapping = dict(dimensions or {})
    mapping.update(kwargs)
    out = self
    for new_dim, old_dims in mapping.items():
      old_dims = tuple(old_dims)
      order = [d for d in out._dims if d not in old_dims] + list(old_dims)
      t = out.transpose(*order)
      n = int(np.prod([t.sizes[d] for d in old_dims])) if old_dims else 1
      data = t._data.reshape(t._data.shape[:len(order) - len(old_dims)] + (n,))
      dims = tuple(order[:len(order) - len(old_dims)]) + (new_dim,)
      coords = {cn: c for cn, c in t._coords.items()
                if not (set(c[0]) & set(old_dims))}
      # Component coords over the stacked dims survive as non-dim coords
      # along the new dim (xarray keeps them in the MultiIndex).
      stack_shape = tuple(t.sizes[d] for d in old_dims)
      for cn, (cdims, cvals) in t._coords.items():
        if cdims and set(cdims) <= set(old_dims):
          shape = tuple(t.sizes[d] if d in cdims else 1 for d in old_dims)
          arr = np.transpose(cvals, [list(cdims).index(d)
                                     for d in old_dims if d in cdims])
          arr = np.broadcast_to(arr.reshape(shape), stack_shape)
          coords[cn] = ((new_dim,), arr.reshape(n))
      out = DataArray._construct(data, dims, coords, out._name, out._attrs)
    return out

  def sortby(self, key, ascending=True):
    if isinstance(key, str):
      index = self._index(key)
      if index is None:
        raise ValueError(f'no index for {key!r}')
      order = np.argsort(np.asarray(index))
      if not ascending:
        order = order[::-1]
      return self.isel({key: order})
    raise NotImplementedError('sortby with non-str key')

  def dropna(self, dim, how='any'):
    ax = self._dims.index(dim)
    vals = self._data
    if vals.dtype.kind == 'O':
      bad = pd.isnull(vals)
    elif vals.dtype.kind in 'fc':
      bad = np.isnan(vals)
    elif vals.dtype.kind in 'mM':
      bad = np.isnat(vals)
    else:
      bad = np.zeros(vals.shape, dtype=bool)
    other = tuple(i for i in range(vals.ndim) if i != ax)
    drop = bad.any(axis=other) if how == 'any' else bad.all(axis=other)
    return self.isel({dim: np.flatnonzero(~drop)})

  def shift(self, shifts=None, fill_value=np.nan, **kwargs):
    mapping = dict(shifts or {})
    mapping.update(kwargs)
    out_data = self._data.astype(np.promote_types(self._data.dtype,
                                                  np.float64)
                                 if self._data.dtype.kind in 'iu'
                                 else self._data.dtype).copy()
    for dim, k in mapping.items():
      axis = self._dims.index(dim)
      out_data = np.roll(out_data, k, axis=axis)
      sl = [slice(None)] * out_data.ndim
      if k > 0:
        sl[axis] = slice(0, k)
      elif k < 0:
        sl[axis] = slice(k, None)
      else:
        continue
      out_data[tuple(sl)] = fill_value
    return DataArray._construct(out_data, self._dims, self._coords,
                                self._name, self._attrs)

  def interp(self, coords=None, method='linear', assume_sorted=False,
             kwargs=None, **coords_kwargs):
    """Subset of xr.DataArray.interp used by the reference interpolations.

    scipy RegularGridInterpolator over the interpolated dims. Supports
    orthogonal indexers (1-D arrays / per-dim DataArrays → regridding with
    dims kept in place) and vectorized indexers (DataArrays over shared
    dims, e.g. 'index' → grid→sparse matching, indexer dims appended).
    Float non-dim coords spanning interpolated dims are interpolated
    alongside the data (grid_elevation); indexer coords (station
    elevation/name) propagate to the result. ``kwargs['fill_value']``:
    absent → NaN out of bounds; None / 'extrapolate' → extrapolate
    (scipy interpn/interp1d conventions, reference
    ``interpolations.py:89-113``).
    """
    from scipy.interpolate import RegularGridInterpolator

    indexers = dict(coords or {})
    indexers.update(coords_kwargs)
    kw = dict(kwargs or {})
    fill = kw.get('fill_value', np.nan)
    if isinstance(fill, str):
      if fill != 'extrapolate':
        raise NotImplementedError(f'fill_value={fill!r}')
      fill = None
    interp_dims = [d for d in self._dims if d in indexers]
    if not interp_dims:
      return self

    norm: dict[str, DataArray] = {}
    for d in interp_dims:
      v = indexers[d]
      if isinstance(v, DataArray):
        if v.ndim == 0:
          raise NotImplementedError('scalar interp indexers')
        norm[d] = v
      else:
        arr = _as_values(v)
        if arr.ndim != 1:
          raise NotImplementedError('non-1-D array interp indexers')
        norm[d] = DataArray._construct(arr, (d,), {d: ((d,), arr)})
    orthogonal = all(norm[d]._dims == (d,) for d in interp_dims)

    def interp_one(vals: np.ndarray, dims: tuple):
      """Interpolates one array over its subset of interp dims.

      Returns (values, out_dims) with this array's indexer dims FIRST,
      then its untouched dims (callers transpose to final order).
      """
      idims = [d for d in dims if d in interp_dims]
      if not idims:
        return np.asarray(vals), tuple(dims)
      sub = [norm[d] for d in idims]
      b = list(broadcast(*sub)) if len(sub) > 1 else [sub[0]]
      idx_dims = b[0]._dims
      idx_shape = b[0].shape
      xi = np.stack(
          [np.asarray(x._data, np.float64).ravel() for x in b], axis=-1)
      other = [d for d in dims if d not in interp_dims]
      perm = [dims.index(d) for d in idims] + [dims.index(d) for d in other]
      v = np.transpose(np.asarray(vals, np.float64), perm)
      points = []
      for ax, d in enumerate(idims):
        p = np.asarray(self._coords[d][1], np.float64)
        if p.size > 1 and p[0] > p[-1]:  # descending source grid
          p = p[::-1]
          v = np.flip(v, axis=ax)
        points.append(p)
      rgi = RegularGridInterpolator(
          points, v, method=method, bounds_error=False, fill_value=fill)
      res = rgi(xi).reshape(idx_shape + v.shape[len(idims):])
      return res, idx_dims + tuple(other)

    data, raw_dims = interp_one(self._data, self._dims)
    if orthogonal:
      # Regridding: interpolated dims keep their original positions.
      out_dims = self._dims
    else:
      # Vectorized: untouched dims in original order, indexer dims appended.
      n_other = len([d for d in self._dims if d not in interp_dims])
      idx_dims = raw_dims[:len(raw_dims) - n_other]
      out_dims = tuple(d for d in self._dims
                       if d not in interp_dims) + idx_dims
    data = np.transpose(
        data, [raw_dims.index(d) for d in out_dims])

    out_coords: dict = {}
    for cname, (cdims, cvals) in self._coords.items():
      touched = set(cdims) & set(interp_dims)
      if not touched:
        if set(cdims).issubset(out_dims):
          out_coords[cname] = (cdims, cvals)
      elif cname not in interp_dims:
        cv = np.asarray(cvals)
        if cv.dtype.kind in 'fiu':
          cres, crdims = interp_one(cv, cdims)
          corder = tuple(d for d in out_dims if d in crdims)
          out_coords[cname] = (corder, np.transpose(
              cres, [crdims.index(d) for d in corder]))
    for d in interp_dims:
      idx = norm[d]
      out_coords[d] = (idx._dims, np.asarray(idx._data))
      for cname, (cdims, cvals) in idx._coords.items():
        if cname not in out_coords and set(cdims).issubset(out_dims):
          out_coords[cname] = (cdims, cvals)
    return DataArray._construct(data, out_dims, out_coords, self._name,
                                self._attrs)

  # -- datetime accessor -------------------------------------------------------

  @property
  def dt(self):
    if self._data.dtype.kind == 'M':
      return DatetimeAccessor(self)
    if self._data.dtype.kind == 'm':
      return TimedeltaAccessor(self)
    raise TypeError(f'.dt on non-datetime dtype {self._data.dtype}')


def _reshape_for(da: DataArray, dims: Sequence[str]) -> np.ndarray:
  """View of da's data positioned/broadcastable against the given dims.

  Uses array METHODS (transpose/reshape) so jax tracers pass through.
  """
  missing = [d for d in da._dims if d not in dims]
  if missing:
    raise ValueError(f'dims {missing} of operand not in result dims {dims}')
  order = [d for d in dims if d in da._dims]
  arr = da._data
  perm = [da._dims.index(d) for d in order]
  if perm != list(range(arr.ndim)):
    arr = arr.transpose(perm) if isinstance(arr, np.ndarray) else \
        arr.transpose(*perm)
  shape = [da.sizes[d] if d in da._dims else 1 for d in dims]
  return arr.reshape(shape)


class DatetimeAccessor:

  def __init__(self, da: DataArray):
    self._da = da

  def _field(self, name):
    da = self._da
    idx = pd.DatetimeIndex(da._data.ravel())
    vals = getattr(idx, name)
    arr = np.asarray(vals).reshape(da._data.shape)
    return DataArray._construct(arr, da._dims, da._coords, name)

  @property
  def year(self):
    return self._field('year')

  @property
  def month(self):
    return self._field('month')

  @property
  def day(self):
    return self._field('day')

  @property
  def hour(self):
    return self._field('hour')

  @property
  def minute(self):
    return self._field('minute')

  @property
  def second(self):
    return self._field('second')

  @property
  def dayofyear(self):
    return self._field('dayofyear')

  @property
  def dayofweek(self):
    return self._field('dayofweek')

  @property
  def quarter(self):
    return self._field('quarter')

  @property
  def season(self):
    da = self._da
    month = np.asarray(pd.DatetimeIndex(da._data.ravel()).month)
    seasons = np.array(['DJF', 'MAM', 'JJA', 'SON'])
    arr = seasons[(month % 12) // 3].reshape(da._data.shape)
    return DataArray._construct(arr, da._dims, da._coords, 'season')

  def floor(self, freq):
    da = self._da
    idx = pd.DatetimeIndex(da._data.ravel()).floor(freq)
    return DataArray._construct(np.asarray(idx).reshape(da._data.shape),
                                da._dims, da._coords, da._name)


class TimedeltaAccessor:

  def __init__(self, da: DataArray):
    self._da = da

  def _field(self, name):
    da = self._da
    idx = pd.TimedeltaIndex(da._data.ravel())
    vals = getattr(idx, name)
    arr = np.asarray(vals).reshape(da._data.shape)
    return DataArray._construct(arr, da._dims, da._coords, name)

  @property
  def days(self):
    return self._field('days')

  @property
  def seconds(self):
    return self._field('seconds')

  def total_seconds(self):
    da = self._da
    idx = pd.TimedeltaIndex(da._data.ravel())
    arr = np.asarray(idx.total_seconds()).reshape(da._data.shape)
    return DataArray._construct(arr, da._dims, da._coords, da._name)


class Dataset(Mapping):
  """Mapping of variable name → DataArray with shared coords."""

  __slots__ = ('_vars', '_coords', '_attrs')

  def __init__(self, data_vars=None, coords=None, attrs=None):
    self._vars: dict = {}
    self._coords: dict = {}
    self._attrs = dict(attrs or {})
    if coords is not None:
      items = coords.items() if isinstance(coords, Mapping) else coords
      for cname, cval in items:
        if isinstance(cval, DataArray):
          self._coords[cname] = (cval._dims, cval._data)
        elif isinstance(cval, tuple) and len(cval) == 2 and isinstance(
            cval[0], (tuple, list, str)):
          cdims = (cval[0],) if isinstance(cval[0], str) else tuple(cval[0])
          self._coords[cname] = (cdims, _as_values(cval[1]))
        else:
          vals = _as_values(cval)
          if vals.ndim == 0:
            self._coords[cname] = ((), vals)
          elif vals.ndim == 1:
            self._coords[cname] = ((cname,), vals)
          else:
            raise NotImplementedError(f'coord {cname!r} dims unknown')
    if data_vars is not None:
      for vname, vval in dict(data_vars).items():
        self[vname] = vval

  # -- mapping interface -------------------------------------------------------

  def __iter__(self):
    return iter(self._vars)

  def __len__(self):
    return len(self._vars)

  def __bool__(self):
    return bool(self._vars)

  def __contains__(self, key):
    return key in self._vars

  def keys(self):
    return self._vars.keys()

  def values(self):
    return [self[k] for k in self._vars]

  def items(self):
    return [(k, self[k]) for k in self._vars]

  def __getitem__(self, key):
    if isinstance(key, (list, tuple)):
      out = Dataset(attrs=self._attrs)
      out._coords = dict(self._coords)
      for k in key:
        out._vars[k] = self._vars[k]
      out._prune_coords()
      return out
    if key in self._vars:
      dims, data, attrs = self._vars[key]
      coords = {cn: c for cn, c in self._coords.items()
                if set(c[0]).issubset(dims) or not c[0]}
      return DataArray._construct(data, dims, coords, key, attrs)
    if key in self._coords:
      cdims, cvals = self._coords[key]
      coords = {cn: c for cn, c in self._coords.items()
                if set(c[0]).issubset(cdims)}
      coords[key] = (cdims, cvals)
      return DataArray._construct(cvals, cdims, coords, key)
    raise KeyError(key)

  def __setitem__(self, key, value):
    if isinstance(value, DataArray):
      for d in value._dims:
        if d in self.dims and self.dims[d] != value.sizes[d]:
          raise ValueError(
              f'size conflict for dim {d!r}: {self.dims[d]} vs '
              f'{value.sizes[d]}')
      self._vars[key] = (value._dims, value._data, dict(value._attrs))
      for cname, (cdims, cvals) in value._coords.items():
        if cname not in self._coords:
          self._coords[cname] = (cdims, cvals)
        else:
          # xarray ALIGNS on conflicting labels (usually yielding all-NaN
          # data); the shim instead refuses — storing the new variable
          # positionally under the old labels would be silently wrong.
          ecdims, ecvals = self._coords[cname]
          if ecdims == cdims:
            a, b = np.asarray(ecvals), np.asarray(cvals)
            try:
              same = np.array_equal(a, b, equal_nan=True)
            except TypeError:
              same = np.array_equal(a, b)
            if not same:
              raise ValueError(
                  f'conflicting labels for coord {cname!r} in Dataset '
                  'assignment; align the inputs first (shim raises '
                  'instead of label-aligning)')
    elif isinstance(value, tuple) and len(value) in (2, 3):
      dims = (value[0],) if isinstance(value[0], str) else tuple(value[0])
      self._vars[key] = (dims, np.asarray(value[1]),
                         dict(value[2]) if len(value) == 3 else {})
    else:
      arr = _as_values(value)
      if arr.ndim == 0:
        self._vars[key] = ((), arr, {})
      else:
        raise NotImplementedError('Dataset setitem with bare nd array')

  @classmethod
  def from_dataframe(cls, df):
    """pandas DataFrame → Dataset over the frame's index dim.

    What ``DataFrame.to_xarray()`` produces for a flat (non-Multi) index:
    one dim named after the index (or 'index' when unnamed), each column a
    variable over it. Needed because the reference sparse loader builds
    its chunks via ``combined_df.to_xarray()``
    (reference ``sparse_parquet.py:345``).
    """
    if isinstance(df.index, pd.MultiIndex):
      raise NotImplementedError('from_dataframe with MultiIndex')
    dim = df.index.name or 'index'
    out = cls(coords={dim: np.asarray(df.index)})
    for col in df.columns:
      out._vars[str(col)] = ((dim,), np.asarray(df[col]), {})
    return out

  def set_coords(self, names):
    if isinstance(names, str):
      names = [names]
    out = Dataset(attrs=self._attrs)
    out._coords = dict(self._coords)
    for k, (dims, data, attrs) in self._vars.items():
      if k in names:
        out._coords[k] = (dims, data)
      else:
        out._vars[k] = (dims, data, attrs)
    return out

  def dropna(self, dim, how='any'):
    keep = None
    for k in self._vars:
      da = self[k]
      if dim not in da._dims:
        continue
      ax = da._dims.index(dim)
      vals = da._data
      if vals.dtype.kind == 'O':
        bad = pd.isnull(vals)
      elif vals.dtype.kind in 'fc':
        bad = np.isnan(vals)
      elif vals.dtype.kind in 'mM':
        bad = np.isnat(vals)
      else:
        bad = np.zeros(vals.shape, dtype=bool)
      other = tuple(i for i in range(vals.ndim) if i != ax)
      drop = bad.any(axis=other) if how == 'any' else bad.all(axis=other)
      keep = ~drop if keep is None else (keep & ~drop)
    if keep is None:
      return self
    return self.isel({dim: np.flatnonzero(keep)})

  def _prune_coords(self):
    used = set()
    for dims, _, _ in self._vars.values():
      used |= set(dims)
    self._coords = {cn: c for cn, c in self._coords.items()
                    if not c[0] or set(c[0]) & used or set(c[0]) <= used}

  def __getattr__(self, name):
    if name.startswith('_'):
      raise AttributeError(name)
    if name in self._vars or name in self._coords:
      return self[name]
    raise AttributeError(name)

  def __repr__(self):
    lines = ['<shim.Dataset>']
    for k, (dims, data, _) in self._vars.items():
      lines.append(f'  {k}{list(dims)} shape={data.shape} dtype={data.dtype}')
    lines.append('  coords: ' + ', '.join(
        f'{k}{list(v[0])}' for k, v in self._coords.items()))
    return '\n'.join(lines)

  # -- properties --------------------------------------------------------------

  @property
  def dims(self):
    out = {}
    for dims, data, _ in self._vars.values():
      for d, n in zip(dims, data.shape):
        out[d] = n
    for cdims, cvals in self._coords.values():
      for d, n in zip(cdims, cvals.shape):
        out.setdefault(d, n)
    return out

  @property
  def sizes(self):
    return self.dims

  @property
  def coords(self):
    return _Coords(self)

  def _wrap_coord(self, name):
    cdims, cvals = self._coords[name]
    coords = {cn: c for cn, c in self._coords.items()
              if set(c[0]).issubset(cdims)}
    coords[name] = (cdims, cvals)
    return DataArray._construct(cvals, cdims, coords, name)

  @property
  def data_vars(self):
    return {k: self[k] for k in self._vars}

  @property
  def attrs(self):
    return self._attrs

  def _index(self, dim):
    c = self._coords.get(dim)
    if c is not None and c[0] == (dim,):
      return pd.Index(c[1])
    return None

  # -- methods -----------------------------------------------------------------

  def copy(self, deep=True):
    out = Dataset(attrs=self._attrs)
    out._coords = dict(self._coords)
    out._vars = dict(self._vars)
    return out

  def compute(self):
    return self

  def load(self):
    return self

  def chunk(self, *args, **kwargs):
    return self

  def drop_vars(self, names, *, errors='raise'):
    if isinstance(names, str):
      names = [names]
    out = self.copy()
    for n in names:
      if n in out._vars:
        del out._vars[n]
      elif n in out._coords:
        del out._coords[n]
      elif errors == 'raise':
        raise ValueError(f'cannot drop {n!r}')
    return out

  def rename(self, name_dict=None, **names):
    mapping = dict(name_dict or {})
    mapping.update(names)
    out = Dataset(attrs=self._attrs)
    for cname, (cdims, cvals) in self._coords.items():
      out._coords[mapping.get(cname, cname)] = (
          tuple(mapping.get(d, d) for d in cdims), cvals)
    for vname, (dims, data, attrs) in self._vars.items():
      out._vars[mapping.get(vname, vname)] = (
          tuple(mapping.get(d, d) for d in dims), data, attrs)
    return out

  def expand_dims(self, dim=None, axis=None, **dim_kwargs):
    if isinstance(dim, str):
      dims_map = {dim: 1}
    elif isinstance(dim, Mapping):
      dims_map = dict(dim)
    elif isinstance(dim, (list, tuple)):
      dims_map = {d: 1 for d in dim}
    elif dim is None:
      dims_map = {}
    else:
      raise NotImplementedError
    dims_map.update(dim_kwargs)
    out = Dataset(attrs=self._attrs)
    out._coords = dict(self._coords)
    for name, val in dims_map.items():
      if not isinstance(val, int):
        out._coords[name] = ((name,), _as_values(val))
    for vname in self._vars:
      da = self[vname]
      out._vars[vname] = tuple(
          (lambda e: (e._dims, e._data, e._attrs))(da.expand_dims(dims_map)))
    return out

  def sel(self, indexers=None, method=None, tolerance=None, drop=False,
          **kwargs):
    indexers = dict(indexers or {})
    indexers.update(kwargs)
    out = Dataset(attrs=self._attrs)
    # Positional translation happens per-variable via DataArray.sel on a
    # variable that carries the relevant index; simplest correct approach:
    # apply to each var and rebuild shared coords from the results.
    for vname in self._vars:
      da = self[vname]
      applicable = {d: k for d, k in indexers.items() if d in da._dims}
      res = da.sel(applicable, method=method, tolerance=tolerance,
                   drop=drop) if applicable else da
      out._vars[vname] = (res._dims, res._data, res._attrs)
      for cname, c in res._coords.items():
        out._coords.setdefault(cname, c)
    for cname, (cdims, cvals) in self._coords.items():
      if cname not in out._coords and not (set(cdims) & set(indexers)):
        out._coords[cname] = (cdims, cvals)
    return out

  def isel(self, indexers=None, drop=False, **kwargs):
    indexers = dict(indexers or {})
    indexers.update(kwargs)
    out = Dataset(attrs=self._attrs)
    for vname in self._vars:
      da = self[vname]
      applicable = {d: k for d, k in indexers.items() if d in da._dims}
      res = da.isel(applicable, drop=drop) if applicable else da
      out._vars[vname] = (res._dims, res._data, res._attrs)
      for cname, c in res._coords.items():
        out._coords.setdefault(cname, c)
    for cname, (cdims, cvals) in self._coords.items():
      if cname not in out._coords and not (set(cdims) & set(indexers)):
        out._coords[cname] = (cdims, cvals)
    return out

  def transpose(self, *dims):
    out = Dataset(attrs=self._attrs)
    out._coords = dict(self._coords)
    for vname in self._vars:
      da = self[vname]
      order = [d for d in dims if d in da._dims] or list(da._dims)
      rest = [d for d in da._dims if d not in order]
      res = da.transpose(*(order + rest)) if dims else da
      out._vars[vname] = (res._dims, res._data, res._attrs)
    return out

  def astype(self, dtype):
    out = Dataset(attrs=self._attrs)
    out._coords = dict(self._coords)
    for vname, (dims, data, attrs) in self._vars.items():
      out._vars[vname] = (dims, data.astype(dtype), attrs)
    return out

  def where(self, cond, other=np.nan):
    out = Dataset(attrs=self._attrs)
    out._coords = dict(self._coords)
    for vname in self._vars:
      res = self[vname].where(cond, other)
      out._vars[vname] = (res._dims, res._data, res._attrs)
    return out

  def _binary_ds(self, other, op, reflexive=False):
    out = Dataset(attrs=self._attrs)
    out._coords = dict(self._coords)
    for vname in self._vars:
      rhs = other[vname] if isinstance(other, Dataset) else other
      a, b = (rhs, self[vname]) if reflexive else (self[vname], rhs)
      res = op(a, b)
      out._vars[vname] = (res._dims, res._data, res._attrs)
      for cname, c in res._coords.items():
        out._coords.setdefault(cname, c)
    return out

  def __add__(self, o): return self._binary_ds(o, operator.add)
  def __radd__(self, o): return self._binary_ds(o, operator.add, True)
  def __sub__(self, o): return self._binary_ds(o, operator.sub)
  def __rsub__(self, o): return self._binary_ds(o, operator.sub, True)
  def __mul__(self, o): return self._binary_ds(o, operator.mul)
  def __rmul__(self, o): return self._binary_ds(o, operator.mul, True)
  def __truediv__(self, o): return self._binary_ds(o, operator.truediv)
  def __rtruediv__(self, o): return self._binary_ds(o, operator.truediv, True)
  def __pow__(self, o): return self._binary_ds(o, operator.pow)
  def __mod__(self, o): return self._binary_ds(o, operator.mod)
  def __floordiv__(self, o): return self._binary_ds(o, operator.floordiv)
  def __and__(self, o): return self._binary_ds(o, operator.and_)
  def __or__(self, o): return self._binary_ds(o, operator.or_)
  def __eq__(self, o):
    if isinstance(o, (Dataset, DataArray, np.ndarray, int, float, bool,
                      np.generic)):
      return self._binary_ds(o, operator.eq)
    return NotImplemented
  def __ne__(self, o):
    if isinstance(o, (Dataset, DataArray, np.ndarray, int, float, bool,
                      np.generic)):
      return self._binary_ds(o, operator.ne)
    return NotImplemented
  def __lt__(self, o): return self._binary_ds(o, operator.lt)
  def __le__(self, o): return self._binary_ds(o, operator.le)
  def __gt__(self, o): return self._binary_ds(o, operator.gt)
  def __ge__(self, o): return self._binary_ds(o, operator.ge)
  __hash__ = None

  def __neg__(self):
    out = Dataset(attrs=self._attrs)
    out._coords = dict(self._coords)
    for vname in self._vars:
      res = -self[vname]
      out._vars[vname] = (res._dims, res._data, res._attrs)
    return out

  def __abs__(self):
    out = Dataset(attrs=self._attrs)
    out._coords = dict(self._coords)
    for vname in self._vars:
      res = abs(self[vname])
      out._vars[vname] = (res._dims, res._data, res._attrs)
    return out

  def quantile(self, q, dim=None, **kwargs):
    out = Dataset(attrs=self._attrs)
    for vname in self._vars:
      res = self[vname].quantile(q, dim=dim, **kwargs)
      out._vars[vname] = (res._dims, res._data, res._attrs)
      for cname, c in res._coords.items():
        out._coords.setdefault(cname, c)
    return out

  def _reduce_vars(self, op_name, dim=None, **kwargs):
    out = Dataset(attrs=self._attrs)
    for vname in self._vars:
      da = self[vname]
      dims = [d for d in (([dim] if isinstance(dim, str) else dim) or
                          da._dims) if d in da._dims]
      res = getattr(da, op_name)(dims, **kwargs) if dims else da
      out._vars[vname] = (res._dims, res._data, res._attrs)
      for cname, c in res._coords.items():
        out._coords.setdefault(cname, c)
    return out

  def mean(self, dim=None, **kwargs):
    return self._reduce_vars('mean', dim, **kwargs)

  def sum(self, dim=None, **kwargs):
    return self._reduce_vars('sum', dim, **kwargs)

  def max(self, dim=None, **kwargs):
    return self._reduce_vars('max', dim, **kwargs)

  def min(self, dim=None, **kwargs):
    return self._reduce_vars('min', dim, **kwargs)

  def std(self, dim=None, **kwargs):
    return self._reduce_vars('std', dim, **kwargs)

  def var(self, dim=None, **kwargs):
    return self._reduce_vars('var', dim, **kwargs)

  def count(self, dim=None, **kwargs):
    return self._reduce_vars('count', dim, **kwargs)

  def any(self, dim=None, **kwargs):
    return self._reduce_vars('any', dim, **kwargs)

  def all(self, dim=None, **kwargs):
    return self._reduce_vars('all', dim, **kwargs)

  def assign_coords(self, coords=None, **kwargs):
    out = self.copy()
    mapping = dict(coords or {})
    mapping.update(kwargs)
    for k, v in mapping.items():
      _Coords(out)[k] = v
    return out

  def assign(self, variables=None, **kwargs):
    out = self.copy()
    mapping = dict(variables or {})
    mapping.update(kwargs)
    for k, v in mapping.items():
      out[k] = v
    return out

  def merge(self, other):
    out = self.copy()
    for k, v in other.items():
      out[k] = v
    return out

  def equals(self, other):
    if set(self._vars) != set(other._vars):
      return False
    for k in self._vars:
      a, b = self[k], other[k]
      if a._dims != b._dims or not _values_equal(a._data, b._data):
        return False
    return True


class DataTree:
  """Very small tree-of-Datasets, sufficient for AggregationState round-trips."""

  def __init__(self, dataset=None, children=None, name=None):
    self.name = name
    self._dataset = dataset if dataset is not None else Dataset()
    self.children = dict(children or {})
    for k, child in self.children.items():
      child.name = k

  @property
  def dataset(self):
    return self._dataset

  def to_dict(self):
    out = {}

    def walk(node, path):
      if node._dataset or not node.children:
        out[path or '/'] = node._dataset
      for k, child in node.children.items():
        walk(child, f'{path}/{k}')

    walk(self, '')
    return out

  @classmethod
  def from_dict(cls, d):
    root = cls()
    for path, ds in d.items():
      parts = [p for p in str(path).split('/') if p]
      node = root
      for p in parts:
        if p not in node.children:
          node.children[p] = cls(name=p)
        node = node.children[p]
      node._dataset = ds if isinstance(ds, Dataset) else ds
    return root


# -- module-level functions ----------------------------------------------------


def align(*objects, join='inner', fill_value=np.nan, copy=True, exclude=()):
  if not objects:
    return ()
  das = list(objects)
  if any(not isinstance(o, DataArray) for o in das):
    raise NotImplementedError('align of non-DataArray')
  all_dims = []
  for o in das:
    for d in o._dims:
      if d not in all_dims and d not in exclude:
        all_dims.append(d)
  targets = {}
  for d in all_dims:
    idxs = [o._index(d) for o in das if d in o._dims]
    idxs = [i for i in idxs if i is not None]
    if not idxs:
      continue
    if all(len(i) == len(idxs[0]) and
           _values_equal(np.asarray(i), np.asarray(idxs[0])) for i in idxs):
      continue
    if join == 'outer':
      tgt = idxs[0]
      for i in idxs[1:]:
        tgt = tgt.union(i)
    elif join == 'inner':
      tgt = idxs[0]
      for i in idxs[1:]:
        tgt = tgt.intersection(i)
    elif join == 'exact':
      raise ValueError(f'indexes along dimension {d!r} are not equal')
    else:
      raise NotImplementedError(f'join={join!r}')
    targets[d] = tgt
  out = []
  for o in das:
    for d, tgt in targets.items():
      if d not in o._dims:
        continue
      o = _reindex(o, d, tgt, fill_value)
    out.append(o)
  return tuple(out)


def _missing_value(dtype):
  if dtype.kind == 'M':
    return np.datetime64('NaT')
  if dtype.kind == 'm':
    return np.timedelta64('NaT')
  return np.nan


def _promote_for_missing(arr):
  """Returns a copy of arr able to hold a missing marker (pd.isna-visible)."""
  arr = np.asarray(arr)
  if arr.dtype.kind in 'iub':
    return arr.astype(np.float64)
  if arr.dtype.kind in 'US':
    return arr.astype(object)
  return np.array(arr)


def _mark_missing_coords(coords, dim, missing_mask):
  """Marks positions of ``missing_mask`` along ``dim`` as missing in every
  non-index coord that includes that dim (real-xarray reindex semantics:
  labels absent from the source get NaN/NaT non-dim coord values, NOT a
  copy of some arbitrary source row)."""
  out = dict(coords)
  for cname, (cdims, cvals) in coords.items():
    if cname == dim or dim not in cdims:
      continue
    promoted = _promote_for_missing(cvals)
    sl = [slice(None)] * promoted.ndim
    sl[cdims.index(dim)] = missing_mask
    promoted[tuple(sl)] = _missing_value(promoted.dtype)
    out[cname] = (cdims, promoted)
  return out


def _promote_for_fill(data, fill_value):
  if data.dtype.kind in 'iub' and isinstance(fill_value, float) and \
      np.isnan(fill_value):
    return data.astype(np.float64)
  elif data.dtype.kind in 'iub' and fill_value == 0:
    return data.copy()
  return data.astype(np.promote_types(data.dtype, np.result_type(
      type(fill_value))))


def _reindex(da: DataArray, dim: str, target: pd.Index, fill_value):
  index = da._index(dim)
  pos = index.get_indexer(target)
  found = pos >= 0
  if len(index) == 0:
    # Nothing to take from (np.take on a zero-length axis raises even for
    # a fallback index): build the all-missing result directly.
    ax = da._dims.index(dim)
    shape = list(da.shape)
    shape[ax] = len(target)
    data = np.full(shape, fill_value,
                   dtype=_promote_for_fill(da._data, fill_value).dtype)
    coords = {}
    for cn, (cd, cv) in da._coords.items():
      if cn == dim:
        continue
      if dim in cd:
        # Source had no rows: the whole coord is missing at every target.
        promoted = _promote_for_missing(cv)
        cshape = tuple(len(target) if d == dim else n
                       for d, n in zip(cd, promoted.shape))
        coords[cn] = (cd, np.full(cshape, _missing_value(promoted.dtype),
                                  dtype=promoted.dtype))
      else:
        coords[cn] = (cd, cv)
    coords[dim] = ((dim,), np.asarray(target))
    return DataArray._construct(data, da._dims, coords, da._name, da._attrs)
  taken = da.isel({dim: np.where(found, pos, 0)})
  if not found.all():
    data = _promote_for_fill(taken._data, fill_value)
    ax = taken._dims.index(dim)
    sl = [slice(None)] * data.ndim
    sl[ax] = ~found
    data = np.array(data)
    data[tuple(sl)] = fill_value
    coords = _mark_missing_coords(taken._coords, dim, ~found)
    taken = DataArray._construct(data, taken._dims, coords,
                                 taken._name, taken._attrs)
  coords = dict(taken._coords)
  coords[dim] = ((dim,), np.asarray(target))
  return DataArray._construct(taken._data, taken._dims, coords, taken._name,
                              taken._attrs)


def broadcast(*args, exclude=None):
  exclude = set(exclude or ())
  das = list(args)
  dims = []
  for o in das:
    for d in o._dims:
      if d not in dims and d not in exclude:
        dims.append(d)
  sizes = {}
  for o in das:
    for d in o._dims:
      if d in dims:
        sizes[d] = o.sizes[d]
  out = []
  for o in das:
    tail = [d for d in o._dims if d in exclude]
    tgt = [d for d in dims if d not in tail] + tail
    full_shape = tuple(sizes[d] if d in sizes else o.sizes[d] for d in tgt)
    rsh = _reshape_for(o, tgt)
    if _is_jaxish(rsh):
      # jax tracers (the REV optimal-threshold finalizer runs under
      # jax.linearize through this shim) cannot go through numpy.
      import jax.numpy as jnp
      arr = jnp.broadcast_to(rsh, full_shape)
    else:
      arr = np.broadcast_to(rsh, full_shape).copy()
    coords = _merge_coords(*(p._coords for p in das), result_dims=set(tgt))
    coords.update({k: v for k, v in o._coords.items()
                   if set(v[0]).issubset(tgt)})
    out.append(DataArray._construct(arr, tuple(tgt), coords, o._name,
                                    o._attrs))
  return tuple(out)


def concat(objs, dim, coords='different', join='outer', **kwargs):
  objs = list(objs)
  if not objs:
    raise ValueError('empty concat')
  if isinstance(objs[0], Dataset):
    keys = list(objs[0].keys())
    out = Dataset()
    for k in keys:
      out[k] = concat([o[k] for o in objs], dim, coords=coords, join=join)
    return out
  if isinstance(dim, str):
    dim_name = dim
  elif isinstance(dim, DataArray):
    dim_name = dim.name if dim.name is not None else dim._dims[0]
  elif isinstance(dim, pd.Index):
    dim_name = dim.name
  else:
    dim_name = None
  if dim_name is None:
    raise NotImplementedError('concat dim must be named')
  prepped = []
  for o in objs:
    if dim_name not in o._dims:
      o = o.expand_dims(dim_name)
    prepped.append(o)
  ref = prepped[0]
  order = ref._dims
  arrs = []
  for o in prepped:
    if set(o._dims) != set(order):
      raise NotImplementedError('concat with differing dims')
    arrs.append(np.transpose(o._data, [o._dims.index(d) for d in order]))
  ax = order.index(dim_name)
  data = np.concatenate(arrs, axis=ax)
  coords = {}
  for cname, (cdims, cvals) in ref._coords.items():
    if dim_name in cdims:
      cat_ax = cdims.index(dim_name)
      pieces = []
      ok = True
      for o in prepped:
        if cname in o._coords and o._coords[cname][0] == cdims:
          pieces.append(o._coords[cname][1])
        else:
          ok = False
          break
      if ok:
        coords[cname] = (cdims, np.concatenate(pieces, axis=cat_ax))
    else:
      coords[cname] = (cdims, cvals)
  if not isinstance(dim, str) and isinstance(dim, (pd.Index, DataArray)):
    coords[dim_name] = ((dim_name,), _as_values(dim))
  return DataArray._construct(data, order, coords, ref._name, ref._attrs)


def merge(objects, compat='no_conflicts', join='outer', fill_value=np.nan):
  ds = Dataset()
  for obj in objects:
    if isinstance(obj, DataArray):
      if obj.name is None:
        raise ValueError('cannot merge unnamed DataArray')
      if join == 'exact':
        for d in obj._dims:
          if d in ds.dims and ds.dims[d] != obj.sizes[d]:
            raise ValueError('exact join not possible: size mismatch')
          tgt = ds._index(d)
          src = obj._index(d)
          if tgt is not None and src is not None and not _values_equal(
              np.asarray(tgt), np.asarray(src)):
            raise ValueError('exact join not possible: index mismatch')
      ds[obj.name] = obj
    elif isinstance(obj, Dataset):
      for k, v in obj.items():
        ds[k] = v
    elif isinstance(obj, Mapping):
      for k, v in obj.items():
        ds[k] = v
    else:
      raise NotImplementedError(f'merge of {type(obj)}')
  return ds


def where(cond, x, y, keep_attrs=None):
  if isinstance(x, Dataset) or isinstance(y, Dataset):
    ds = x if isinstance(x, Dataset) else y
    out = Dataset(attrs=ds._attrs)
    out._coords = dict(ds._coords)
    for vname in ds._vars:
      xv = x[vname] if isinstance(x, Dataset) else x
      yv = y[vname] if isinstance(y, Dataset) else y
      cv = cond[vname] if isinstance(cond, Dataset) else cond
      res = where(cv, xv, yv, keep_attrs=keep_attrs)
      out._vars[vname] = (res._dims, res._data, res._attrs)
    return out
  if not isinstance(cond, DataArray):
    cond = DataArray(np.asarray(cond))
  if isinstance(x, DataArray):
    return x.where(cond, y)
  return _where_scalar(cond, x, y)


def _where_scalar(cond, x, y):
  if isinstance(y, DataArray):
    c, yda = cond._align_with(y)
    dims = tuple(c._dims) + tuple(d for d in yda._dims if d not in c._dims)
    cv = _reshape_for(c, dims)
    yv = _reshape_for(yda, dims)
    coords = _merge_coords(c._coords, yda._coords, result_dims=set(dims))
    return DataArray._construct(np.where(cv, x, yv), dims, coords)
  return DataArray._construct(np.where(cond._data, x, y), cond._dims,
                              cond._coords)


def dot(*arrays, dim=None, dims=None, **kwargs):
  das = list(arrays)
  das = [d if isinstance(d, DataArray) else DataArray(np.asarray(d))
         for d in das]
  if dim is None:
    dim = dims
  if dim is None:
    raise NotImplementedError('dot without dim')
  if len(das) > 1:
    das = list(align(*das, join='inner'))
  # np.einsum over the union of named dims — like real xr.dot, this never
  # materializes the full broadcast product (the naive multiply-then-sum
  # chain needs O(prod(all dims)) memory, e.g. 149 GiB in the upstream
  # cluster-bootstrap test's (unit × replicate × replicate) contraction).
  order = []
  for d in das:
    for dd in d._dims:
      if dd not in order:
        order.append(dd)
  reduce_dims = [dim] if isinstance(dim, str) else list(dim)
  reduce_dims = [d for d in reduce_dims if d in order]
  out_dims = tuple(d for d in order if d not in reduce_dims)
  letters = {d: chr(ord('a') + i) for i, d in enumerate(order)}
  spec = (','.join(''.join(letters[dd] for dd in d._dims) for d in das)
          + '->' + ''.join(letters[d] for d in out_dims))
  operands = [d._data for d in das]
  if all(o.dtype == bool for o in operands):
    # multiply-chain + np.sum promoted all-bool input to int64; keep that.
    operands = [o.astype(np.int64) for o in operands]
  data = np.einsum(spec, *operands)
  coords = {}
  out_set = set(out_dims)
  for d in das:
    for cname, c in d._coords.items():
      if set(c[0]).issubset(out_set):
        coords.setdefault(cname, c)
  attrs = dict(das[0]._attrs) if _OPTIONS['keep_attrs'] else {}
  return DataArray._construct(data, out_dims, coords, das[0]._name, attrs)


def zeros_like(obj, dtype=None):
  return full_like(obj, 0, dtype=dtype)


def ones_like(obj, dtype=None):
  return full_like(obj, 1, dtype=dtype)


def full_like(obj, fill_value, dtype=None):
  if isinstance(obj, Dataset):
    out = Dataset(attrs=obj._attrs)
    out._coords = dict(obj._coords)
    for k, (dims, data, attrs) in obj._vars.items():
      out._vars[k] = (dims, np.full(data.shape, fill_value,
                                    dtype=dtype or data.dtype), attrs)
    return out
  data = np.full(obj.shape, fill_value, dtype=dtype or obj.dtype)
  return DataArray._construct(data, obj._dims, obj._coords, obj._name,
                              obj._attrs)


def apply_ufunc(func, *args, input_core_dims=None, output_core_dims=((),),
                exclude_dims=frozenset(), vectorize=False, dask=None,
                output_dtypes=None, kwargs=None, keep_attrs=None,
                dask_gufunc_kwargs=None, on_missing_core_dim='raise'):
  kwargs = kwargs or {}
  das = [a if isinstance(a, DataArray) else DataArray(np.asarray(a))
         for a in args]
  if input_core_dims is None:
    input_core_dims = [()] * len(das)
  if len(input_core_dims) != len(das):
    raise ValueError('input_core_dims length mismatch')
  # Broadcast dims = all non-core dims in order of appearance.
  broadcast_dims = []
  for da, core in zip(das, input_core_dims):
    for d in da._dims:
      if d not in core and d not in broadcast_dims and d not in exclude_dims:
        broadcast_dims.append(d)
  sizes = {}
  for da, core in zip(das, input_core_dims):
    for d in da._dims:
      if d in broadcast_dims:
        if d in sizes and sizes[d] != da.sizes[d]:
          raise ValueError(f'broadcast size mismatch on {d!r}')
        sizes[d] = da.sizes[d]
  bshape = tuple(sizes[d] for d in broadcast_dims)
  moved = []
  for da, core in zip(das, input_core_dims):
    order = [d for d in broadcast_dims if d in da._dims] + list(core)
    arr = da._data
    perm = [da._dims.index(d) for d in order]
    if perm != list(range(arr.ndim)):
      # Array METHODS so jax tracers pass through (np.transpose would
      # force a concrete-array conversion).
      arr = arr.transpose(perm) if isinstance(arr, np.ndarray) else \
          arr.transpose(*perm)
    # Expand to full broadcast shape.
    full = tuple(sizes[d] if d in da._dims else 1 for d in broadcast_dims
                 ) + arr.shape[len(order) - len(core):]
    arr = arr.reshape(full)
    if _is_jaxish(arr):
      import jax.numpy as jnp
      arr = jnp.broadcast_to(arr, bshape + arr.shape[len(broadcast_dims):])
    else:
      arr = np.broadcast_to(arr, bshape + arr.shape[len(broadcast_dims):])
    moved.append(arr)
  out_core = [tuple(c) for c in output_core_dims]
  if len(out_core) != 1:
    raise NotImplementedError('multiple outputs')
  if vectorize:
    flat_shape = (int(np.prod(bshape)),) if bshape else (1,)
    flats = [m.reshape(flat_shape + m.shape[len(bshape):]) for m in moved]
    results = []
    for i in range(flat_shape[0]):
      r = func(*(f[i] for f in flats), **kwargs)
      results.append(r if _is_jaxish(r) else np.asarray(r))
    res0 = results[0]
    if any(_is_jaxish(r) for r in results):
      import jax.numpy as jnp
      res = jnp.stack(results).reshape(bshape + res0.shape)
    else:
      res = np.stack(results).reshape(bshape + res0.shape)
  else:
    res = func(*moved, **kwargs)
    if not _is_jaxish(res):
      res = np.asarray(res)
  out_dims = tuple(broadcast_dims) + out_core[0]
  if res.ndim != len(out_dims):
    raise ValueError(
        f'apply_ufunc result ndim {res.ndim} != expected dims {out_dims}')
  coords = {}
  for da in das:
    for cname, (cdims, cvals) in da._coords.items():
      if set(cdims).issubset(out_dims) and cname not in coords:
        if cname in exclude_dims:
          continue
        coords[cname] = (cdims, cvals)
  # Core-dim index coords survive only if the size matches.
  coords = {cn: c for cn, c in coords.items()
            if all((d not in out_dims) or
                   (res.shape[out_dims.index(d)] == n)
                   for d, n in zip(c[0], c[1].shape))}
  return DataArray._construct(res, out_dims, coords, das[0]._name,
                              das[0]._attrs)


def combine_by_coords(objects, fill_value=np.nan, join='outer', **kwargs):
  objs = list(objects)
  if all(isinstance(o, DataArray) for o in objs):
    aligned = align(*objs, join='outer', fill_value=fill_value)
    out = aligned[0]
    filled = np.array(out._data)
    for o in aligned[1:]:
      # Compute the not-missing mask from the ALREADY-RESHAPED values so
      # mask and data share the output's dim order (a mask built in o's
      # own dim order and merely reshaped would misalign under transposed
      # inputs, silently corrupting the combine).
      ov = np.broadcast_to(_reshape_for(o, out._dims), filled.shape)
      if o.dtype.kind in 'fc':
        mask = ~np.isnan(ov)
      elif o.dtype.kind in 'mM':
        mask = ~np.isnat(ov)
      else:
        mask = np.ones(filled.shape, bool)
      filled = np.where(mask, ov, filled)
    # Merge non-index coords as well: positions the first array lacked carry
    # a missing marker from _reindex; take their values from whichever later
    # array actually had those labels (real combine_by_coords semantics —
    # reference beam_pipeline.py:295 relies on this for coords carried on
    # concatenated lead_time chunks).
    out_coords = dict(out._coords)
    for cname, (cdims, cvals) in out._coords.items():
      if cname in out._dims or not cdims:
        continue
      merged = np.array(_promote_for_missing(cvals))
      for o in aligned[1:]:
        other = o._coords.get(cname)
        if other is None or tuple(other[0]) != tuple(cdims):
          continue
        other_vals = np.asarray(other[1])
        take = pd.isna(merged) & ~pd.isna(other_vals)
        if take.any():
          merged[take] = other_vals[take]
      out_coords[cname] = (cdims, merged)
    return DataArray._construct(filled, out._dims, out_coords, out._name)
  raise NotImplementedError('combine_by_coords of Datasets')


# -- minimal zarr v2 storage (uncompressed, dependency-free) -------------------
#
# Just enough for the upstream loader tests' write-then-load_chunk round trips
# (data_loaders/xarray_loaders_test.py:36, latency_wrappers_test.py:36):
# standard zarr v2 layout (.zgroup/.zarray/.zattrs JSON + raw C-order chunks,
# compressor=None, one chunk per array), CF int64 encoding for datetimes.


def _zarr_encode(arr):
  """Returns (bytes_dtype_str, encoded_array, cf_attrs)."""
  arr = np.ascontiguousarray(arr)
  if arr.dtype.kind == 'M':
    enc = arr.astype('datetime64[ns]').view('<i8')
    return '<i8', enc, {'units': 'nanoseconds since 1970-01-01',
                        'calendar': 'proleptic_gregorian'}
  if arr.dtype.kind == 'm':
    enc = arr.astype('timedelta64[ns]').view('<i8')
    return '<i8', enc, {'units': 'nanoseconds'}
  if arr.dtype == object:
    as_str = arr.astype(str)
    return as_str.dtype.str, as_str, {}
  if arr.dtype.kind == 'b':
    return '|b1', arr, {}
  return arr.dtype.str, arr, {}


def _zarr_decode(arr, attrs):
  units = attrs.get('units')
  if isinstance(units, str) and arr.dtype.kind == 'i':
    if units.startswith('nanoseconds since 1970-01-01'):
      return arr.view('datetime64[ns]'), True
    if units == 'nanoseconds':
      return arr.view('timedelta64[ns]'), True
  return arr, False


def _ds_to_zarr(self, store, mode='w', chunks=None, **kwargs):
  """Writes a zarr v2 group. ``chunks`` maps dim name -> chunk size
  (absent dims / non-positive sizes mean unchunked), so the xarray_beam
  shim's ChunksToZarr can lay the store out per the caller's zarr_chunks
  (reference beam_pipeline.py:679-681)."""
  import json
  import os
  chunks = dict(chunks or {})
  path = os.fspath(store)
  os.makedirs(path, exist_ok=True)
  with open(os.path.join(path, '.zgroup'), 'w') as f:
    json.dump({'zarr_format': 2}, f)
  ds_attrs = dict(self._attrs)
  # Record non-index coords (dims != (name,)) so open_zarr can restore them
  # as coords rather than data variables — the group-level analog of
  # xarray's per-variable 'coordinates' convention.
  non_dim_coords = [str(cn) for cn, (cd, _cv) in self._coords.items()
                    if tuple(cd) != (cn,)]
  if non_dim_coords:
    ds_attrs['coordinates'] = ' '.join(non_dim_coords)
  with open(os.path.join(path, '.zattrs'), 'w') as f:
    json.dump(ds_attrs, f, default=str)
  arrays = {}
  for cname, (cdims, cvals) in self._coords.items():
    arrays[cname] = (cdims, np.asarray(cvals), {})
  for vname, (dims, data, attrs) in self._vars.items():
    arrays[vname] = (dims, np.asarray(data), dict(attrs))
  for name, (dims, data, attrs) in arrays.items():
    adir = os.path.join(path, str(name))
    os.makedirs(adir, exist_ok=True)
    dstr, enc, cf = _zarr_encode(data)
    chunk_shape = [
        (chunks[d] if chunks.get(d, 0) and chunks[d] > 0 else n)
        for d, n in zip(dims, enc.shape)]
    meta = {
        'zarr_format': 2,
        'shape': list(enc.shape),
        'chunks': chunk_shape if enc.ndim else [],
        'dtype': dstr,
        'compressor': None,
        'fill_value': None,
        'order': 'C',
        'filters': None,
    }
    with open(os.path.join(adir, '.zarray'), 'w') as f:
      json.dump(meta, f)
    out_attrs = {'_ARRAY_DIMENSIONS': [str(d) for d in dims]}
    out_attrs.update(cf)
    out_attrs.update({k: v for k, v in attrs.items()
                      if isinstance(v, (str, int, float, bool, list))})
    with open(os.path.join(adir, '.zattrs'), 'w') as f:
      json.dump(out_attrs, f)
    grid = tuple(-(-s // c) for s, c in zip(enc.shape, chunk_shape)) \
        if enc.ndim else ()
    for idx in (np.ndindex(*grid) if grid else [()]):
      sl = tuple(slice(i * c, min((i + 1) * c, s))
                 for i, c, s in zip(idx, chunk_shape, enc.shape))
      block = enc[sl]
      # zarr v2 stores edge chunks padded to the full chunk shape.
      if block.shape != tuple(chunk_shape) and enc.ndim:
        padded = np.zeros(chunk_shape, dtype=enc.dtype)
        padded[tuple(slice(0, b) for b in block.shape)] = block
        block = padded
      key = '.'.join(str(i) for i in idx) or '0'
      with open(os.path.join(adir, key), 'wb') as f:
        f.write(np.ascontiguousarray(block).tobytes(order='C'))


Dataset.to_zarr = _ds_to_zarr


def open_zarr(store, **kwargs):
  import json
  import os
  path = os.fspath(store)
  if not os.path.exists(os.path.join(path, '.zgroup')):
    raise FileNotFoundError(f'not a zarr group: {path!r}')
  try:
    with open(os.path.join(path, '.zattrs')) as f:
      ds_attrs = json.load(f)
  except FileNotFoundError:
    ds_attrs = {}
  arrays = {}
  for name in sorted(os.listdir(path)):
    adir = os.path.join(path, name)
    zarray = os.path.join(adir, '.zarray')
    if not os.path.isfile(zarray):
      continue
    with open(zarray) as f:
      meta = json.load(f)
    if meta.get('compressor') is not None or meta.get('filters'):
      raise NotImplementedError('shim open_zarr reads uncompressed only')
    try:
      with open(os.path.join(adir, '.zattrs')) as f:
        attrs = json.load(f)
    except FileNotFoundError:
      attrs = {}
    dtype = np.dtype(meta['dtype'])
    shape = tuple(meta['shape'])
    chunks = tuple(meta['chunks'])
    arr = np.empty(shape, dtype)
    grid = tuple(-(-s // c) for s, c in zip(shape, chunks)) if shape else ()
    for idx in (np.ndindex(*grid) if grid else [()]):
      key = '.'.join(str(i) for i in idx) or '0'
      with open(os.path.join(adir, key), 'rb') as f:
        raw = np.frombuffer(f.read(), dtype=dtype)
      sl = tuple(slice(i * c, min((i + 1) * c, s))
                 for i, c, s in zip(idx, chunks, shape))
      block_shape = tuple(s.stop - s.start for s in sl)
      n = int(np.prod(block_shape)) if block_shape else 1
      full_chunk = tuple(chunks)
      if n == raw.size:
        arr[sl] = raw.reshape(block_shape)
      else:  # ragged edge chunk stored at full chunk shape
        block = raw.reshape(full_chunk)
        arr[sl] = block[tuple(slice(0, b) for b in block_shape)]
    arr, _ = _zarr_decode(arr, attrs)
    dims = tuple(attrs.get('_ARRAY_DIMENSIONS', (name,) if arr.ndim else ()))
    user_attrs = {k: v for k, v in attrs.items()
                  if k not in ('_ARRAY_DIMENSIONS', 'units', 'calendar')}
    arrays[name] = (dims, arr, user_attrs)
  all_dims = {d for dims, _, _ in arrays.values() for d in dims}
  coord_names = set(str(ds_attrs.pop('coordinates', '')).split())
  for _name, (_dims, _arr, attrs) in arrays.items():
    coord_names.update(str(attrs.pop('coordinates', '')).split())
  ds = Dataset(attrs=ds_attrs)
  for name, (dims, arr, attrs) in arrays.items():
    if (name in all_dims and dims == (name,)) or name in coord_names:
      ds._coords[name] = (dims, arr)
    else:
      ds._vars[name] = (dims, arr, attrs)
  return ds


def _dimarray_conversions():
  """Converters between refshim objects and weatherbenchx_tpu DimArrays.

  The netCDF path reuses the repo's self-contained netCDF3 writer/reader
  (weatherbenchx_tpu/netcdf_io.py) rather than growing a second CF
  implementation inside the shim; the same writer/reader pair is already
  cross-validated against reference-written state files in
  tests/test_reference_parity.py."""
  from weatherbenchx_tpu import netcdf_io
  from weatherbenchx_tpu.darray import Coord, DimArray

  def as_nc(values):
    values = np.asarray(values)
    if values.dtype == object:
      # pandas-style object string columns (e.g. stationName) -> fixed '<U'
      # so the netCDF3 writer can store them as char matrices.
      return values.astype(str)
    return values

  def ds_to_dimarrays(ds):
    out = {}
    for name in ds.keys():
      da = ds[name]
      coords = {}
      for cname in da.coords.keys():
        cda = da.coords[cname]
        coords[str(cname)] = Coord(tuple(cda.dims), as_nc(cda.values))
      out[str(name)] = DimArray(as_nc(da.values), tuple(da.dims), coords)
    return out

  def dimarrays_to_ds(mapping):
    ds = Dataset()
    for name, dim_array in mapping.items():
      coords = {cn: (tuple(c.dims), np.asarray(c.values))
                for cn, c in dim_array.coords.items()}
      ds[name] = DataArray(np.asarray(dim_array.data),
                           dims=tuple(dim_array.dims), coords=coords)
    return ds

  return netcdf_io, ds_to_dimarrays, dimarrays_to_ds


def _ds_to_netcdf(self, path=None, **kwargs):
  """Dataset.to_netcdf: returns netCDF bytes when no path is given
  (the reference writes those bytes itself via beam_utils.atomic_write,
  beam_pipeline.py:380-383)."""
  import os
  netcdf_io, ds_to_dimarrays, _ = _dimarray_conversions()
  data = netcdf_io.dumps_dataset_netcdf(ds_to_dimarrays(self))
  if path is None:
    return data
  with open(os.fspath(path), 'wb') as f:
    f.write(data)
  return None


Dataset.to_netcdf = _ds_to_netcdf


def _ds_drop_attrs(self, deep=True):
  out = self.copy(deep=False)
  out._attrs = {}
  if deep:
    out._vars = {vn: (dims, data, {})
                 for vn, (dims, data, _attrs) in out._vars.items()}
  return out


Dataset.drop_attrs = _ds_drop_attrs


def _da_drop_attrs(self, deep=True):
  del deep
  out = self.copy(deep=False)
  out._attrs = {}
  return out


DataArray.drop_attrs = _da_drop_attrs


def open_dataset(store, engine=None, **kwargs):
  import os
  path = os.fspath(store)
  if os.path.isdir(path) and os.path.exists(os.path.join(path, '.zgroup')):
    return open_zarr(path, **kwargs)
  if os.path.isfile(path):
    netcdf_io, _, dimarrays_to_ds = _dimarray_conversions()
    return dimarrays_to_ds(netcdf_io.load_dataset_netcdf(path))
  raise NotImplementedError(
      'shim open_dataset supports zarr groups and netCDF files only')


# -- submodule shims -----------------------------------------------------------

from . import core  # noqa: E402
from . import testing  # noqa: E402
from . import ufuncs  # noqa: E402
