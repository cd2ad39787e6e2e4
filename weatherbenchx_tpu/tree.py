"""Nested-structure mapping utilities for trees of DimArrays.

Analogue of the reference's ``weatherbenchX/xarray_tree.py:42-68``
``map_structure``: maps a function over nested dicts/lists/tuples of
DimArrays (or any leaves), treating dicts as internal nodes and everything
else as leaves. Entries for which ``func`` returns None are dropped from
dict results (mirroring the reference's behaviour of omitting None
DataArrays from Datasets).

There is no special Dataset type here: a "dataset" is simply a
``dict[str, DimArray]``.
"""

from typing import Any, Callable


def map_structure(func: Callable[..., Any], *structures: Any) -> Any:
  """Maps ``func`` over parallel nested dict/list/tuple structures.

  Args:
    func: Function applied to corresponding leaves of all structures.
    *structures: One or more parallel nested structures. The first structure
      determines the tree shape; the rest are indexed along with it.

  Returns:
    A structure of the same shape. For dict nodes, keys whose mapped value is
    None are dropped.
  """
  if not callable(func):
    raise TypeError(f'func must be callable, got: {func}')
  if not structures:
    raise ValueError('Must provide at least one structure')

  first = structures[0]
  if isinstance(first, dict):
    # Parallel structures must agree on keys — zip-style silent truncation
    # or ignoring extra keys would silently drop data (the reference's
    # xarray_tree.map_structure validates key equality the same way).
    for s in structures[1:]:
      if not isinstance(s, dict) or s.keys() != first.keys():
        raise ValueError(
            'map_structure requires parallel dict structures with '
            f'identical keys; got {sorted(first.keys())} vs '
            f'{sorted(s.keys()) if isinstance(s, dict) else type(s).__name__}')
    result = {}
    for k in first.keys():
      v = map_structure(func, *[s[k] for s in structures])
      if v is None:
        continue
      result[k] = v
    return result
  if isinstance(first, (list, tuple)):
    for s in structures[1:]:
      if not isinstance(s, (list, tuple)) or len(s) != len(first):
        raise ValueError(
            'map_structure requires parallel sequences of equal length; '
            f'got {len(first)} vs '
            f'{len(s) if isinstance(s, (list, tuple)) else type(s).__name__}')
    return type(first)(map_structure(func, *s) for s in zip(*structures))
  return func(*structures)


def flatten_with_paths(structure: Any, prefix: tuple = ()) -> dict:
  """Flattens nested dicts to a mapping from key-path tuples to leaves."""
  if isinstance(structure, dict):
    out = {}
    for k, v in structure.items():
      out.update(flatten_with_paths(v, prefix + (k,)))
    return out
  return {prefix: structure}


def unflatten_from_paths(flat: dict) -> Any:
  """Inverse of flatten_with_paths for dict-of-dict structures."""
  root: dict = {}
  for path, leaf in flat.items():
    node = root
    for k in path[:-1]:
      node = node.setdefault(k, {})
    node[path[-1]] = leaf
  return root
