"""Native (C++) runtime components, built on demand and bound via ctypes.

``blockstore``: parallel pwrite/pread of raw array blocks — the I/O core of
the .wbx dataset container (``io.py``).
``zarrcodec``: parallel zarr cell read+decode (raw/zlib/gzip/zstd/blosc) —
the decompression core of the self-contained zarr reader (``zarr_io.py``).

Each is built with g++ on first use and cached next to its source; every
consumer has a pure-Python fallback, so a missing toolchain degrades
performance, not functionality.
"""

import ctypes
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))


class _Module:
  """One on-demand-compiled shared library."""

  def __init__(self, name: str, extra_link: list, configure) -> None:
    self._src = os.path.join(_HERE, f'{name}.cpp')
    self._so = os.path.join(_HERE, f'_{name}.so')
    self._extra_link = extra_link
    self._configure = configure
    self._lock = threading.Lock()
    self._lib = None
    self._failed = False
    self.name = name

  def _build(self) -> bool:
    # uuid-suffixed tmp: concurrent first-use builds across processes
    # (multi-host pod, pytest-xdist) must not interleave writes into one
    # shared tmp file — a torn .so with a fresh mtime would pin every
    # future process to the Python fallback until deleted by hand.
    import uuid
    tmp = f'{self._so}.tmp.{uuid.uuid4().hex[:12]}'
    cmd = (['g++', '-O3', '-shared', '-fPIC', '-pthread', '-std=c++17',
            self._src, '-o', tmp] + self._extra_link)
    try:
      subprocess.run(cmd, check=True, capture_output=True, timeout=120)
      os.replace(tmp, self._so)
      return True
    except (subprocess.SubprocessError, OSError) as e:
      err = getattr(e, 'stderr', b'') or b''
      logger.warning('%s native build failed (%s %s); using the '
                     'pure-Python fallback', self.name, e,
                     err.decode(errors='replace')[-500:])
      return False

  def load(self):
    if os.environ.get('WBX_NO_NATIVE') == '1':
      return None  # force the pure-Python fallbacks (CI fallback matrix)
    with self._lock:
      if self._lib is not None or self._failed:
        return self._lib
      stale = (not os.path.exists(self._so)
               or os.path.getmtime(self._so) < os.path.getmtime(self._src))
      if stale and not self._build():
        self._failed = True
        return None
      try:
        lib = ctypes.CDLL(self._so)
        self._configure(lib)
      except (OSError, AttributeError) as e:
        logger.warning('%s load failed (%s)', self.name, e)
        self._failed = True
        return None
      self._lib = lib
      return self._lib


_c_int64_p = ctypes.POINTER(ctypes.c_int64)
_c_void_pp = ctypes.POINTER(ctypes.c_void_p)


def _configure_blockstore(lib) -> None:
  for fn in (lib.bs_pwrite_blocks, lib.bs_pread_blocks):
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, _c_void_pp,
                   _c_int64_p, _c_int64_p, ctypes.c_int]
    fn.restype = ctypes.c_int


def _configure_zarrcodec(lib) -> None:
  lib.wbx_decode_cells.argtypes = [
      ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
      _c_void_pp, ctypes.c_int64, ctypes.c_int]
  lib.wbx_decode_cells.restype = ctypes.c_int
  lib.wbx_encode_cells.argtypes = [
      ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
      _c_void_pp, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
  lib.wbx_encode_cells.restype = ctypes.c_int


_blockstore = _Module('blockstore', [], _configure_blockstore)
_zarrcodec = _Module('zarrcodec', ['-lz', '-l:libzstd.so.1', '-l:liblz4.so.1'],
                     _configure_zarrcodec)


def available() -> bool:
  return _blockstore.load() is not None


def zarrcodec_available() -> bool:
  return _zarrcodec.load() is not None


def _as_void_pp(addresses):
  return (ctypes.c_void_p * len(addresses))(*addresses)


def _as_int64_p(values):
  return (ctypes.c_int64 * len(values))(*values)


def pwrite_blocks(path: str, buffers, offsets, threads: int = 8) -> None:
  """Parallel positional write of numpy buffers (C-contiguous) to path."""
  lib = _blockstore.load()
  if lib is None:
    raise RuntimeError('native blockstore unavailable')
  addrs = [b.ctypes.data for b in buffers]
  sizes = [b.nbytes for b in buffers]
  err = lib.bs_pwrite_blocks(
      path.encode(), len(buffers), _as_void_pp(addrs),
      _as_int64_p(sizes), _as_int64_p(list(offsets)), threads)
  if err != 0:
    raise OSError(err, os.strerror(err), path)


def pread_blocks(path: str, buffers, offsets, threads: int = 8) -> None:
  """Parallel positional read into preallocated numpy buffers."""
  lib = _blockstore.load()
  if lib is None:
    raise RuntimeError('native blockstore unavailable')
  addrs = [b.ctypes.data for b in buffers]
  sizes = [b.nbytes for b in buffers]
  err = lib.bs_pread_blocks(
      path.encode(), len(buffers), _as_void_pp(addrs),
      _as_int64_p(sizes), _as_int64_p(list(offsets)), threads)
  if err != 0:
    raise OSError(err, os.strerror(err), path)


_CODEC_IDS = {None: 0, 'zlib': 1, 'gzip': 2, 'zstd': 3, 'blosc': 4}

_DECODE_ERRS = {1: 'open failed', 2: 'short read', 3: 'malformed chunk',
                4: 'decode error', 5: 'size mismatch',
                6: 'unsupported feature', 7: 'write failed',
                8: 'encode error'}


def decode_cells(paths, codec, buffers, threads: int = 8) -> None:
  """Parallel read+decode of zarr cell files into preallocated buffers.

  ``paths[i] is None`` marks a missing cell: skipped, caller pre-fills.
  Each buffer must be C-contiguous with identical nbytes (the cell size).
  """
  lib = _zarrcodec.load()
  if lib is None:
    raise RuntimeError('native zarrcodec unavailable')
  n = len(paths)
  if n == 0:
    return
  cell_nbytes = buffers[0].nbytes
  c_paths = (ctypes.c_char_p * n)(
      *[p.encode() if p is not None else None for p in paths])
  addrs = _as_void_pp([b.ctypes.data for b in buffers])
  rc = lib.wbx_decode_cells(n, c_paths, _CODEC_IDS[codec], addrs,
                            cell_nbytes, threads)
  if rc != 0:
    i, err = divmod(rc - 1, 16)
    raise OSError(f'decode_cells: cell {paths[i]!r}: '
                  f'{_DECODE_ERRS.get(err, err)}')


# "Use the codec default" level sentinel (mirrors zarrcodec.cpp
# kDefaultLevel): explicit 0 (zlib stored) and negative values (zstd fast
# levels) are valid settings that must pass through, matching codecs.py.
_LEVEL_DEFAULT = -(2**31)


def encode_cells(paths, codec, buffers, typesize: int,
                 level=None, threads: int = 8) -> None:
  """Parallel encode+write of cell buffers (inverse of decode_cells).

  Supported codecs: None/'zlib'/'zstd'/'blosc' (blosc is lz4+shuffle,
  numcodecs-compatible). Buffers must be C-contiguous, identical nbytes.
  ``level=None`` means the codec's default (zlib 1, zstd 3 — same as
  ``codecs.encode_cell``); 0 and negative values are honored.
  """
  lib = _zarrcodec.load()
  if lib is None:
    raise RuntimeError('native zarrcodec unavailable')
  n = len(paths)
  if n == 0:
    return
  if codec == 'gzip':
    raise ValueError('gzip is decode-only')
  cell_nbytes = buffers[0].nbytes
  c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
  addrs = _as_void_pp([b.ctypes.data for b in buffers])
  rc = lib.wbx_encode_cells(n, c_paths, _CODEC_IDS[codec], addrs,
                            cell_nbytes, typesize,
                            _LEVEL_DEFAULT if level is None else int(level),
                            threads)
  if rc != 0:
    i, err = divmod(rc - 1, 16)
    raise OSError(f'encode_cells: cell {paths[i]!r}: '
                  f'{_DECODE_ERRS.get(err, err)}')
