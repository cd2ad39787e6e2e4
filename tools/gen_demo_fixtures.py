"""Generates the demo fixtures for the canonical verify drive.

Construction (64x32 grid, January 2020, 12 h inits, 40 6-h leads):
  target(valid)      = clim(doy, hour) + z_common(valid) + z_t(valid)
  prediction(i, l)   = clim(doy, hour) + z_common(i + l) + z_p(i, l)
with all z ~ N(0,1) iid. Then analytically:
  RMSE = sqrt(E[(z_p - z_t)^2]) = sqrt(2)
  ACC  = corr(z_c + z_p, z_c + z_t) = 1/2
Variables: geopotential (levels 500/700/850) and 2m_temperature, ECMWF
dim names (time / prediction_timedelta / latitude / longitude / level) so
the benchmark CLI's renaming path is exercised (reference
``xarray_loaders.py:25-53``).

Usage: python tools/gen_demo_fixtures.py [outdir=<checkout>/.stores/demo]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from weatherbenchx_tpu import io as io_lib
from weatherbenchx_tpu.darray import Coord, DimArray


DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), '.stores', 'demo')


def main(outdir: str = DEFAULT_DIR) -> None:
  os.makedirs(outdir, exist_ok=True)
  rng = np.random.default_rng(20200101)

  nlat, nlon = 32, 64
  lats = np.linspace(-90, 90, nlat)
  lons = np.linspace(0, 360, nlon, endpoint=False)
  levels = np.array([500, 700, 850])

  init = (np.datetime64('2020-01-01', 'ns')
          + np.arange(62) * np.timedelta64(12, 'h'))
  lead = (np.arange(40) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
  valid = (np.datetime64('2020-01-01', 'ns')
           + np.arange(2 * 62 + 40) * np.timedelta64(6, 'h'))

  def field(shape):
    return rng.standard_normal(shape).astype(np.float32)

  # Climatology keyed (dayofyear, hour): zeros for T2m, level-scaled for z.
  doy = np.arange(1, 367)
  hours = np.array([0, 6, 12, 18])
  clim_t2m = field((366, 4, nlat, nlon))
  clim_z = field((366, 4, len(levels), nlat, nlon))

  def clim_at(times, arr):
    d = ((times.astype('datetime64[D]')
          - times.astype('datetime64[Y]')).astype(int))
    h = (times.astype('datetime64[h]').astype(int)) % 24
    return arr[d, h // 6]

  zc_t2m = field((len(valid), nlat, nlon))
  zc_z = field((len(valid), len(levels), nlat, nlon))

  tgt = {
      '2m_temperature': DimArray(
          clim_at(valid, clim_t2m) + zc_t2m
          + field((len(valid), nlat, nlon)),
          ('time', 'latitude', 'longitude'),
          {'time': valid, 'latitude': lats, 'longitude': lons}),
      'geopotential': DimArray(
          clim_at(valid, clim_z) + zc_z
          + field((len(valid), len(levels), nlat, nlon)),
          ('time', 'level', 'latitude', 'longitude'),
          {'time': valid, 'level': levels, 'latitude': lats,
           'longitude': lons}),
  }

  vt = init[:, None] + lead[None, :]
  flat = vt.reshape(-1)
  pos = np.searchsorted(valid, flat).reshape(vt.shape)
  pred = {
      '2m_temperature': DimArray(
          clim_at(flat, clim_t2m).reshape(62, 40, nlat, nlon)
          + zc_t2m[pos] + field((62, 40, nlat, nlon)),
          ('time', 'prediction_timedelta', 'latitude', 'longitude'),
          {'time': init, 'prediction_timedelta': lead,
           'latitude': lats, 'longitude': lons}),
      'geopotential': DimArray(
          clim_at(flat, clim_z).reshape(62, 40, len(levels), nlat, nlon)
          + zc_z[pos] + field((62, 40, len(levels), nlat, nlon)),
          ('time', 'prediction_timedelta', 'level', 'latitude',
           'longitude'),
          {'time': init, 'prediction_timedelta': lead, 'level': levels,
           'latitude': lats, 'longitude': lons}),
  }

  clim = {
      '2m_temperature': DimArray(
          clim_t2m, ('dayofyear', 'hour', 'latitude', 'longitude'),
          {'dayofyear': doy, 'hour': hours, 'latitude': lats,
           'longitude': lons}),
      'geopotential': DimArray(
          clim_z, ('dayofyear', 'hour', 'level', 'latitude', 'longitude'),
          {'dayofyear': doy, 'hour': hours, 'level': levels,
           'latitude': lats, 'longitude': lons}),
  }

  io_lib.save_dataset(os.path.join(outdir, 'hres.npz'), pred)
  io_lib.save_dataset(os.path.join(outdir, 'era5.npz'), tgt)
  io_lib.save_dataset(os.path.join(outdir, 'clim.npz'), clim)
  print(f'wrote {outdir}/{{hres,era5,clim}}.npz')


if __name__ == '__main__':
  main(*sys.argv[1:])
