"""The numpy calendar-field helper against pandas' DatetimeIndex."""

import numpy as np
import pytest

from weatherbenchx_tpu import binning, datetimes
from weatherbenchx_tpu.darray import DimArray

pd = pytest.importorskip('pandas')


def _times():
  rng = np.random.default_rng(0)
  # 1850-2150, second resolution plus nanoseconds: leap years, centuries,
  # and dates before the 1970 epoch.
  seconds = rng.integers(0, 300 * 365 * 86400, 5000)
  return (np.datetime64('1850-01-01', 'ns')
          + seconds * np.timedelta64(1, 's')
          + rng.integers(0, 10**9, 5000) * np.timedelta64(1, 'ns'))


@pytest.mark.parametrize('field', datetimes.FIELDS)
def test_matches_pandas(field):
  t = _times().reshape(50, 100)
  got = datetimes.datetime_field(t, field)
  want = np.asarray(getattr(pd.DatetimeIndex(t.reshape(-1)), field))
  assert got.shape == t.shape and got.dtype == np.int64
  np.testing.assert_array_equal(got.reshape(-1), want)


def test_any_unit_and_leap_day():
  t = np.array(['2020-02-29T18', '2020-12-31T23', '2021-03-01'],
               'datetime64[h]')
  np.testing.assert_array_equal(
      datetimes.datetime_field(t, 'dayofyear'), [60, 366, 60])
  np.testing.assert_array_equal(datetimes.datetime_field(t, 'hour'),
                                [18, 23, 0])


def test_unknown_field_raises():
  with pytest.raises(ValueError, match='unknown datetime field'):
    datetimes.datetime_field(_times(), 'quarter')


def test_time_unit_binning_uses_it():
  t = np.array(['2020-01-01T00', '2020-01-01T06', '2020-07-01T06'],
               'datetime64[ns]')
  stat = DimArray(np.zeros(3, np.float32), ('time',), {'time': t})
  mask = binning.ByTimeUnit('hour', 'time').create_bin_mask(stat)
  hours = np.asarray(mask.coord_values('time_hour'))
  np.testing.assert_array_equal(hours, [0, 6])
  np.testing.assert_array_equal(np.asarray(mask.data),
                                [[True, False, False], [False, True, True]])
