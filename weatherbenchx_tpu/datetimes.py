"""Calendar fields of datetime64 arrays, computed with numpy alone.

The climatology gathers (ACC, SEEPS), the climatology loaders and the time
binnings need the day of year, hour or month of valid times on the host.
These are plain datetime64 unit conversions, so the evaluation path needs
no dataframe library.
"""

import numpy as np

FIELDS = ('year', 'month', 'day', 'dayofyear', 'hour', 'minute', 'second',
          'dayofweek')


def datetime_field(values, field: str) -> np.ndarray:
  """The calendar ``field`` of each datetime64 value, as int64.

  Matches pandas' ``DatetimeIndex`` attribute of the same name: months,
  days and days of year count from 1, ``dayofweek`` from Monday = 0.

  Args:
    values: array-like of datetime64 values (any unit, any shape).
    field: one of :data:`FIELDS`.

  Returns:
    An int64 array of ``values``' shape.
  """
  t = np.asarray(values).astype('datetime64[ns]')
  if field == 'year':
    return t.astype('datetime64[Y]').astype(np.int64) + 1970
  if field == 'month':
    return t.astype('datetime64[M]').astype(np.int64) % 12 + 1
  if field == 'day':
    return _count(t, 'M', 'D') + 1
  if field == 'dayofyear':
    return _count(t, 'Y', 'D') + 1
  if field == 'hour':
    return _count(t, 'D', 'h')
  if field == 'minute':
    return _count(t, 'h', 'm')
  if field == 'second':
    return _count(t, 'm', 's')
  if field == 'dayofweek':
    # 1970-01-01 was a Thursday (Monday = 0 makes it 3).
    return (t.astype('datetime64[D]').astype(np.int64) + 3) % 7
  raise ValueError(f'unknown datetime field {field!r}; expected one of '
                   f'{FIELDS}')


def _count(t: np.ndarray, period: str, unit: str) -> np.ndarray:
  """Whole ``unit`` steps elapsed since the start of each ``period``."""
  start = t.astype(f'datetime64[{period}]').astype('datetime64[ns]')
  return ((t - start) // np.timedelta64(1, unit)).astype(np.int64)
