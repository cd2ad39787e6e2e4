"""weatherbenchx_tpu: a JAX forecast-verification framework.

A ground-up JAX/XLA re-design of the WeatherBench-X evaluation engine:
statistics are pure jnp functions over named arrays, aggregation is a fused
einsum producing monoid (Σ weighted-stat, Σ weight) pairs, and distribution
is GSPMD/shard_map over a device mesh instead of a Beam shuffle.
"""

from weatherbenchx_tpu import darray
from weatherbenchx_tpu import tree
from weatherbenchx_tpu import time_chunks
from weatherbenchx_tpu.darray import Coord, DimArray

__version__ = '0.1.0'
