"""Test configuration: force an 8-device virtual CPU platform.

The suite runs on the CPU. Sharding correctness is validated on a virtual
8-device CPU mesh (the same XLA partitioner runs on every backend), and
Pallas kernels run in interpret mode. Checks that need the GPU are marked
``gpu``, skip here, and run on the card through ``chip_smoke.py``. The
platform is pinned before any JAX backend initializes.
"""

import os

os.environ['XLA_FLAGS'] = (
    os.environ.get('XLA_FLAGS', '') + ' --xla_force_host_platform_device_count=8'
).strip()

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
# Evaluation accumulators benefit from f64 on host CPU; device code uses
# explicit dtypes so this only widens host-side test math.
jax.config.update('jax_enable_x64', True)
