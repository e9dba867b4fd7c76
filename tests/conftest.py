"""Test configuration: force an 8-device virtual CPU platform.

Multi-chip sharding paths are exercised on a virtual CPU mesh
(xla_force_host_platform_device_count), as real multi-chip TPU hardware is
not available in CI.  Must run before any JAX computation.  The ``card``
marker: tests that need a CUDA card, each deciding inside a fixture
whether one is present and skipping otherwise.
"""

import os

os.environ['XLA_FLAGS'] = (
    os.environ.get('XLA_FLAGS', '')
    + ' --xla_force_host_platform_device_count=8'
)

import jax

jax.config.update('jax_platforms', 'cpu')
# allow float64 in numerical-accuracy tests (framework default stays fp32)
jax.config.update('jax_enable_x64', True)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA card; skipped where none is present')
