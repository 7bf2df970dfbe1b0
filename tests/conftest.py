"""Test harness: force CPU with 8 virtual devices so multi-device
sharding tests run anywhere (standard JAX fake-multi-device trick).

The platform is set through jax.config as well as JAX_PLATFORMS, before
any backend initializes, so a machine whose JAX defaults to a GPU still
runs the suite on the CPU. The GPU path is exercised by
``python chip_smoke.py`` instead.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402  (import after env setup)

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

assert jax.default_backend() == "cpu", jax.default_backend()
assert len(jax.devices()) == 8, jax.devices()


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
