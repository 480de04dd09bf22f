import os

# Tests run on the CPU backend with 8 virtual devices, so multi-device
# sharding paths are exercised without accelerators. Set through the
# environment, which child processes (the serial check) inherit too.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# Persistent compile cache: the suite is dominated by XLA compiles of the
# while-loop explorer kernels; cache them across pytest invocations.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"),
)

import jax  # noqa: E402

jax.config.update("jax_compilation_cache_dir", os.environ["JAX_COMPILATION_CACHE_DIR"])
jax.config.update("jax_persistent_cache_enable_xla_caches", "all")


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless the default backend is a GPU (tests marked ``gpu``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA device (run with JAX_PLATFORMS=cuda -m gpu)")
