import os
import sys

# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths are
# exercised without accelerator hardware (reference tests similarly validate
# the MPI code at mpiexec -np 2, test/test.sh:74-80).  The tests marked
# `gpu` run on the GPU instead, only with EDIPACK_TPU_GPU_TESTS=1:
#   EDIPACK_TPU_GPU_TESTS=1 python -m pytest tests/ -m gpu
GPU_RUN = os.environ.get("EDIPACK_TPU_GPU_TESTS") == "1"
if not GPU_RUN:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(__file__))

import jax  # noqa: E402

# pin the CPU backend from Python too: the config update wins over any
# platform choice made before this point, keeping the suite on the virtual
# 8-device CPU mesh
if not GPU_RUN:
    jax.config.update("jax_platforms", "cpu")
# NOTE: the persistent XLA compilation cache is deliberately NOT enabled for
# the CPU suite: this jax build segfaults both when loading cache entries
# written on a different machine type (AOT machine-feature mismatch ->
# SIGILL) and intermittently when serializing CPU executables
# (compilation_cache.put_executable_and_time).


# this jaxlib build intermittently SEGFAULTS in backend_compile_and_load
# when many hundreds of live compiled executables have accumulated (seen
# mid-suite in the slow tier; any single file passes in isolation).
# Dropping the executable caches between modules keeps the live-executable
# count bounded; the cost is re-tracing shared shapes per module.
import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: GPU tests run only in a GPU run
    (EDIPACK_TPU_GPU_TESTS=1) on a machine whose JAX sees a GPU."""
    if not GPU_RUN:
        pytest.skip("GPU test: set EDIPACK_TPU_GPU_TESTS=1 on a GPU machine")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"GPU test: JAX reports {dev.platform!r}, not a GPU")
    return dev
