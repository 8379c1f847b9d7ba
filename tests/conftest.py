"""Test harness config: run on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated without accelerators via
``xla_force_host_platform_device_count`` (testing a multi-device mesh on
one box — SURVEY.md §4). Must be set before jax import.
"""

import os

# NBODY_TEST_ON_GPU=1 keeps the machine's GPU for the `gpu`-marked tests
# (README "Tests"); every other run is pinned to the CPU mesh.
if os.environ.get("NBODY_TEST_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# Tests write nothing into the checkout: no persistent compilation cache
# (nbody_jax sets one on import; tests/test_compile_cache.py checks where).
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_programs_between_modules():
    """Release compiled executables after each test module.

    On a 1-CPU box the full suite deterministically segfaults inside
    XLA:CPU's compiler (backend_compile_and_load) at the ~192nd test —
    the same program compiles fine in a fresh process, so the trigger is
    cumulative in-process JIT state, not the program. Dropping the
    executable caches between modules keeps the resident LLVM JIT state
    bounded. (jax.clear_caches is cheap relative to the suite; recompiles
    within a module are unaffected.)
    """
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with NBODY_TEST_ON_GPU=1 on one)")


@pytest.fixture
def rng_key():
    return jax.random.key(0)


@pytest.fixture(params=[2, 3])
def dim(request):
    return request.param


def assert_allclose(a, b, rtol=1e-5, atol=0.0, err_msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=rtol, atol=atol, err_msg=err_msg)
