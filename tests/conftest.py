"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set platform env vars BEFORE jax is imported anywhere (SURVEY.md §4:
multi-device tests via xla_force_host_platform_device_count; no real
multi-device host needed).  The suite never touches an accelerator, even on
a machine that has one; chip_smoke.py is the on-device check.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# persistent compilation cache: most test time is XLA-CPU compiles of the
# same graphs; cache them across runs.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/kmerutils_tpu_jax_cache")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

import jax  # noqa: E402

# a jax imported before this file (a plugin, a sitecustomize) has already
# read JAX_PLATFORMS; update the live config too
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


# The whole suite runs in ONE process, and every live jitted executable
# (plus its workspace allocations) holds tens of memory maps; by ~200
# tests the process crosses the kernel's default vm.max_map_count
# (65530), after which an mmap failure inside XLA's compiler segfaults
# the run.  Dropping the executable caches reclaims the maps (measured);
# the persistent compilation cache makes the forced recompiles cheap.
_VMA_GUARD_THRESHOLD = 40_000


@pytest.fixture(autouse=True)
def _vma_guard():
    yield
    try:
        with open("/proc/self/maps") as f:
            n = sum(1 for _ in f)
    except OSError:  # non-Linux: no map accounting, nothing to guard
        return
    if n > _VMA_GUARD_THRESHOLD:
        jax.clear_caches()
        import gc

        gc.collect()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)


def random_dna(rng, n: int) -> str:
    return "".join(rng.choice(list("ACGT"), size=n))
