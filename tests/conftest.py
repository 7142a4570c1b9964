"""Shared test-process hygiene.

The tier-1 suite compiles hundreds of distinct XLA programs (every
Engine/Trainer instance owns fresh jits) in ONE pytest process.  On
CPU, jaxlib's compiled-executable memory is never reclaimed while
references live in jit caches, and past a few hundred live executables
the native compiler segfaults (observed deterministically around the
runtime-heavy middle of the suite; the crashing test passes in
isolation).  Dropping every compilation cache at module boundaries
keeps the live-executable population bounded by the largest single
module instead of the whole suite.

Module scope, not function scope: tests that assert zero-retrace
behavior (sampling.TRACE_COUNTS deltas) warm and measure within one
module, so clearing between modules never breaks them, while clearing
between functions would recompile warmed jits mid-module and slow the
suite badly.
"""
import gc

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself without one")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    import jax
    jax.clear_caches()
    gc.collect()
