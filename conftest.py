"""Repo-wide pytest hook: drop JAX's compiled programs when a test module
ends.

Every cached XLA CPU executable keeps memory mappings, and a test worker
that keeps all of a long run's programs cached reaches the kernel's limit
on mappings (``vm.max_map_count``); XLA then crashes with a segfault in a
later compile. Clearing the caches after each module bounds what a worker
holds to one module's programs.

This file must not import ``jax``: it loads before ``tests/conftest.py``,
which sets ``XLA_FLAGS`` for the 8-device CPU mesh before anything may
initialise JAX. The fixture reads ``jax`` from ``sys.modules`` only once a
module has run, and does nothing where no test imported it.
"""
import gc
import sys

import pytest


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    yield
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
        gc.collect()
