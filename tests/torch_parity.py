"""Shared helpers of the PyTorch port's parity suites: carry the
reference's deployed state, workload and masks over to the port, run both
simulators, and compare the results field for field, values and dtypes,
telemetry counters included (``test_torch_fabric*.py``,
``test_torch_telemetry.py``); and
``release_compiled_programs``, which every port suite that compiles JAX
programs imports.
"""
import dataclasses
import gc

import jax
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as Q
from repro_torch.core.fabric import tables_from_arrays, workload_from_arrays


def carry(tables, wl):
    """The reference's ``FabricTables`` / ``Workload`` as the port's."""
    return (tables_from_arrays(dataclasses.asdict(tables), tables.multipath),
            workload_from_arrays(dataclasses.asdict(wl)))


def carry_masks(failures=None, control=None):
    """The reference's ``FailureMasks`` / ``ControlMasks`` (or ``None``) as
    the port's."""
    if failures is not None:
        failures = Q.FailureMasks(failures.link_cap.copy(),
                                  failures.node_ok.copy())
    if control is not None:
        control = Q.ControlMasks(**{f.name: getattr(control, f.name)
                                    for f in dataclasses.fields(control)})
    return failures, control


def _assert_arrays_equal(a, b, name):
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


def assert_sim_equal(ref, port):
    """Every field of the port's ``SimResult`` equals the reference's, in
    value, shape and dtype, and so does every field of their telemetry
    counters (both ``None`` when the runs had no telemetry)."""
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    for name in names:
        if name != "telemetry":
            _assert_arrays_equal(getattr(ref, name), getattr(port, name),
                                 name)
    assert (ref.telemetry is None) == (port.telemetry is None)
    if ref.telemetry is not None:
        fields = [f.name for f in dataclasses.fields(port.telemetry)]
        assert fields == [f.name for f in dataclasses.fields(ref.telemetry)]
        for name in fields:
            a, b = getattr(ref.telemetry, name), getattr(port.telemetry, name)
            if name == "lat_edges":
                assert a == b
            else:
                _assert_arrays_equal(a, b, f"telemetry.{name}")


def simulate_both(tables, wl, num_slices, **cfg):
    """(reference result, port result on the CPU) for one configuration."""
    ref = R.simulate(tables, wl, R.FabricConfig(**cfg), num_slices)
    qt, qw = carry(tables, wl)
    port = Q.simulate(qt, qw, Q.FabricConfig(**cfg), num_slices, device="cpu")
    return ref, port


@pytest.fixture(autouse=True, scope="module")
def release_compiled_programs():
    """Drop JAX's caches when a module that imports this fixture starts and
    ends. Every cached XLA CPU executable keeps memory mappings; a test
    worker that keeps all of the suite's programs cached runs into the
    kernel's limit on mappings (``vm.max_map_count``), and XLA then crashes
    with a segfault in a later compile."""
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's torch ops on one intra-op thread, and restore the
    count after it. The port's small CPU runs (N = 8, a few thousand
    packets) gain nothing from a thread pool, and under ``-n`` workers
    each pool competes with every other worker's for the same cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
