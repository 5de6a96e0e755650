"""Shared helpers of the PyTorch port's fabric parity suites
(``test_torch_fabric.py``, ``test_torch_fabric_mechanisms.py``): carry the
reference's deployed state and workload over to the port, run both
simulators, and compare the results field for field, values and dtypes.
"""
import dataclasses

import numpy as np

import repro.core as R
import repro_torch.core as Q
from repro_torch.core.fabric import tables_from_arrays, workload_from_arrays


def carry(tables, wl):
    """The reference's ``FabricTables`` / ``Workload`` as the port's."""
    return (tables_from_arrays(dataclasses.asdict(tables), tables.multipath),
            workload_from_arrays(dataclasses.asdict(wl)))


def assert_sim_equal(ref, port):
    """Every field of the port's ``SimResult`` equals the reference's, in
    value, shape and dtype; the reference ran without telemetry."""
    assert ref.telemetry is None
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(ref)
                     if f.name != "telemetry"]
    for name in names:
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


def simulate_both(tables, wl, num_slices, **cfg):
    """(reference result, port result on the CPU) for one configuration."""
    ref = R.simulate(tables, wl, R.FabricConfig(**cfg), num_slices)
    qt, qw = carry(tables, wl)
    port = Q.simulate(qt, qw, Q.FabricConfig(**cfg), num_slices, device="cpu")
    return ref, port
