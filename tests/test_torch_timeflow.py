"""The port's copy of ``repro.core.timeflow`` (``Entry``,
``TimeFlowTable``) against the reference: the same entries, lookups and
dense lowering on tables made from seeds with numpy."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import timeflow as RF  # noqa: E402
from repro_torch.core import timeflow as QF  # noqa: E402
import repro_torch.core as Q  # noqa: E402


def _entries(rng, n, T, count):
    """Random entries: flow entries, timed ones with wildcards on either
    side, and source-routing ones (``hops``)."""
    out = []
    for _ in range(count):
        kind = int(rng.integers(0, 4))
        dst = int(rng.integers(0, n))
        if kind == 0:
            out.append(dict(arr_ts=None, dst=dst, egress=int(rng.integers(n))))
        elif kind == 1:
            out.append(dict(arr_ts=int(rng.integers(0, 3 * T)), dst=dst,
                            egress=int(rng.integers(n)),
                            dep_ts=int(rng.integers(0, 3 * T))))
        elif kind == 2:
            out.append(dict(arr_ts=int(rng.integers(0, T)), dst=dst,
                            egress=int(rng.integers(n)), dep_ts=None))
        else:
            hops = tuple((int(rng.integers(n)), int(rng.integers(0, 2 * T)))
                         for _ in range(int(rng.integers(1, 4))))
            out.append(dict(arr_ts=int(rng.integers(0, T)), dst=dst,
                            hops=hops))
    return out


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("seed", range(4))
def test_timeflow_table_matches_reference(seed, k):
    rng = np.random.default_rng(seed)
    n, T = int(rng.integers(3, 9)), int(rng.integers(1, 6))
    ref = RF.TimeFlowTable(node=1, num_slices=T, num_nodes=n)
    port = QF.TimeFlowTable(node=1, num_slices=T, num_nodes=n)
    for kw in _entries(rng, n, T, 40):
        assert port.add(QF.Entry(**kw)) and ref.add(RF.Entry(**kw))
    for a, b in zip(port.compile(k), ref.compile(k)):
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for t in range(2 * T):
        for d in range(n):
            assert [vars(e) for e in port.lookup(t, d)] == \
                [vars(e) for e in ref.lookup(t, d)]
    assert port.is_flow_table() == ref.is_flow_table()


def test_flow_table_and_exports():
    flow = QF.TimeFlowTable(node=0, num_slices=4, num_nodes=3)
    flow.add(QF.Entry(arr_ts=None, dst=2, egress=1))
    assert flow.is_flow_table() and QF.Entry(None, 2).is_flow_entry()
    nxt, dep = flow.compile(k=2)
    assert (nxt[:, 2, 0] == 1).all() and (nxt[:, 2, 1] == -1).all()
    assert (dep == 0).all()
    assert Q.Entry is QF.Entry and Q.TimeFlowTable is QF.TimeFlowTable
    assert QF.WILDCARD is RF.WILDCARD is None
