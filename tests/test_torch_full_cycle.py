"""``scripts/full_cycle_sweep_torch.py`` (the port's full-cycle invariant
sweep) against the reference's ``scripts/full_cycle_sweep.py`` and
``tests/invariant_cases.py``, on the CPU at 8 ToRs: the same schemes in
the same order, the same TA instance from the device matching, the same
``check_tables`` result for every scheme, the same output lines and exit
code."""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import invariant_cases as ref_cases  # noqa: E402
from repro.core import round_robin as ref_round_robin  # noqa: E402
from repro.core import toolkit as ref_toolkit  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "full_cycle_sweep_torch.py"
N = 8
LINE = re.compile(r"^(\w+) +n=(\d+) T= *(\d+) compile= *[\d.]+s "
                  r"check= *[\d.]+s (ok|\d+ VIOLATIONS)$")


def _script():
    spec = importlib.util.spec_from_file_location("full_cycle_sweep_torch",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_rows():
    return {name: (sched, bad) for name, sched, _, _, bad in
            _script().sweep(N, torch.device("cpu"))}


def _run(*args):
    return subprocess.run([sys.executable, str(SCRIPT), *args],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)


def test_script_lines_and_exit_code_match_reference():
    got = _run("--n", str(N), "--device", "cpu")
    want = subprocess.run([sys.executable, "scripts/full_cycle_sweep.py",
                           "--n", str(N)], capture_output=True, text=True,
                          timeout=300, cwd=ROOT,
                          env={**os.environ,
                               "PYTHONPATH": str(ROOT / "src")})
    assert got.returncode == want.returncode == 0, got.stderr[-2000:]
    rows = [LINE.match(ln) for ln in got.stdout.splitlines()]
    ref_rows = [LINE.match(ln) for ln in want.stdout.splitlines()]
    assert all(rows) and all(ref_rows), (got.stdout, want.stdout)
    assert [m.group(1, 2, 3, 4) for m in rows] == \
        [m.group(1, 2, 3, 4) for m in ref_rows]
    assert [m.group(1) for m in rows] == \
        [name for name, _, _ in ref_cases.ALL_SCHEMES]


def test_scheme_list_is_the_reference_list():
    to, ta = _script().schemes()
    for port, ref in ((to, ref_cases.TO_SCHEMES), (ta, ref_cases.TA_SCHEMES)):
        assert [(n, f.__name__, h) for n, f, h in port] == \
            [(n, f.__name__, h) for n, f, h in ref]


def test_ta_instance_equals_reference_device_matching():
    got = _script().ta_instance(N, torch.device("cpu"))
    want = ref_cases.scheduler_schedule("edmonds", seed=0, n=N)
    assert got.conn.dtype == np.int32
    np.testing.assert_array_equal(got.conn, np.asarray(want.conn))


@pytest.mark.parametrize("name", [n for n, _, _ in ref_cases.ALL_SCHEMES])
def test_check_tables_result_equals_reference(port_rows, name):
    sched, bad = port_rows[name]
    alg, hashes = ref_cases.SCHEME_BY_NAME[name]
    ref_sched = ref_round_robin(N, 1) if name in \
        [n for n, _, _ in ref_cases.TO_SCHEMES] else \
        ref_cases.scheduler_schedule("edmonds", seed=0, n=N)
    np.testing.assert_array_equal(sched.conn, np.asarray(ref_sched.conn))
    want = ref_toolkit.check_tables(ref_sched, alg(ref_sched), max_hops=32,
                                    hashes=hashes)
    assert bad == want


def test_default_device_is_cuda_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    got = _run("--n", str(N))
    assert got.returncode != 0 and "no CUDA device" in got.stderr
    assert got.stdout == ""
