"""Rules of the PyTorch port that no parity test covers:

* no module of ``src/repro_torch/``, nor ``chip_smoke.py`` or the port's
  example, imports ``jax``, ``repro`` or ``networkx`` (the card's machine
  has none of them), and the package imports with all three blocked;
* entry points run on CUDA unless told otherwise: without a card and
  without ``device="cpu"`` they raise, never quietly run on the CPU;
* a kernel wrapper given tensors that are not on the CPU launches its
  kernel or raises, never falls back to the plain version, and validates
  what it passes to the kernel;
* kernel libraries are named after a hash of their source, and a failed
  build raises with the compiler's output.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as Q  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import admission as Q_adm  # noqa: E402
from repro_torch.kernels import time_flow_lookup as Q_tfl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro", "networkx"}
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py"])


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_repro_or_networkx(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_imports_with_jax_repro_networkx_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro', 'networkx'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch, repro_torch.core, repro_torch.kernels\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# CUDA unless told otherwise
# ---------------------------------------------------------------------------

def _small_run_inputs():
    sched = Q.round_robin(6, 1)
    tables = Q.FabricTables.build(sched, Q.vlb(sched))
    wl = Q.synthesize("rpc", 6, 8, slice_bytes=4_000, load=0.5,
                      max_packets=100, seed=0)
    return tables, wl


def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(node="rack", node_num=6, uplink=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Q.OpenOpticsNet(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Q.OpenOpticsNet(cfg, device="cuda")
    tables, wl = _small_run_inputs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Q.simulate(tables, wl, Q.FabricConfig(slice_bytes=4_000), 4)
    assert Q.OpenOpticsNet(cfg, device="cpu").device.type == "cpu"
    res = Q.simulate(tables, wl, Q.FabricConfig(slice_bytes=4_000), 4,
                     device="cpu")
    assert res.t_deliver.dtype == np.int32


def test_unported_inputs_raise():
    tables, wl = _small_run_inputs()
    for kw in (dict(failures=object()), dict(control=object()),
               dict(telemetry=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Q.simulate(tables, wl, Q.FabricConfig(), 2, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Q.OpenOpticsNet(dict(node_num=4, telemetry={}), device="cpu")


# ---------------------------------------------------------------------------
# kernel wrappers: the kernel or an error, never the plain version
# ---------------------------------------------------------------------------

def _lookup_args(device):
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    return (z(2, 3, 4, 4, 2), z(2, 3, 4, 4, 2), 1, z(5), z(5), z(5), z(5))


def _admission_args(device):
    return (torch.zeros(5, dtype=torch.int32, device=device),
            torch.zeros(5, dtype=torch.int32, device=device),
            torch.ones(5, dtype=torch.bool, device=device),
            torch.zeros(3, dtype=torch.int32, device=device))


@pytest.fixture
def no_kernel_library(monkeypatch, tmp_path):
    """No built library, no nvcc, and plain versions that fail the test if
    a wrapper reaches them."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda *_: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda *_: False)

    def plain(*a, **k):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(Q_tfl, "time_flow_lookup_plain", plain)
    monkeypatch.setattr(Q_adm, "admission_admit_plain", plain)


def test_wrappers_raise_without_kernel_library(monkeypatch, no_kernel_library):
    """Tensors that are not on the CPU (``meta`` ones stand in for CUDA,
    with the device check waived) reach the library build, which raises
    for want of nvcc; nothing falls back and no launch is counted."""
    monkeypatch.setattr(Q_tfl, "_require_cuda", lambda *a: None)
    monkeypatch.setattr(Q_adm, "_require_cuda", lambda *a: None)
    l0, a0 = Q_tfl.launches, Q_adm.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        Q_tfl.time_flow_lookup(*_lookup_args("meta"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        Q_adm.admission_admit(*_admission_args("meta"), num_keys=3)
    assert (Q_tfl.launches, Q_adm.launches) == (l0, a0)


def test_wrappers_refuse_non_cuda_devices(no_kernel_library):
    with pytest.raises(ValueError, match="CUDA"):
        Q_tfl.time_flow_lookup(*_lookup_args("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        Q_adm.admission_admit(*_admission_args("meta"), num_keys=3)


def test_wrappers_validate_kernel_inputs():
    tn, td, tm, sel, node, dst, h = _lookup_args("cpu")
    Q_tfl._check(tn, td, tm, sel, node, dst, h)
    bad = [
        (tn[0], td[0], tm, sel, node, dst, h),                 # not stacked
        (tn, td, 3, sel, node, dst, h),                        # slice >= Tr
        (tn, td, tm, sel, node.long(), dst, h),                # dtype
        (tn, td, tm, sel[:4], node, dst, h),                   # length
        (tn.transpose(2, 3), td, tm, sel, node, dst, h),       # layout
    ]
    for args in bad:
        with pytest.raises(ValueError):
            Q_tfl._check(*args)
    key, size, want, cap = _admission_args("cpu")
    Q_adm._check(key, size, want, cap, 3)
    for args in [(key, size, want.int(), cap, 3), (key, size, want, cap, 4),
                 (key[:4], size, want, cap, 3), (key, size, want, cap, 0)]:
        with pytest.raises(ValueError):
            Q_adm._check(*args)


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    """A compiler error surfaces as a RuntimeError carrying nvcc's output,
    and leaves no library behind."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'k.cu(3): error: expected a ;'\nexit 2\n")
    fake.chmod(0o755)
    (tmp_path / "k.cu").write_text("broken\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="expected a ;"):
        _build.build(["k"])
    assert not _build.library_path("k").exists()
    assert list((tmp_path / "build").iterdir()) == []


def test_library_name_follows_source(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path("k")
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk_")
    src.write_text("// two\n")
    assert _build.library_path("k") != first
    assert {p.stem for p in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu")} \
        == {"time_flow_lookup", "admission"}
