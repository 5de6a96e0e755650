"""Rules of the PyTorch port that no parity test covers:

* no module of ``src/repro_torch/``, nor ``chip_smoke.py``,
  ``chip_fault_probe.py``, ``chip_decode_probe.py`` or the port's
  examples (``examples/*_torch.py``), imports ``jax``,
  ``repro`` or ``networkx`` (the card's machine has none of them), and the
  package imports with all three blocked;
* entry points run on CUDA unless told otherwise: without a card and
  without ``device="cpu"`` they raise, never quietly run on the CPU (the
  language-model entry points are checked in ``test_torch_lm.py``);
* ``build_model`` builds every config, at the reference's parameter count;
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
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import build_model, count_params, stacks  # noqa: E402
from repro_torch.kernels import admission as Q_adm  # noqa: E402
from repro_torch.kernels import decode_attention as Q_da  # noqa: E402
from repro_torch.kernels import flash_attention as Q_fa  # noqa: E402
from repro_torch.kernels import grouped_matmul as Q_gmm  # noqa: E402
from repro_torch.kernels import rg_lru as Q_rl  # noqa: E402
from repro_torch.kernels import time_flow_lookup as Q_tfl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro", "networkx", "benchmarks"}
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py", ROOT / "chip_fault_probe.py",
                 ROOT / "chip_decode_probe.py"]
              + sorted((ROOT / "examples").glob("*_torch.py")))


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
            "import repro_torch, repro_torch.core, repro_torch.kernels\n"
            "import repro_torch.models, repro_torch.configs\n"
            "import repro_torch.launch.serve\n")
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
    fab = Q.FabricConfig(slice_bytes=4_000)
    sched = Q.round_robin(6, 1)
    rcfg = Q.ReconfigConfig(epoch_slices=2, num_epochs=2, k_hot=1)
    for call in (lambda: Q.simulate(tables, wl, fab, 4),
                 lambda: Q.simulate_incremental(tables, wl, fab, 4, window=2),
                 lambda: Q.init_state(tables, wl, fab),
                 lambda: Q.init_state(tables, None, fab),
                 lambda: Q.simulate_phased(sched, [(Q.vlb(sched), 4)], wl,
                                           fab),
                 lambda: Q.reconfigure(sched, wl, fab, rcfg),
                 lambda: Q.vlb(sched, compile_impl="jnp"),
                 lambda: Q.repair(sched, "hoho", np.zeros((6, 6), bool),
                                  impl="jnp"),
                 lambda: Q.simulate_eqo(50, total_ns=1_000)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert Q.OpenOpticsNet(cfg, device="cpu").device.type == "cpu"
    res = Q.simulate(tables, wl, fab, 4, device="cpu")
    assert res.t_deliver.dtype == np.int32
    # the net's clocked service runs where the net does
    net = Q.OpenOpticsNet(cfg, device="cpu")
    net.deploy_topo(sched)
    net.deploy_routing(Q.vlb(sched))
    assert net.ingest(wl) and net.advance(4)
    assert net._service.device.type == "cpu"
    assert net.service_result().t_deliver.shape == (wl.num_packets,)


def test_simulate_eqo_runs_where_it_is_told():
    """``simulate_eqo`` computes on the device it is given and returns
    Python floats in the reference's dict."""
    out = Q.simulate_eqo(50, total_ns=2_000, device="cpu")
    assert set(out) == {"update_interval_ns", "err_max_bytes",
                        "err_mean_bytes"}
    assert all(isinstance(out[k], float) for k in out if k.startswith("err"))


@pytest.mark.parametrize("arch", list_archs())
def test_build_model_accepts_every_config(arch):
    """Every config of the port builds, and its full-size parameters (made
    on the ``meta`` device, without storage) number what the reference's
    analytic count says, norm scales aside."""
    cfg = get_config(arch)
    model = build_model(cfg)
    params = stacks.Stack(model.cfg, device="meta")
    n = {name: p.numel() for name, p in params.named_parameters()}
    norms = sum(v for k, v in n.items() if k.endswith(("scale", "_norm")))
    assert sum(n.values()) - norms == count_params(cfg)


def test_misshaped_masks_raise():
    """Failure and control masks that do not cover the run (slices or
    ToRs) raise ``ValueError`` before the run starts, as in the
    reference."""
    tables, wl = _small_run_inputs()
    N = tables.conn.shape[1]
    cfg = Q.FabricConfig(slice_bytes=4_000)
    bad_failures = [Q.FailureMasks.healthy(3, N), Q.FailureMasks.healthy(4, N + 1),
                    Q.FailureMasks(np.ones((4, N, N), np.float32),
                                   np.ones((4, N - 1), bool))]
    for m in bad_failures:
        with pytest.raises(ValueError, match="do not cover"):
            Q.simulate(tables, wl, cfg, 4, failures=m, device="cpu")
    good = Q.ControlMasks.perfect(4, N)
    for m in (Q.ControlMasks.perfect(5, N), Q.ControlMasks.perfect(4, N - 1),
              Q.ControlMasks(good.skew_ns, good.phase_off[:, :1],
                             good.skew_miss, good.ctrl_delay, good.ctrl_ok)):
        with pytest.raises(ValueError, match="do not cover"):
            Q.simulate(tables, wl, cfg, 4, control=m, device="cpu")
    Q.simulate(tables, wl, cfg, 4, failures=Q.FailureMasks.healthy(4, N),
               control=good, device="cpu")


def test_ported_entry_points_present_and_run():
    """What is ported works, never a stub: the reconfigure loop and the
    device compiler, also behind ``compile_impl="jnp"`` and
    ``repair(impl="jnp")`` (ROADMAP Queue 1 item 6), the scenario sweeps
    ``simulate_fleet`` and ``reconfigure_fleet`` and the sharded entry
    point ``simulate_sharded`` (item 9) are present and run; the sweep of
    the loop equals its solo runs, the 2-rank run the one-device run."""
    sched = Q.round_robin(6, 1)
    host = Q.vlb(sched)
    dev = Q.vlb(sched, compile_impl="jnp", device="cpu")
    for name in ("tf_next", "tf_dep", "inj_next", "inj_dep"):
        np.testing.assert_array_equal(getattr(dev, name), getattr(host, name))
    failed = np.zeros((6, 6), bool)
    failed[1, 2] = True
    np.testing.assert_array_equal(
        Q.repair(sched, "hoho", failed, impl="jnp", device="cpu").tf_next,
        Q.repair(sched, "hoho", failed).tf_next)
    tables, wl = _small_run_inputs()
    res = Q.reconfigure(sched, wl, Q.FabricConfig(slice_bytes=4_000),
                        Q.ReconfigConfig(epoch_slices=2, num_epochs=2,
                                         k_hot=1), device="cpu")
    assert isinstance(res, Q.ReconfigResult)
    assert res.delivered_bytes.shape == (4,)
    assert res.epoch_conn.shape == (2, 6, 6, 1)    # 5 base + 1 hot slice
    fleet = Q.simulate_fleet(tables, [wl, wl], Q.FabricConfig(), 4,
                             device="cpu")
    assert len(fleet) == 2 and fleet[1].t_deliver.shape == wl.src.shape
    rk = Q.ReconfigConfig(epoch_slices=2, num_epochs=2, k_hot=1)
    sweep = Q.reconfigure_fleet(sched, [wl, wl], Q.FabricConfig(
        slice_bytes=4_000), rk, device="cpu")
    assert len(sweep) == 2
    for r in sweep:
        np.testing.assert_array_equal(r.t_deliver, res.t_deliver)
        np.testing.assert_array_equal(r.epoch_conn, res.epoch_conn)
    cfg = Q.FabricConfig(slice_bytes=4_000)
    sharded = Q.simulate_sharded(tables, wl, cfg, 4, num_shards=2,
                                 device="cpu")
    one = Q.simulate(tables, wl, cfg, 4, device="cpu")
    for name in ("t_deliver", "loc_final", "nhops", "delivered_bytes",
                 "buf_bytes", "reorder_cnt"):
        np.testing.assert_array_equal(getattr(sharded, name),
                                      getattr(one, name), err_msg=name)


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


FLASH_HEADS = dict(n_q_heads=4, n_kv_heads=2)
DECODE_HEADS = dict(n_q_heads=4, n_kv_heads=2)


def _flash_args(device):
    bf = dict(dtype=torch.bfloat16, device=device)
    return (torch.zeros(8, 5, 64, **bf), torch.zeros(4, 7, 64, **bf),
            torch.zeros(4, 7, 64, **bf))


def _decode_args(device):
    bf = dict(dtype=torch.bfloat16, device=device)
    return (torch.zeros(2, 4, 64, **bf), torch.zeros(2, 9, 2, 64, **bf),
            torch.zeros(2, 9, 2, 64, **bf),
            torch.zeros(2, 9, dtype=torch.int32, device=device), 3)


def _rg_lru_args(device):
    return (torch.zeros(2, 5, 8, device=device),
            torch.zeros(2, 5, 8, device=device))


def _call_lm_wrappers(device):
    """Call each language-model kernel wrapper once; returns the errors."""
    calls = [lambda: Q_fa.flash_attention(*_flash_args(device), **FLASH_HEADS),
             lambda: Q_da.decode_attention(*_decode_args(device),
                                           **DECODE_HEADS),
             lambda: Q_rl.rg_lru(*_rg_lru_args(device))]
    errors = []
    for call in calls:
        try:
            call()
        except (RuntimeError, ValueError) as e:
            errors.append(e)
    return errors


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
    monkeypatch.setattr(Q_fa, "flash_attention_plain", plain)
    monkeypatch.setattr(Q_da, "decode_attention_plain", plain)
    monkeypatch.setattr(Q_rl, "rg_lru_plain", plain)
    monkeypatch.setattr(Q_gmm, "grouped_matmul_plain", plain)


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


def test_lm_wrappers_raise_without_kernel_library(monkeypatch,
                                                  no_kernel_library):
    """The same for the language-model kernels: ``meta`` tensors pass the
    device and input checks and reach the build, which raises."""
    for mod in (Q_fa, Q_da, Q_rl):
        monkeypatch.setattr(mod, "_require_cuda", lambda *a: None)
    counts = (Q_fa.launches, Q_da.launches, Q_rl.launches)
    errors = _call_lm_wrappers("meta")
    assert len(errors) == 3
    assert all(isinstance(e, RuntimeError) and "nvcc not found" in str(e)
               for e in errors), errors
    assert (Q_fa.launches, Q_da.launches, Q_rl.launches) == counts


def test_lm_wrappers_refuse_non_cuda_devices(no_kernel_library):
    errors = _call_lm_wrappers("meta")
    assert len(errors) == 3
    assert all(isinstance(e, ValueError) and "CUDA" in str(e)
               for e in errors), errors


def test_lm_wrappers_validate_kernel_inputs():
    q, k, v = _flash_args("cpu")
    Q_fa._check(q, k, v, 4, 2)
    bad = [
        ((q.float(), k, v), 4, 2),                      # dtype
        ((q, k[:3], v[:3]), 4, 2),                      # kv rows != B * Hkv
        ((q, k, v), 4, 3),                              # Hq % Hkv
        ((q[..., :48], k[..., :48], v[..., :48]), 4, 2),  # head dim not built
        ((q.transpose(1, 2), k, v), 4, 2),              # layout / shape
        ((q, k, v[:, :6]), 4, 2),                       # k, v shapes differ
    ]
    for args, hq, hkv in bad:
        with pytest.raises(ValueError):
            Q_fa._check(*args, hq, hkv)
    q, kc, vc, pos, _ = _decode_args("cpu")
    Q_da._check(q, kc, vc, pos, 4, 2)
    bad = [
        ((q.float(), kc, vc, pos), 4, 2),               # dtype
        ((q, kc, vc, pos.long()), 4, 2),                # pos dtype
        ((q, kc, vc, pos[:, :8]), 4, 2),                # pos shape
        ((q, kc, vc, pos), 4, 1),                       # Kv
        ((q[..., :60], kc[..., :60].contiguous(),
          vc[..., :60].contiguous(), pos), 4, 2),       # hd % 8
        ((q, kc.transpose(1, 2), vc, pos), 4, 2),       # layout
    ]
    for args, hq, hkv in bad:
        with pytest.raises(ValueError):
            Q_da._check(*args, hq, hkv)
    a, b = _rg_lru_args("cpu")
    Q_rl._check(a, b)
    for args in [(a.double(), b.double()), (a, b[:, :4]), (a[0], b[0]),
                 (a.transpose(1, 2), b.transpose(1, 2))]:
        with pytest.raises(ValueError):
            Q_rl._check(*args)


def _gmm_args(device, dtype=torch.bfloat16):
    return (torch.zeros(3, 5, 24, dtype=dtype, device=device),
            torch.zeros(3, 24, 16, dtype=dtype, device=device))


def test_grouped_matmul_raises_without_kernel_library(monkeypatch,
                                                      no_kernel_library):
    monkeypatch.setattr(Q_gmm, "_require_cuda", lambda *a: None)
    count = Q_gmm.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        Q_gmm.grouped_matmul(*_gmm_args("meta"))
    assert Q_gmm.launches == count


def test_grouped_matmul_refuses_non_cuda_devices(no_kernel_library):
    with pytest.raises(ValueError, match="CUDA"):
        Q_gmm.grouped_matmul(*_gmm_args("meta"))


def test_grouped_matmul_validates_kernel_inputs():
    x, w = _gmm_args("cpu")
    Q_gmm._check(x, w)
    bad = [
        (x, w[:2]),                                     # groups differ
        (x, w[:, :20]),                                 # K differs
        (x[0], w[0]),                                   # not grouped
        (x.transpose(1, 2).contiguous().transpose(1, 2), w),   # layout
        (x, w.half()),                                  # w dtype
    ]
    for args in bad:
        with pytest.raises(ValueError):
            Q_gmm._check(*args)
    with pytest.raises(ValueError, match="float32"):
        Q_gmm._check(*_gmm_args("cpu", torch.float32))


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
        == {"time_flow_lookup", "admission", "flash_attention",
            "decode_attention", "rg_lru", "grouped_matmul"}


def test_library_name_follows_headers(monkeypatch, tmp_path):
    """An edited shared header (``csrc/*.cuh``) renames every library, so
    no stale build of a source that includes it is loaded."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// one\n")
    first = _build.library_path("k")
    header.write_text("// two\n")
    assert _build.library_path("k") != first
    assert (ROOT / "src" / "repro_torch" / "csrc" / "hopper.cuh").exists()
