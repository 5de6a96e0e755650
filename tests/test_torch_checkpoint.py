"""The port's checkpoints on the CPU: ``tests/test_checkpoint.py``'s cases
on ``repro_torch.checkpoint``, checkpoints crossing between the two
packages bit for bit (the shard files byte for byte), and the port's
trainer crashed and resumed ending bit-identical to its uninterrupted run
(torch on the CPU is deterministic, so the port holds what the reference's
test holds within 2e-2)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as R_ckpt  # noqa: E402
from repro import optim as R_opt  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config as Q_get_config  # noqa: E402
from repro_torch.launch.steps import opt_init  # noqa: E402
from repro_torch.optim import tree_items  # noqa: E402
from repro_torch.launch.train import load_state, train, train_state  # noqa: E402
from test_torch_train import carried  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402, F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.tensor(rng.normal(size=(8, 4)),
                                     dtype=torch.float32),
                   "b": torch.tensor(rng.normal(size=(4,))).to(torch.bfloat16)},
        "opt": {"mu": {"w": torch.zeros(8, 4)},
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def test_roundtrip_bitwise(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree()
    ckpt.save(d, 10, tree, n_shards=3, extra={"arch": "olmo-1b"})
    step, out, extra = ckpt.restore(d, tree)
    assert step == 10 and extra["arch"] == "olmo-1b"
    for k in ("w", "b"):
        assert out["params"][k].dtype == tree["params"][k].dtype
        assert torch.equal(out["params"][k], tree["params"][k])
    assert int(out["opt"]["step"]) == 7
    assert out["opt"]["step"].dtype == torch.int32


def test_uncommitted_checkpoint_ignored(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, _tree())
    torn = os.path.join(d, "step_00000009")     # a torn save: no COMMITTED
    os.makedirs(torn)
    with open(os.path.join(torn, "shard_0.msgpack"), "wb") as f:
        f.write(b"garbage")
    assert ckpt.latest_step(d) == 5
    assert ckpt.restore(d, _tree())[0] == 5


def test_keep_last_cleanup(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, _tree(), keep_last=2)
    assert len([n for n in os.listdir(d) if n.startswith("step_")]) == 2
    assert ckpt.latest_step(d) == 5


def test_missing_leaf_raises(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError):
        ckpt.restore(d, {"a": torch.zeros(2), "b": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"a": torch.zeros(2)})


def _states():
    """One training state in both packages' forms: the reference's
    ``{"params", "opt"}`` (bfloat16 parameters, float32 ``mu`` / ``nu``
    drawn from a seed, int32 ``step``) and the port's parameters and
    optimizer state holding the same values."""
    cfg, rp, qp = carried("gemma2-9b", "bf16")
    rng = np.random.default_rng(9)
    ropt = R_opt.adamw_init(rp)
    ropt["mu"] = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32),
        ropt["mu"])
    ropt["nu"] = jax.tree.map(
        lambda x: jnp.asarray(rng.random(x.shape), jnp.float32), ropt["nu"])
    ropt["step"] = jnp.asarray(17, jnp.int32)
    qcfg = Q_get_config("gemma2-9b").reduced()
    state = {"params": rp, "opt": ropt}
    qopt = load_state(qcfg, qp, jax.tree.map(
        lambda x: torch.tensor(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else
            torch.int32 if x.dtype == jnp.int32 else torch.float32), state))
    return qcfg, state, qp, qopt


def _assert_bits(qtree, rtree):
    qflat = dict(tree_items(qtree))
    rflat = jax.tree_util.tree_flatten_with_path(rtree)[0]
    assert len(qflat) == len(rflat)
    for path, r in rflat:
        q = qflat[tuple(k.key for k in path)]
        r = np.asarray(r)
        if r.dtype.name == "bfloat16":
            assert q.dtype == torch.bfloat16
            np.testing.assert_array_equal(q.view(torch.int16).numpy(),
                                          r.view(np.int16))
        else:
            np.testing.assert_array_equal(q.numpy(), r)


def test_checkpoints_cross_between_packages_bit_for_bit(tmp_path):
    """The reference saves and the port restores, the port saves and the
    reference restores: every leaf bit-identical, and the two packages
    write the same bytes."""
    qcfg, rstate, qp, qopt = _states()
    qstate = train_state(qcfg, qp, qopt)
    R_ckpt.save(str(tmp_path / "r"), 3, rstate, extra={"arch": "gemma2"})
    ckpt.save(str(tmp_path / "q"), 3, qstate, extra={"arch": "gemma2"})
    for name in sorted(os.listdir(tmp_path / "r" / "step_00000003")):
        a = (tmp_path / "r" / "step_00000003" / name).read_bytes()
        b = (tmp_path / "q" / "step_00000003" / name).read_bytes()
        assert a == b, name
    step, got, extra = ckpt.restore(str(tmp_path / "r"), qstate)
    assert step == 3 and extra == {"arch": "gemma2"}
    _assert_bits(got, rstate)
    step, back, _ = R_ckpt.restore(str(tmp_path / "q"), rstate)
    assert step == 3
    _assert_bits(qstate, back)
    # and into the port's own tensors
    fresh = opt_init(qp)
    restored = load_state(qcfg, qp, got)
    for k in ("mu", "nu"):
        for n, x in restored[k].items():
            assert torch.equal(x, qopt[k][n]) and x.shape == fresh[k][n].shape


def test_trainer_crash_restart_resumes_identically(tmp_path):
    """A failure injected at step 7, a resume from the step-6 checkpoint:
    the final parameters equal the uninterrupted run's bit for bit."""
    kw = dict(arch="olmo-1b", preset="tiny", steps=9, global_batch=4, seq=32,
              micro_batches=1, ckpt_every=3, seed=3, device="cpu",
              log_every=100)
    ref = train(ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        train(ckpt_dir=str(tmp_path / "b"), fail_at_step=7, **kw)
    assert ckpt.latest_step(str(tmp_path / "b")) == 6
    out = train(ckpt_dir=str(tmp_path / "b"), resume=True, **kw)
    assert [h["step"] for h in out["history"]] == [6, 7, 8]
    assert [h["loss"] for h in out["history"]] == \
        [h["loss"] for h in ref["history"][6:]]
    a = dict(ref["params"].named_parameters())
    b = dict(out["params"].named_parameters())
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n
