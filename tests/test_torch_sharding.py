"""The model half of the port's sharding rules
(``repro_torch.distributed.sharding``) and the dry run's stand-ins
(``repro_torch.launch.steps.input_specs`` / ``cache_specs`` /
``state_specs``) against the reference's, with no process group.

* ``param_shardings`` (``fsdp`` on and off) and ``opt_state_shardings``
  (``zero`` on and off), leaf by leaf for every config, on the
  reference's forced 8-device CPU meshes (2, 4) and (2, 2, 2); the
  port's per-layer tensors take their leaf's spec without the stacked
  entry; ``_base_spec`` at model = 16.
* ``cache_shardings`` of every config's cache (KV heads or the sequence
  on "model", ``pos`` with it, recurrent states), at a batch that divides
  the data axes and one that does not; ``batch_shardings``,
  ``frontend_sharding``, ``data_axes``, ``replicated``.
* The spec -> DTensor placements conversion.
* The stand-ins' shapes and dtypes against the reference's
  ``ShapeDtypeStruct``s for a train, a prefill and a decode shape; they
  are fake tensors (no storage).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as R_config  # noqa: E402
from repro.distributed import sharding as R_S  # noqa: E402
from repro.launch import steps as R_steps  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import MeshShape, production_shape  # noqa: E402
from repro_torch.models import stacks  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.models.layers import AttnCache  # noqa: E402

MESHES = {"2x4": (("data", "model"), (2, 4)),
          "2x2x2": (("pod", "data", "model"), (2, 2, 2))}


def _norm(spec) -> tuple:
    """A PartitionSpec (or the port's tuple) as a tuple whose entries are
    None, an axis name or a tuple of names (a 1-tuple is its name)."""
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _ref_mesh(name):
    axes, shape = MESHES[name]
    n = int(np.prod(shape))
    if len(jax.devices()) < n:
        pytest.skip("needs the forced 8-device CPU mesh")
    return jax.make_mesh(shape, axes, devices=jax.devices()[:n])


def _mesh(name):
    return MeshShape(*MESHES[name])


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    return R_steps.state_specs(R_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    # shapes only: a Stack on the meta device allocates nothing
    return stacks.Stack(get_config(arch), torch.device("meta"))


def _ref_leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.multidevice
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_opt_specs_match_reference(arch):
    """Every leaf's spec equals the reference's, on both meshes, fsdp on
    and off, and the AdamW state's with zero on and off; each port tensor
    takes its leaf's spec."""
    import dataclasses
    params_s, _ = _ref_state(arch)
    params = _port_params(arch)
    for mesh_name in MESHES:
        rmesh = _ref_mesh(mesh_name)
        for fsdp in (False, True):
            rcfg = dataclasses.replace(R_config(arch), fsdp=fsdp)
            cfg = dataclasses.replace(get_config(arch), fsdp=fsdp)
            ref = R_S.param_shardings(params_s, rmesh, rcfg)
            want = {k: _norm(v.spec) for k, v in _ref_leaves(ref).items()}
            got = S.leaf_specs(params, _mesh(mesh_name), cfg)
            assert set(got) == set(want), (arch, set(got) ^ set(want))
            for key in want:
                assert _norm(got[key]) == want[key], (arch, mesh_name, fsdp,
                                                      key)
            for zero in (True, False):
                ropt = R_S.opt_state_shardings(
                    ref, params_s if zero else None, zero=zero)
                rmu = {k[len("['mu']"):]: _norm(v.spec)
                       for k, v in _ref_leaves(ropt).items()
                       if k.startswith("['mu']")}
                gmu = S.leaf_specs(params, _mesh(mesh_name), cfg, "opt",
                                   zero)
                assert {k: _norm(v) for k, v in gmu.items()} == rmu, \
                    (arch, mesh_name, fsdp, zero)
                assert _norm(ropt["step"].spec) == \
                    S.opt_state_shardings(params, _mesh(mesh_name), cfg,
                                          zero)["step"]
            # each port tensor: its leaf's spec, the stacked entry dropped
            per = S.param_shardings(params, _mesh(mesh_name), cfg)
            assert set(per) == {n for n, _ in params.named_parameters()}
            for key, lf, _ in S._leaves(params, cfg):
                for n in lf.names:
                    assert per[n] == (got[key][1:] if lf.stacked
                                      else got[key]), n
                    assert len(per[n]) == params.get_parameter(n).dim(), n


@pytest.mark.parametrize("arch", list_archs())
def test_base_spec_at_model_16(arch):
    """``_base_spec`` of every leaf at the production mesh's model = 16
    equals the reference's, and every dim it shards divides by 16 (as
    ``tests/test_distributed.py`` holds the reference)."""
    from repro_torch.distributed.sharding import _leaves
    params = _port_params(arch)
    for key, _, shape in _leaves(params, get_config(arch)):
        stacked = "['groups']" in key or "['enc_groups']" in key
        got = S._base_spec(key, shape, 16, stacked)
        assert got == _norm(R_S._base_spec(key, shape, 16, stacked)), key
        for dim, ax in enumerate(got):
            if ax == "model" and "embed" not in key and "lm_head" not in key:
                assert shape[dim] % 16 == 0, (arch, key, shape)


def _ref_cache_key(cfg, i: int) -> tuple[str, bool]:
    """The reference's cache key of the port's layer ``i`` and whether it
    is stacked over the pattern groups."""
    n_pat = len(cfg.pattern)
    base = cfg.n_groups * n_pat
    if i < base:
        j = i % n_pat
        return f"['groups']['{cfg.pattern[j]}{j}']", True
    j = i - base
    return f"['tail']['tail_{cfg.tail[j]}{j}']", False


@pytest.mark.multidevice
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_reference(arch):
    """Every cache tensor's spec equals the reference's leaf's (stacked
    entry dropped), at a batch that divides the data axes and one that
    does not, on both meshes; a ``dec`` layer's cross K/V take the k/v and
    pos rules."""
    cfg, rcfg = get_config(arch), R_config(arch)
    seq = 64
    for batch in (8, 3):
        ref_cache = R_steps.cache_specs(rcfg, batch, seq)
        cache = steps.cache_specs(cfg, batch, seq)
        for mesh_name in MESHES:
            ref = _ref_leaves(R_S.cache_shardings(ref_cache, _ref_mesh(
                mesh_name), rcfg, batch))
            got = S.cache_shardings(cache, _mesh(mesh_name), cfg, batch)
            for i, entry in enumerate(got):
                key, stacked = _ref_cache_key(cfg, i)
                if isinstance(entry, AttnCache):
                    pairs = {".k": entry.k, ".v": entry.v, ".pos": entry.pos}
                elif isinstance(entry[0], AttnCache):
                    self_c, cross = entry
                    pairs = {".k": self_c.k, ".v": self_c.v,
                             ".pos": self_c.pos}
                    ax = _mesh(mesh_name).shape
                    dp = S.data_axes(_mesh(mesh_name))
                    dps = int(np.prod([ax[a] for a in dp]))
                    k_shape = tuple(cache[i][1].k.shape)
                    assert cross.k == S._cache_spec(
                        "kv", k_shape, ax["model"], dps,
                        dp if batch % dps == 0 else None,
                        cfg.n_kv_heads % ax["model"] == 0)
                else:
                    pairs = {f"[{j}]": s for j, s in enumerate(entry)}
                for suffix, spec in pairs.items():
                    want = _norm(ref[key + suffix].spec)
                    assert _norm(spec) == (want[1:] if stacked else want), \
                        (arch, batch, mesh_name, i, suffix)


def test_cache_spec_sequence_parallel_pos():
    """Where the KV heads do not divide "model" (recurrentgemma's one KV
    head), k/v shard their sequence on model and ``pos`` with them; a
    recurrent state [B, w] shards its width."""
    cfg = get_config("recurrentgemma-9b")
    cache = steps.cache_specs(cfg, 32, 4096)
    got = S.cache_shardings(cache, production_shape(), cfg, 32)
    attn = [e for e in got if isinstance(e, AttnCache)][0]
    assert attn.k == ("data", "model", None, None) or \
        _norm(attn.k) == ("data", "model", None, None)
    assert _norm(attn.pos) == ("data", "model")
    rec = [e for e in got if not isinstance(e, AttnCache)][0]
    assert _norm(rec[0]) == ("data", "model")


@pytest.mark.multidevice
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_frontend_and_axes_match_reference(mesh_name):
    rmesh, mesh = _ref_mesh(mesh_name), _mesh(mesh_name)
    assert S.data_axes(mesh) == R_S.data_axes(rmesh)
    assert S.replicated(mesh) == _norm(R_S.replicated(rmesh).spec)
    assert _norm(S.frontend_sharding(mesh)) == \
        _norm(R_S.frontend_sharding(rmesh).spec)
    for batch in (8, 3, None):
        want = R_S.batch_shardings(rmesh, batch)
        got = S.batch_shardings(mesh, batch)
        assert set(got) == set(want)
        for k in want:
            assert _norm(got[k]) == _norm(want[k].spec), (batch, k)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert S.placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert S.placements((None, "model"), mesh) == \
        [Replicate(), Replicate(), Shard(1)]
    assert S.placements(("data",), mesh) == [Replicate(), Shard(0),
                                             Replicate()]
    assert S.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        S.placements((("data", "pod"), None), mesh)
    with pytest.raises(ValueError):
        S.placements(("model", "model"), mesh)


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, AttnCache):
        return [x.k, x.v, x.pos]
    if isinstance(x, dict):
        return [t for k in x for t in _flat(x[k])]
    return [t for e in x for t in _flat(e)]


def _same(t, s):
    return tuple(t.shape) == tuple(s.shape) and \
        str(t.dtype).removeprefix("torch.") == str(s.dtype)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "seamless-m4t-large-v2", "llava-next-34b",
                                  "recurrentgemma-9b"])
def test_input_specs_match_reference(arch, shape_name):
    """Tokens, labels, frontend embeddings, index and every cache tensor
    the reference has, with its shape and dtype; all fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensor
    cfg, shape = get_config(arch), SHAPES[shape_name]
    got = steps.input_specs(cfg, shape)
    want = R_steps.input_specs(R_config(arch), shape)
    assert all(isinstance(t, FakeTensor) for t in _flat(got))
    for k in want:
        if k == "cache":
            continue
        assert _same(got[k], want[k]), (k, got[k].shape, want[k].shape)
    if "cache" in want:
        ref = _ref_leaves(want["cache"])
        for i, entry in enumerate(got["cache"]):
            key, stacked = _ref_cache_key(cfg, i)
            ts = (entry[0] if isinstance(entry, tuple) and
                  isinstance(entry[0], AttnCache) else entry)
            names = ([".k", ".v", ".pos"] if isinstance(ts, AttnCache)
                     else [f"[{j}]" for j in range(len(ts))])
            for suffix, t in zip(names, _flat(ts)):
                s = ref[key + suffix]
                rshape = s.shape[1:] if stacked else s.shape
                assert tuple(t.shape) == tuple(rshape) and \
                    str(t.dtype).removeprefix("torch.") == str(s.dtype), \
                    (arch, i, suffix)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "xlstm-350m",
                                  "seamless-m4t-large-v2"])
def test_state_specs_match_reference(arch):
    """Every parameter leaf and the AdamW state: shapes and dtypes of the
    reference's (stacked leaves as the port's layers), as fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensor
    from repro_torch.models.model import _layout, _leaves_of
    cfg = get_config(arch)
    params, opt = steps.state_specs(cfg)
    r_params, r_opt = _ref_state(arch)
    ref = _ref_leaves(r_params)
    named = dict(params.named_parameters())
    assert all(isinstance(p, FakeTensor) for p in named.values())
    seen = 0
    for key, lf, shape in S._leaves(params, cfg):
        s = ref[key]
        assert tuple(s.shape) == shape, key
        for n in lf.names:
            assert str(named[n].dtype).removeprefix("torch.") == \
                str(s.dtype), key
            assert _same(opt["mu"][n], jax.ShapeDtypeStruct(
                named[n].shape, np.float32)) and \
                isinstance(opt["nu"][n], FakeTensor)
            seen += 1
    assert seen == len(named) and len(ref) == len(list(_leaves_of(
        _layout(cfg, params))))
    assert tuple(opt["step"].shape) == tuple(r_opt["step"].shape)
