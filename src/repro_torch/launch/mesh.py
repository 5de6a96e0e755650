"""Production meshes (the counterpart of ``repro.launch.mesh``): each a
``torch.distributed.device_mesh.DeviceMesh`` over the process group that
is live. Functions, not module constants: importing this module touches
no process group.

The spec functions of :mod:`repro_torch.distributed.sharding` also take a
plain description of a mesh, :class:`MeshShape` (axis names and sizes,
defined in :mod:`repro_torch.distributed.mesh` and re-exported here), so
the sharding rules can be used and tested without a process group.
"""
from __future__ import annotations

from ..distributed.mesh import MeshShape, mesh_axes

__all__ = ["MeshShape", "make_production_mesh", "make_mesh",
           "make_smoke_mesh", "production_shape", "mesh_axes"]


def production_shape(multi_pod: bool = False) -> MeshShape:
    """Single pod: 16 x 16 = 256 devices (data, model). Multi-pod: 2 pods x
    256 (pod, data, model); the pod axis crosses the optical fabric."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the live default
    process group, whose size must be the mesh's. ``device_type``: "cuda"
    when the backend is NCCL, else "cpu" (a gloo group of ranks on the CPU,
    or the fake group of the dry run), unless given."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "torch.distributed.init_process_group first")
    ms = MeshShape(tuple(axes), tuple(int(s) for s in shape))
    if ms.size != dist.get_world_size():
        raise ValueError(f"a mesh of {shape} needs {ms.size} ranks, the "
                         f"process group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, ms.sizes, mesh_dim_names=ms.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """The production mesh (:func:`production_shape`) over the live
    process group of 256 or 512 ranks."""
    ms = production_shape(multi_pod)
    return make_mesh(ms.sizes, ms.axis_names, device_type)


def make_smoke_mesh(device_type: str | None = None):
    """A one-device mesh with the production axis names."""
    return make_mesh((1, 1), ("data", "model"), device_type)
