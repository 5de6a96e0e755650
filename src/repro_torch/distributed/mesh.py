"""A mesh's axes without devices: :class:`MeshShape` (axis names and
sizes) and :func:`mesh_axes`, which reads the axes of a ``MeshShape`` or
of a ``torch.distributed.device_mesh.DeviceMesh``. The sharding rules
(:mod:`.sharding`) take either, so they can be used and tested without a
process group; :mod:`repro_torch.launch.mesh` builds the meshes
themselves."""
from __future__ import annotations

import dataclasses

__all__ = ["MeshShape", "mesh_axes"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"MeshShape: {self.axis_names} and "
                             f"{self.sizes} differ in length")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a :class:`MeshShape` or a ``DeviceMesh``
    (whose dimensions must be named)."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("a DeviceMesh without mesh_dim_names has no axes "
                         "to shard over")
    return {n: int(mesh.size(i)) for i, n in enumerate(names)}
