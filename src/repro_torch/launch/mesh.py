"""Meshes of the port (counterpart of ``repro.launch.mesh``).

Axis roles are the reference's (``runtime/sharding.py``): ``data`` is
data parallelism (and FSDP storage in training), ``model`` tensor / expert
parallelism, and a leading ``pod`` axis pure data parallelism across pods.

* ``make_host_mesh(data, model)`` -- a ``DeviceMesh`` over the running
  process group (``torch.distributed``), axes ``("data", "model")``, rank
  ``d * model + m`` at coordinates ``(d, m)``.
* ``abstract_mesh(shape, axes)`` -- axis names and sizes, with no devices
  and no process group: what the sharding rules read, so they can be
  checked at a production mesh's size on one host.
* ``make_production_mesh(multi_pod)`` -- the reference's ``(16, 16)`` pod,
  or ``(2, 16, 16)`` with a ``pod`` axis, as an abstract mesh.

``mesh_axes(mesh)`` reads the ``{name: size}`` of either kind.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

__all__ = ["AbstractMesh", "abstract_mesh", "make_production_mesh", "make_host_mesh", "mesh_axes"]


class AbstractMesh:
    """Axis names and sizes of a mesh, with no devices behind them."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes {tuple(axes)}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """(16, 16) 'data','model' per pod; (2, 16, 16) with a 'pod' DP axis.

    The reference builds these over a TPU v5e pod's 256 chips (512 for two
    pods).  No host here has that many devices, so the port returns the
    abstract mesh: the sharding rules are checked at this size against
    shape-only trees, and a run on real devices uses ``make_host_mesh``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """A ``DeviceMesh`` ``(data, model)`` over the first ``data * model``
    ranks of the running process group; every rank of the group must call
    it (ranks past the mesh get no coordinate).  ``device`` is where the
    ranks compute; the mesh's own device type follows the group's backend
    (``cuda`` under NCCL, else ``cpu``: gloo serves CUDA tensors staged
    through the host, ``runtime/collectives.py``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    kind = "cuda" if dist.get_backend() == "nccl" and str(device).startswith("cuda") else "cpu"
    ranks = torch.arange(data * model).view(data, model)
    return DeviceMesh(kind, ranks, mesh_dim_names=("data", "model"))


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    return {name: mesh.size(i) for i, name in enumerate(names)}
