"""Meshes: the production training / serving mesh of ``torch.distributed``
ranks, the logical-axis mapping the model code constrains against, and the
city-scale serving mesh of the fleet (``repro.launch.mesh``).

The production mesh keeps the JAX package's axis names and device counts
(256 ranks as ``("data", "model")``, 512 as ``("pod", "data", "model")``)
but takes its shape from a GPU cluster, not a TPU pod: the DGX SuperPOD
reference architecture's DGX H100 scalable unit, 32 nodes of 8 GPUs.  So
``model`` is the 8 GPUs of one node (one NVLink domain) and ``data`` the 32
nodes (InfiniBand); a multi-pod mesh is two such units.  A mesh is a
``torch.distributed.DeviceMesh``, or, where only the rules are wanted (no
process group), a :class:`MeshShape` with the same names and sizes.

The fleet's mesh is simply the ordered list of ``torch.device``s its shards
live on (``make_fleet_mesh``).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels.dispatch import DeviceLike, resolve_device

AxisVal = Union[None, str, Tuple[str, ...]]

#: DGX H100 scalable unit (DGX SuperPOD reference architecture): 32 nodes x 8 GPUs
SINGLE_POD_SHAPE = (32, 8)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 32, 8)
MULTI_POD_AXES = ("pod", "data", "model")

#: NVLink 4 a GPU (H100 SXM data sheet): the ``model`` axis, inside one node
NVLINK_BYTES_PER_S = 900e9
#: InfiniBand NDR, 400 Gb/s a GPU (DGX H100 data sheet: one ConnectX-7 a GPU):
#: every axis that crosses nodes (``data``, ``pod``)
INFINIBAND_BYTES_PER_S = 50e9
LINK_SOURCES = {"model": "H100 SXM data sheet (NVLink 900 GB/s)",
                "other": "DGX H100 data sheet (ConnectX-7 NDR 400 Gb/s a GPU)"}


class MeshShape:
    """A mesh of named axes and sizes and no devices (``jax.sharding.
    AbstractMesh``): enough for the sharding rules and the dry run's
    arithmetic.  ``shape`` maps each axis name to its size, as a JAX
    mesh's does."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for {len(axis_names)} axis names")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def axis_sizes(mesh) -> Mapping[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or a :class:`MeshShape`."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to carry the sharding rules")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def mesh_label(mesh) -> str:
    """"32x8" / "2x32x8": the sizes in axis order."""
    return "x".join(str(s) for s in axis_sizes(mesh).values())


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ranks 0..prod(shape)-1 in row-major order, named
    ``axes``, over the default process group (which must hold at least that
    many ranks).  ``device_type`` defaults to ``cuda`` where a card is
    visible, else ``cpu`` (``gloo`` / a fake group)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= int(s)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    if dist.get_world_size() < n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the group has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(device_type or _device_type(), torch.arange(n).reshape(*shape),
                      mesh_dim_names=tuple(axes))


def production_shape(*, multi_pod: bool = False, world: Optional[int] = None
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of the production mesh.  With fewer than its ranks in
    ``world`` the ranks fold into ``data`` and the other axes are 1, as the
    JAX package's mesh degrades on a small host: every axis name, and so
    every rule, stays valid."""
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    axes = MULTI_POD_AXES if multi_pod else SINGLE_POD_AXES
    full = 1
    for s in shape:
        full *= s
    if world is not None and world < full:
        shape = (1, world, 1) if multi_pod else (world, 1)
    return tuple(shape), axes


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """The full-scale mesh over the default process group: 32 x 8 = 256
    ranks, or 2 x 32 x 8 = 512 (multi-pod), degrading to ``(world, 1)`` /
    ``(1, world, 1)`` on a smaller group (:func:`production_shape`)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    shape, axes = production_shape(multi_pod=multi_pod, world=world)
    return make_mesh(shape, axes, device_type=device_type)


def logical_axes(*, multi_pod: bool = False) -> Dict[str, AxisVal]:
    """Logical -> mesh axis mapping used by ``launch.meshctx.constrain``."""
    return {
        "batch": ("pod", "data") if multi_pod else "data",
        "model": "model",
        "expert": "model",  # expert-parallel over the model axis
        "data_only": "data",
    }


def make_fleet_mesh(
    n_shards: Optional[int] = None, *, devices: Optional[Sequence[DeviceLike]] = None
) -> List[torch.device]:
    """The plane's devices: by default every visible CUDA device (one H100:
    one shard), clamped to ``n_shards``.

    An explicit ``devices`` list may repeat a device — ``["cpu"] * 4`` or
    four times ``cuda:0`` run the shard logic on one device, as JAX's
    ``--xla_force_host_platform_device_count`` view does for ``repro``.
    Asking for more shards than devices clamps to the devices there are.
    Raises when no CUDA device is visible and no ``devices`` are given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_fleet_mesh() found no CUDA device; pass devices=['cpu'] (or a "
                "list of them) to shard on the CPU"
            )
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    n = len(devs) if n_shards is None else int(n_shards)
    if n < 1 or not devs:
        raise ValueError(f"a fleet mesh needs at least one shard, got n_shards={n_shards} "
                         f"over {len(devs)} devices")
    return devs[: min(n, len(devs))]
