"""The city-scale serving mesh: the devices the sharded data plane
(:class:`repro_torch.fleet.FleetPlane`) spreads streams over.

The counterpart of ``repro.launch.mesh.make_fleet_mesh``.  A JAX mesh names
its devices along one ``"shard"`` axis; here the mesh is simply the ordered
list of ``torch.device``s, shard ``s`` on ``devices[s]``.  None of the JAX
module's production-mesh shapes or its per-chip constants carry over: they
describe a TPU pod, not a GPU host.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.kernels.dispatch import DeviceLike, resolve_device


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
