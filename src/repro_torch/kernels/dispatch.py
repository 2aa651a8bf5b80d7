"""Device and kernel-path resolution for the port.

Two paths, chosen by where the data lies (there is no interpreter path):

``"compiled"``
    The hand-written Hopper kernel (``kernels/csrc``), for CUDA tensors.
``"reference"``
    The plain PyTorch version beside each kernel, for CPU tensors, and for
    meta tensors inside :func:`meta_reference` (the dry run: shapes only,
    nothing computed; elsewhere a meta tensor raises).

A CUDA tensor never takes the plain version and a CPU tensor never takes the
kernel: asking for either raises instead of falling back.  A ``DTensor``
(a tensor of a mesh) raises: kernels take each rank's local shard
(``launch.meshctx.local_call``).

``resolve_device`` is the rule every entry point of the port follows: it
runs on ``cuda`` unless the caller asks for the CPU, and asking for ``cuda``
on a host without a GPU raises.

Gradients: a kernel writes its output through ``ctypes`` into a fresh
tensor, which autograd cannot see.  ``flash_sdpa`` and ``wkv6`` wrap their
launch in a ``torch.autograd.Function`` whose backward differentiates the
plain version (:func:`wants_grad` picks that route); the other kernels have
no gradient, and :func:`refuse_grad` makes them raise on a CUDA input that
needs one instead of returning a detached result.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch

KERNEL_PATHS = ("compiled", "reference")

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda", *, allow_meta: bool = False) -> torch.device:
    """``torch.device`` for ``device`` (``None`` means ``"cuda"``); raises
    when CUDA is asked for and no GPU is present.  ``allow_meta`` lets
    ``"meta"`` through, for the callers that compute nothing (parameter and
    cache shapes for the dry run); a kernel never takes it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu") and not (allow_meta and dev.type == "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev


def wants_grad(*tensors: torch.Tensor) -> bool:
    """Whether a call on ``tensors`` must be differentiable: grad mode is on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise if a kernel without a gradient is asked for one: a CUDA input
    that requires grad, under grad mode.  (On the CPU the wrapper takes the
    plain version, which autograd differentiates.)"""
    if tensors[0].device.type == "cuda" and wants_grad(*tensors):
        raise RuntimeError(
            f"{kernel} has no gradient: its kernel's output is not differentiable; "
            "call it under torch.no_grad() or on inputs that do not require grad"
        )


_meta = threading.local()


@contextlib.contextmanager
def meta_reference():
    """Within it, meta tensors take the ``"reference"`` path: the dry run
    traces the plain versions' shapes on this thread, allocating nothing."""
    prev = getattr(_meta, "on", False)
    _meta.on = True
    try:
        yield
    finally:
        _meta.on = prev


def meta_traced(x: torch.Tensor) -> bool:
    """Whether ``x`` is a meta tensor inside :func:`meta_reference`."""
    return x.device.type == "meta" and getattr(_meta, "on", False)


def refuse_dtensor(*tensors) -> None:
    """Raise if a ``DTensor`` reaches a kernel wrapper: a kernel reads one
    device's memory, so it takes a rank's local shard, never a tensor of a
    mesh."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError("a DTensor reached a kernel wrapper; pass each rank's local shard "
                        "(launch.meshctx.local_call)")


def resolve_path(x: torch.Tensor, path: Optional[str] = None) -> str:
    """The kernel path for tensor ``x``: ``"compiled"`` on CUDA,
    ``"reference"`` on CPU (and on meta inside :func:`meta_reference`).  An
    explicit ``path`` must agree with the tensor's device."""
    if path is not None and path not in KERNEL_PATHS:
        raise ValueError(f"unknown kernel path {path!r}; use one of {KERNEL_PATHS}")
    refuse_dtensor(x)
    if x.device.type == "cuda":
        resolved = "compiled"
    elif x.device.type == "cpu" or meta_traced(x):
        resolved = "reference"
    else:
        raise ValueError(f"unsupported device {x.device}")
    if path is not None and path != resolved:
        raise ValueError(
            f"path {path!r} requested for a tensor on {x.device}; "
            f"{x.device.type} tensors take the {resolved!r} path"
        )
    return resolved
