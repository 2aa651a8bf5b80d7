"""Build the CUDA sources under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own, at first use, into
``build/lib<name>-<digest>.so`` beside this file (the directory is listed in
``.gitignore``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/lib<name>-<digest>.so csrc/<name>.cu

The digest covers the source, the shared headers and the flags, so a changed
source never loads a stale library.  The libraries expose a plain C interface
(no PyTorch headers, which keeps each build to seconds); a wrapper passes
``data_ptr()`` pointers and PyTorch's current stream, and every C entry
returns ``cudaGetLastError()``, which :func:`check` turns into an exception.
``build_all`` starts one ``nvcc`` per source at once, and counts each
library it builds in ``BUILDS`` (source name -> builds in this process;
``repro_torch.obs.kernel_stats`` reads it).

The kernels are compiled for ``sm_90a`` only, so loading refuses any device
whose compute capability is not (9, 0).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
REQUIRED_CAPABILITY = (9, 0)

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILDS: Dict[str, int] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH); the CUDA "
            "toolkit is needed to build the port's kernels"
        )
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile every source (or ``names``) that has no current library, one
    ``nvcc`` process per source, all started together.  Returns each built
    source's compiler log (ptxas register and shared-memory report); raises
    with the log of any source that fails."""
    names = list(kernel_names() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        BUILDS[name] = BUILDS.get(name, 0) + 1
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def check_device(device: Optional[torch.device] = None) -> None:
    """Raise unless ``device`` is a Hopper card (compute capability 9.0)."""
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{cap[0]}.{cap[1]}; the port's kernels are built for sm_90a "
            "(H100/H200) only"
        )


def _load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def function(lib_name: str, fn_name: str, argtypes: Sequence, device: torch.device):
    """The C entry ``fn_name`` of ``csrc/<lib_name>.cu`` with its argument
    types declared, after checking ``device``; builds the library first if
    needed."""
    key = (lib_name, fn_name)
    with _LOCK:
        fn = _FUNCS.get(key)
        if fn is None:
            check_device(device)
            fn = getattr(_load(lib_name), fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[key] = fn
    return fn


def check(rc: int, lib_name: str, what: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if rc != 0:
        msg = _LIBS[lib_name].repro_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

