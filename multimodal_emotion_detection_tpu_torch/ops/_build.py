"""Build the CUDA sources under ``csrc/`` with nvcc and bind them by ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared
library under ``build/torch_kernels/`` at the root of the checkout (a
directory git ignores), named by a hash of the source, the ``csrc/``
headers it includes and the flags, so an edited source or header is
rebuilt and an unchanged one is not.  The sources expose
a plain C interface: every pointer and the stream are ``void*``, and each
entry returns a CUDA error code (0 on success).  Nothing here runs when
the module is imported; a build or launch failure raises, and no caller
falls back to another implementation.

``kernel_op`` registers a serving kernel as a ``torch.library`` custom op
in the ``med_torch`` namespace: its CUDA kernel launches the ``csrc/``
kernel, its CPU kernel is the plain version, and its fake gives the
output's shape and dtype without reading storage, so ``torch.export``
traces the model with the op as one node.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
OPS_NAMESPACE = "med_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under /usr/local/cuda): "
            "the CUDA kernels cannot be built"
        )
    return nvcc


def _sources(path: Path, seen: List[Path]) -> List[Path]:
    """``path`` and every ``#include "..."`` of a file under ``csrc/`` it
    reaches, depth first, each once."""
    if path in seen:
        return seen
    seen.append(path)
    for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M):
        if (CSRC / name).exists():
            _sources(CSRC / name, seen)
    return seen


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    the headers it includes and the flags, so an edited header rebuilds."""
    digest = hashlib.sha256()
    for src in _sources(CSRC / f"{name}.cu", []):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source not built yet, all nvcc runs at once.

    Returns ``{name: nvcc output}`` for the sources compiled by this call;
    the output holds ptxas's register, shared-memory and spill report.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, proc, tmp, out))
    reports: Dict[str, str] = {}
    failed: List[str] = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


class CudaKernel:
    """One C entry point of a ``csrc/`` library.

    ``launches`` counts the launches that returned success, and nothing
    else: a run can read it to show that its path went through the kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: List[type]):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._err_str = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err_str = getattr(lib, f"{self.source}_error_string")
            err_str.argtypes = [ctypes.c_int]
            err_str.restype = ctypes.c_char_p
            self._err_str = err_str
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} failed: {self._err_str(err).decode()} "
                f"(code {err})"
            )
        self.launches += 1


def stream_of(tensor: torch.Tensor) -> int:
    """The current CUDA stream of ``tensor``'s device, as an address."""
    return torch.cuda.current_stream(tensor.device).cuda_stream


def check_cuda_f32(name: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is float32, contiguous and on one card."""
    check_cuda(name, torch.float32, tensors)


def check_cuda(name: str, dtype: torch.dtype, tensors: Dict[str, torch.Tensor]) -> None:
    """Raise unless every tensor is of ``dtype``, contiguous and on one card."""
    devices = set()
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not a CUDA card")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors lie on several cards: {devices}")


def kernel_op(name: str, schema: str, cpu: Callable, cuda: Callable,
              fake: Callable):
    """Register ``med_torch::<name>`` with ``schema`` (explicit, so no
    annotation is evaluated): ``cpu`` its CPU kernel, ``cuda`` its CUDA
    kernel, ``fake`` its fake (meta) kernel.  No other device has a
    kernel, so a tensor there raises.  The op mutates nothing and returns
    fresh tensors.  Returns the op, callable as a function."""
    op = torch.library.custom_op(f"{OPS_NAMESPACE}::{name}", cpu, mutates_args=(),
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op
