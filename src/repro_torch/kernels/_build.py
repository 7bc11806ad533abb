"""Build the port's CUDA sources with nvcc, load them with ctypes, and
check what a wrapper hands them.

Each ``csrc/<name>.cu`` under ``repro_torch/kernels`` compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout, where
``<hash>`` covers the source, the headers beside it and the flags, so an
edited source is rebuilt and an unchanged one is not. The sources expose a
plain C interface (no PyTorch headers), which keeps a build to seconds.
``build`` starts one nvcc per missing library, all at once, and waits for
all of them; nvcc's output, with ptxas's registers, spills and shared memory
for every kernel (``-Xptxas -v``), is kept beside each library as
``lib<name>-<hash>.log``.

Every C entry takes pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()`` after its launch; :func:`check` turns a non-zero code
into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "all_sources", "build", "load", "check",
           "on_cpu", "same_device", "check_tensor", "stream", "sm_count", "copy_width"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"

_LIBS: dict[Path, ctypes.CDLL] = {}


def all_sources() -> list[Path]:
    """Every CUDA source of the port."""
    return sorted(_KERNELS_DIR.glob("**/csrc/*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the port's CUDA kernels are built on first use")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(sources: list[Path] | None = None) -> dict[Path, Path]:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Returns ``{source: library path}``."""
    sources = all_sources() if sources is None else [Path(s) for s in sources]
    targets = {src: _target(src) for src in sources}
    pending = [(src, out) for src, out in targets.items() if not out.exists()]
    if not pending:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    try:
        for src, out in pending:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failures = []
        for src, out, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failures.append(f"nvcc failed on {src} (exit {p.returncode}):\n{log}")
            else:
                out.with_suffix(".log").write_text(log)
                os.replace(tmp, out)  # atomic: a reader never sees half a library
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for _, _, tmp, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            tmp.unlink(missing_ok=True)
    return targets


def load(src: Path, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``src`` (built if needed), with ``argtypes``
    set from ``signatures`` and ``restype`` int for every named entry."""
    src = Path(src)
    lib = _LIBS.get(src)
    if lib is None:
        lib = ctypes.CDLL(str(build([src])[src]))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[src] = lib
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then takes its
    plain version), False when all lie on one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def same_device(*tensors: torch.Tensor) -> torch.device:
    """The one device of ``tensors``; raises ``ValueError`` when they lie on
    more than one."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    return devices.pop()


def check_tensor(name: str, t: torch.Tensor, shape: tuple,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` has this dtype and shape and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def copy_width(row: int, *addresses: int) -> int:
    """Floats a kernel moves in one load, copy or store: 4 (16 bytes) when
    every row of ``row`` floats and every address is 16-byte aligned, else 1
    (4 bytes; a row of 130 floats, for one, is 520 bytes)."""
    return 4 if row % 4 == 0 and all(p % 16 == 0 for p in addresses) else 1
