"""Build and load the port's CUDA kernels: nvcc into a shared library, ctypes to call it.

Each source under `csrc/` is compiled on its own with `nvcc` (sm_90a) at
first use into `build/repro_torch/` of the checkout the package runs from,
as `lib<stem>_<hash>.so`, the hash taken over the source and the flags, so
an edited source never loads a stale library.  The kernels build only from a
checkout: an installed copy of the package raises at the build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[1]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def build_dir(source: Path) -> Path:
    """`build/repro_torch/` of the checkout: the root holding `pyproject.toml`
    and `src/repro_torch/` with the kernel's source."""
    root = PACKAGE.parents[1]
    if PACKAGE.parent.name != "src" or not (root / "pyproject.toml").is_file() \
            or not source.is_file():
        raise RuntimeError(f"{PACKAGE} is not src/repro_torch of a checkout with "
                           f"{source.name}; the CUDA kernels build only from a checkout")
    return root / "build" / "repro_torch"


def library_path(source: Path) -> Path:
    out_dir = build_dir(source)
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return out_dir / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path) -> str:
    """Compile `source` if it has not been built; return ptxas's report.

    The library is written under a temporary name and renamed into place, so
    builds of two sources may run at once and a cut build leaves no library.
    """
    out = library_path(source)
    if out.exists():
        return ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return res.stderr


def load(source: Path) -> ctypes.CDLL:
    build(source)
    return ctypes.CDLL(str(library_path(source)))


def eager(t) -> bool:
    """Whether a launch on `t` may skip its custom op and run the launch
    directly: a plain CUDA tensor (not fake, not a subclass), no dispatch mode
    on (the fake mode, the flop counter and the capture's recorder see the
    op) and no compile tracing.  The op's dispatch costs more host time than
    the launch it wraps."""
    return (type(t) is torch.Tensor and t.is_cuda and not torch._C._len_torch_dispatch_stack()
            and not torch.compiler.is_compiling())


def stream(device: torch.device) -> int:
    """The raw handle of `device`'s current CUDA stream, for a launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)
