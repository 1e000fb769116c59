"""Build and load the port's CUDA kernels.

`library()` compiles every `ignnition_tpu_torch/csrc/*.cu` with nvcc for
Hopper (`-gencode arch=compute_90a,code=sm_90a`), one nvcc per source and all
started together, links the objects into one shared library with a plain C
interface, at first use, and loads it with ctypes. The library goes
into `ignnition_tpu_torch/_build/` (listed in .gitignore) under a name that
hashes the sources and flags, so an edit rebuilds and an unchanged tree
reuses the earlier build. Nothing is built when the module is imported.

Each C entry takes device pointers, sizes, a dtype code and the CUDA stream,
launches on that stream without synchronizing, and returns
`cudaGetLastError()`; `check()` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-Xcompiler", "-fPIC",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# storage types of an incidence matrix (kernels D and E)
INCIDENCE_DTYPE_CODES = {torch.bfloat16: 1, torch.int8: 2}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output of the last build in this process (ptxas -v)
build_seconds: Optional[float] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc was not found (PATH, CUDA_HOME, /usr/local/cuda); the CUDA "
        "kernels of ignnition_tpu_torch cannot be built"
    )


def _sources():
    srcs = sorted(SOURCE_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SOURCE_DIR}")
    return srcs, sorted(SOURCE_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libignnition_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    srcs, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{out.name}.{os.getpid()}"
    objects = [BUILD_DIR / f"{stem}.{s.stem}.o" for s in srcs]
    tmp = BUILD_DIR / f"{stem}.tmp"
    t0 = time.perf_counter()
    try:
        compiles = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(SOURCE_DIR), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(srcs, objects)
        ]
        logs = [p.communicate()[0] for p in compiles]
        build_log = "".join(logs)
        failed = [str(s) for s, p in zip(srcs, compiles) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{build_log}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True,
        )
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link the kernel library:\n{build_log}")
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
        build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.ign_csr_segment_sum.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
            lib.ign_csr_segment_sum.restype = i32
            lib.ign_masked_gru_scan.argtypes = (
                [ptr] * 7 + [i32] * 5 + [ptr]
            )
            lib.ign_masked_gru_scan.restype = i32
            lib.ign_masked_gru_scan_bwd.argtypes = (
                [ptr] * 15 + [i32] * 9 + [ptr]
            )
            lib.ign_masked_gru_scan_bwd.restype = i32
            lib.ign_masked_gru_scan_bwd_smem.argtypes = [i32] * 4
            lib.ign_masked_gru_scan_bwd_smem.restype = ctypes.c_longlong
            lib.ign_flash_gat_fwd.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
            lib.ign_flash_gat_fwd.restype = i32
            lib.ign_flash_gat_bwd.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
            lib.ign_flash_gat_bwd.restype = i32
            _lib = lib
        return _lib


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError {code}"
        )


def check_device(t: torch.Tensor, name: str) -> None:
    """Kernels launch on the current device; refuse a tensor elsewhere."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(
            f"{name}: tensor on {t.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
