"""Build the port's native batch helpers (`native/loader.cpp`, `native/aux.cpp`).

`library_path()` names the shared library for the current sources: it lives
in `BUILD_DIR` (`ignnition_tpu_torch/_build/`, listed in .gitignore, or a
per-user cache directory when the package directory cannot be written:
`utils.build_dir`) under a name that
hashes the sources and the compiler flags, so an edit rebuilds and an
unchanged tree reuses the earlier build. `build()` compiles it with g++ at
first use. Concurrent builders (test workers, reader threads) take a file
lock, so one compiles while the others wait and then find the finished
library; the compiler writes a temporary file that `os.replace` moves into
place, so no process ever loads a partial one. A missing compiler or a
failed compile raises with the compiler's output. Nothing is built when the
module is imported.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

from ..utils.build_dir import build_dir

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = _PKG_DIR / "native"
BUILD_DIR = build_dir(_PKG_DIR)
SOURCES = ("loader.cpp", "aux.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

build_seconds: Optional[float] = None  # of the compile this process ran, if any


def _compiler() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError(
            "no C++ compiler (g++, or $CXX) was found on PATH; the native batch "
            f"helpers of ignnition_tpu_torch ({SOURCE_DIR}) cannot be built"
        )
    return found


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SOURCE_DIR / name).read_bytes())
    return BUILD_DIR / f"libignnition_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists, and
    return its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp),
               *(str(SOURCE_DIR / name) for name in SOURCES)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building the native batch helpers failed ({' '.join(cmd)}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
            build_seconds = time.perf_counter() - t0
    return out
