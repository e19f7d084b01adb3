"""nvcc builds of the port's CUDA sources (csrc/*.cu) into shared libraries
with a plain C interface, loaded with ctypes by the op modules.

Each source builds at first use into build/point_teacher_torch/ for sm_90a
(Hopper); a library newer than its source is reused.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "point_teacher_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build(source: Path, library: Path, ptxas_verbose: bool = False) -> str:
    """Compile `source` into `library` unless the library is newer. Returns
    nvcc's output (with -Xptxas -v: registers, shared memory and spills)."""
    if (not ptxas_verbose and library.exists()
            and library.stat().st_mtime >= source.stat().st_mtime):
        return ""
    library.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=library.parent)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
           "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, library)
    return proc.stdout + proc.stderr
