"""nvcc builds of the port's CUDA sources (csrc/*.cu) into shared libraries
with a plain C interface, loaded with ctypes by the op modules.

Each source builds at first use into build/point_teacher_torch/ for sm_90a
(Hopper); a library newer than its source and the shared headers
(csrc/*.cuh) is reused.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

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
    newest = max(p.stat().st_mtime for p in (source, *CSRC.glob("*.cuh")))
    if not ptxas_verbose and library.exists() and library.stat().st_mtime >= newest:
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


# The forward kernels read and write 16-byte channel vectors (csrc/vec16.cuh).
VECTOR_CHANNELS = 8


def check_vectors(feat: torch.Tensor, op: str) -> None:
    """Raise ValueError unless the forward kernels can take feat [B, H, W, C]:
    C a multiple of VECTOR_CHANNELS and the data 16-byte aligned."""
    c = feat.shape[-1]
    if c % VECTOR_CHANNELS:
        raise ValueError(f"{op}'s CUDA kernels read {VECTOR_CHANNELS} channels a vector: "
                         f"C = {c} is not a multiple of {VECTOR_CHANNELS}")
    if feat.data_ptr() % 16:
        raise ValueError(f"{op}'s CUDA kernels read 16-byte vectors: feat must be "
                         f"16-byte aligned")


def fwd_layout(info_fn, name: str) -> dict:
    """A forward kernel's layout from its C info entry (csrc/vec16.cuh fwd_info)."""
    info = (ctypes.c_int * 6)()
    rc = info_fn(info)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")
    keys = ("rois_per_block", "threads", "static_smem_bytes", "registers",
            "local_bytes", "blocks_per_sm")
    return dict(zip(keys, info))
