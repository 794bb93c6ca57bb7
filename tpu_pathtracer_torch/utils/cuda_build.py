"""Build and load the port's CUDA kernels (no jax counterpart).

Each kernel source under `tpu_pathtracer_torch/csrc/` is compiled by
`nvcc` into a shared library with a plain C interface and loaded with
`ctypes`. The build runs at first use, from the repository's sources
only, into `build/tpu_pathtracer_torch/` at the repository root; the
library's file name carries a hash of the source, the headers of `csrc/`
and the flags, so an edited source or header is rebuilt and an unchanged
one is loaded as it is.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu_pathtracer_torch"

# -fmad=false: no contraction of a*b+c into FMA, so a kernel rounds every
# op as eager torch does. No --use_fast_math: division stays IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas=-v",
)


@dataclass(frozen=True)
class BuildResult:
    path: Path          # the shared library
    seconds: float      # time spent compiling (0 when it was built before)
    log: str            # nvcc's output of this build ("" when cached)


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit: $CUDA_HOME, then PATH, then the default
    install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(source: str) -> BuildResult:
    """Compile csrc/<source> into BUILD_DIR unless that exact build exists."""
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {src}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return BuildResult(out, seconds, proc.stdout + proc.stderr)


def load(source: str) -> ctypes.CDLL:
    """Load the library of csrc/<source>, built first if needed."""
    return ctypes.CDLL(str(build(source).path))
