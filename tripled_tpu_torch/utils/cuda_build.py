"""Build CUDA sources with nvcc into a shared library with a plain C
interface, and load it with ctypes.

The library goes to `build/tripled_tpu_torch/` at the repository root under
a name that carries a hash of the sources and flags, so an edited source
builds anew and an unchanged one is reused. No PyTorch headers, no ninja.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "tripled_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, /usr/local/cuda/bin or PATH, in that order."""
    dirs = []
    if os.environ.get("CUDA_HOME"):
        dirs.append(os.path.join(os.environ["CUDA_HOME"], "bin"))
    dirs += ["/usr/local/cuda/bin", os.environ.get("PATH", "")]
    nvcc = shutil.which("nvcc", path=os.pathsep.join(dirs))
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin or PATH: "
            "the CUDA kernels of tripled_tpu_torch need the CUDA toolkit"
        )
    return nvcc


def library_path(name: str, sources: Sequence[Path]) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[Path]) -> Path:
    """Compile `sources` into one shared library unless it is already built.
    The compiler's output (ptxas register and spill counts) is kept beside
    the library as a .log file."""
    out = library_path(name, sources)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build if needed, then load."""
    return ctypes.CDLL(str(build(name, sources)))
