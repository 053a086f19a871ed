"""Build CUDA sources with nvcc, and host C++ sources with g++, into a
shared library with a plain C interface, and load it with ctypes.

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
# the JAX package's flags for its host loader (`tripled_tpu/data/native_loader.py`)
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

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


def library_path(name: str, sources: Sequence[Path], flags: Sequence[str] = NVCC_FLAGS) -> Path:
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _compile(out: Path, compiler: str, flags: Sequence[str], sources: Sequence[Path],
             libs: Sequence[str] = ()) -> Path:
    """Run the compiler into a temporary file beside `out`, keep its output
    as `out`'s .log file, and move the library into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, sources), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def build(name: str, sources: Sequence[Path]) -> Path:
    """Compile CUDA `sources` into one shared library unless it is already
    built. The compiler's output (ptxas register and spill counts) is kept
    beside the library as a .log file."""
    out = library_path(name, sources)
    if out.exists():
        return out
    return _compile(out, find_nvcc(), NVCC_FLAGS, sources)


def host_library_path(name: str, sources: Sequence[Path], libs: Sequence[str]) -> Path:
    return library_path(name, sources, (*GXX_FLAGS, *libs))


def build_host(name: str, sources: Sequence[Path], libs: Sequence[str]) -> Path:
    """Compile host C++ `sources` with g++ and link `libs` (e.g. "-lpng"),
    unless the library is already built. Raises RuntimeError when g++ is
    missing or fails (a missing header or library shows in the message)."""
    out = host_library_path(name, sources, libs)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the host loader needs it")
    return _compile(out, gxx, GXX_FLAGS, sources, libs)


def load(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build if needed, then load."""
    return ctypes.CDLL(str(build(name, sources)))
