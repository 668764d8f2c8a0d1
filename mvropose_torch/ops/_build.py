"""Build `csrc/*.cu` with nvcc into one shared library and load it with ctypes.

The kernels expose plain C entry points (no PyTorch headers), so a build
takes seconds. The library goes to `build/mvropose_torch/` at the repository
root, named by a hash of the sources and flags: an edited `.cu` rebuilds, an
unchanged one loads the existing file. nvcc's output (with `-Xptxas -v`:
registers, shared memory and spills per kernel) is kept beside the library
as `<name>.log`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mvropose_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin, else under the toolkit root
    torch finds (it also looks at /usr/local/cuda), for an environment whose
    PATH lacks the toolkit."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels of "
        "mvropose_torch need the CUDA toolkit to build"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmvropose_torch_{digest.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    lib = library_path()
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in sorted(CSRC_DIR.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        lib.with_name(lib.name + ".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}: {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return ctypes.CDLL(str(lib))
