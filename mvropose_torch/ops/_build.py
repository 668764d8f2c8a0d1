"""Build `csrc/*.cu` with nvcc into one shared library and load it with ctypes.

The kernels expose plain C entry points (no PyTorch headers), so a build
takes seconds: one nvcc per source, all started together, then one link.
The library goes to `build/mvropose_torch/` at the repository root, named by
a hash of the sources (`.cu` and the headers `.cuh` they include) and
flags: an edited source rebuilds, an unchanged one loads the existing file.
nvcc's output (with `-Xptxas -v`: registers, shared memory and spills per
kernel) is kept beside the library as `<name>.log`.

`device_context` and `current_stream` are how every wrapper reaches the
device and stream of a launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mvropose_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


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
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmvropose_torch_{digest.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    lib = library_path()
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, sources = find_nvcc(), sorted(CSRC_DIR.glob("*.cu"))
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        objs = [f"{tmp}.{src.stem}.o" for src in sources]
        cmds = [[nvcc, *COMPILE_FLAGS, "-o", obj, str(src)] for obj, src in zip(objs, sources)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]  # every compile started before any is waited for
        outs = [proc.communicate()[0] for proc in procs]
        if not any(proc.returncode for proc in procs):
            cmds.append([nvcc, *LINK_FLAGS, "-o", str(tmp), *objs])
            procs.append(subprocess.run(cmds[-1], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True, check=False))
            outs.append(procs[-1].stdout)
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
        log = "\n".join(f"$ {' '.join(cmd)}\n{out}" for cmd, out in zip(cmds, outs))
        lib.with_name(lib.name + ".log").write_text(log)
        if any(proc.returncode for proc in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return ctypes.CDLL(str(lib))


# The wrappers run up to 120 times a serve tick, whose loop the host bounds:
# they name the device by its index (`Tensor.get_device`, not a `torch.device`
# built at each access), and take the stream without the Python object
# `torch.cuda.current_stream` builds.
def device_context(index: int):
    """Device `index` made current for a launch, where it is not already
    (entering `torch.cuda.device` costs microseconds a call)."""
    if index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def current_stream(index: int) -> int:
    """Device `index`'s current stream as a raw pointer."""
    return torch._C._cuda_getCurrentRawStream(index)
