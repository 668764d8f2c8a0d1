#!/usr/bin/env python3
"""The pose step's SVD kernel of this checkout and another's, in turns.

    python3 scripts/torch_svd_turns.py OTHER_DIR

OTHER_DIR is another checkout of the port (unpack it with `git archive`
under build/). Builds both checkouts' kernels (the other's in a process of
its own, from its own root) and loads the other's library beside this
one's, calling its `small_svd_f32` by its own C arguments (the same as this
checkout's). On every shape group of `chip_smoke.SVD_GROUPS` (64 matrices,
`chip_smoke._svd_operands`) and on the DLT systems of a real fr3 RANSAC
(`chip_smoke.fr3_ransac_dlt`: the (64, 16, 12) input of the serve tick's
DLT SVD, most of it with a null space of dimension > 1):
  * both kernels by CUDA-graph replay in turns other/this/this/other, and
    each kernel's own device duration from `torch.profiler`;
  * torch.linalg.svd eager (it waits for the device) on the same input;
  * the two checkouts' outputs compared sign-free (`chip_smoke.svd_errors`,
    the other's output in the place of torch.linalg.svd's), and this one's
    against torch.linalg.svd within `chip_smoke.SVD_TOL`.
Then each library's SASS size of the kernel, and the pose step
(`recover_pose_batch` on `chip_smoke.pose_rig`, as `chip_smoke.phase_pose`
builds it) at V = 1 and 4, refine off and on, by CUDA-graph replay, in
processes of their own from each root in turns other/this/this/other.
Prints one line a comparison, then a JSON line of them all (~4 min with
both builds). Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import types
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from mvropose_torch.ops import _build, small_svd  # noqa: E402

ASK = ("from mvropose_torch.ops import _build\n"
       "_build.load_library()\n"
       "print(_build.library_path())\n")

# The pose step from a checkout's root with that checkout's package and
# chip_smoke.py: only names both checkouts have.
POSE = r"""
import dataclasses, functools, json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke
from mvropose_torch.geometry.robots import get_robot
from mvropose_torch.pose import PoseDraws, recover_pose_batch
out = {}
for views in (1, 4):
    for refine in (False, True):
        draws = PoseDraws.draw((), views, 8, 7, refine, torch.Generator().manual_seed(9))
        *args, _ = chip_smoke.pose_rig(views, 60 + views, "cuda")
        d = PoseDraws(*(None if x is None else x.to("cuda") for x in dataclasses.astuple(draws)))
        step = functools.partial(recover_pose_batch, *args, get_robot("fr3"), (720, 1280),
                                 draws=d, refine=refine)
        step()
        out[f"V={views}, refine {'on' if refine else 'off'}"] = chip_smoke.graph_ms(
            step, iters=1, samples=10 if refine else 20)
print("pose_ms", json.dumps(out))
"""


def other_library(root: Path) -> tuple:
    """The other checkout's kernels, built from its own root -> (the loaded
    library, its path)."""
    out = subprocess.run([sys.executable, "-c", ASK], cwd=root, capture_output=True, text=True,
                         timeout=900, check=False)
    if out.returncode != 0:
        raise SystemExit(f"{root}: could not build its kernels:\n{out.stderr[-4000:]}")
    path = Path(out.stdout.strip().splitlines()[-1])
    lib = ctypes.CDLL(str(path))
    lib.small_svd_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.small_svd_f32.restype = ctypes.c_int
    return lib, path


class OtherSvd:
    """The other checkout's kernel on one batch, into buffers it keeps."""

    def __init__(self, lib, a: torch.Tensor):
        self.lib, self.a = lib, a
        batch, m, n = a.shape
        self.S = torch.empty((batch, min(m, n)), device="cuda")
        self.Vh = torch.empty((batch, n, n), device="cuda")
        self.U = torch.empty((batch, 3, 3), device="cuda") if (m, n) == (3, 3) else None

    def __call__(self):
        batch, m, n = self.a.shape
        err = self.lib.small_svd_f32(self.a.data_ptr(), self.S.data_ptr(), self.Vh.data_ptr(),
                                     None if self.U is None else self.U.data_ptr(), batch, m, n,
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other checkout's small_svd_f32 returned {err}")
        return self.U, self.S, self.Vh


def kernel_us(fn, calls: int = 50) -> float:
    """The mean device duration of the kernel `fn` launches (one a call), by
    the profiler, in us."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(times) / len(times)


def pose_turns(other: Path) -> dict:
    """The pose step's replay times from each root, in turns
    other/this/this/other -> {"this": [{case: ms}, ...], "other": [...]}."""
    times = {"this": [], "other": []}
    for label in ("other", "this", "this", "other"):
        root = other if label == "other" else ROOT
        out = subprocess.run([sys.executable, "-c", POSE], cwd=root, capture_output=True,
                             text=True, timeout=900, check=False)
        if out.returncode != 0:
            raise SystemExit(f"[{label}] the pose step failed:\n{out.stderr[-4000:]}")
        ms = json.loads(out.stdout.split("pose_ms")[-1])
        times[label].append(ms)
        print(f"[{label}] pose step, CUDA-graph replay (ms): "
              + "; ".join(f"{k} {v:.3f}" for k, v in ms.items()), flush=True)
    return times


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_svd_turns: needs a CUDA GPU")
    device = chip_smoke.phase_device()
    _build.load_library()
    lib, lib_path = other_library(args.other.resolve())

    def timer(fn):
        return chip_smoke.graph_ms(fn, iters=20, samples=30)

    groups = [(name, chip_smoke._svd_operands(m, n, seed=100 + i))
              for i, (name, m, n) in enumerate(chip_smoke.SVD_GROUPS)]
    rows = []
    for name, a in [*groups, ("fr3_ransac", chip_smoke.fr3_ransac_dlt())]:
        _, m, n = a.shape
        three = (m, n) == (3, 3)
        other = OtherSvd(lib, a)

        def this(a=a, three=three):
            return small_svd.small_svd_cuda(a, three)

        new, old = chip_smoke._in_turns(timer, other, this)
        got, theirs = this(), other()
        want = torch.linalg.svd(a, full_matrices=True)
        torch.cuda.synchronize()
        versus_other = chip_smoke.svd_errors(a, got, types.SimpleNamespace(
            U=theirs[0], S=theirs[1], Vh=theirs[2]))
        versus_torch = chip_smoke.svd_errors(a, got, want)
        chip_smoke.check(all(v <= chip_smoke.SVD_TOL[k] for k, v in versus_torch.items()),
                         f"{name}: this kernel against torch.linalg.svd {versus_torch}")
        plain = chip_smoke.cuda_ms(lambda a=a: torch.linalg.svd(a, full_matrices=True), 20, 20)
        row = {"case": name, "shape": list(a.shape), "ms": new, "other_ms": old,
               "kernel_us": kernel_us(this), "other_kernel_us": kernel_us(other),
               "torch_svd_eager_ms": plain, "versus_other": versus_other,
               "versus_torch": versus_torch}
        rows.append(row)
        print(f"small_svd [{name} {tuple(a.shape)}], us a call, CUDA-graph replay in turns "
              f"other/this/this/other: this {1e3 * new:.2f}, other {1e3 * old:.2f} "
              f"({old / new:.2f}x); kernel alone (profiler) this {row['kernel_us']:.2f}, other "
              f"{row['other_kernel_us']:.2f}; torch.linalg.svd eager {1e3 * plain:.2f}; this "
              f"against the other {versus_other}, against torch.linalg.svd {versus_torch}",
              flush=True)
    sass = {"this": chip_smoke.sass_sizes(_build.library_path()),
            "other": chip_smoke.sass_sizes(lib_path)}
    for label, sizes in sass.items():
        print(f"[{label}] small_svd SASS instructions by template arguments: "
              + ", ".join(f"({k}) {v}" for k, v in sorted(sizes.items()))
              + f"; all {len(sizes)} kernels {sum(sizes.values())}", flush=True)
    times = pose_turns(args.other.resolve())
    for case in times["this"][0]:
        mine = [t[case] for t in times["this"]]
        theirs = [t[case] for t in times["other"]]
        print(f"pose step [{case}], CUDA-graph replay, in turns: this "
              f"{statistics.mean(mine):.3f} ms ({', '.join(f'{t:.3f}' for t in mine)}), other "
              f"{statistics.mean(theirs):.3f} ({', '.join(f'{t:.3f}' for t in theirs)})",
              flush=True)
    print(json.dumps({"card": device["nvidia_smi"], "turns": rows, "sass": sass,
                      "pose_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
