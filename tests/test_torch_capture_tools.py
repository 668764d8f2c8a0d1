"""The port's worker loader and `cli visualize` against the reference, on the CPU.

On the captures of `test_torch_capture_data.py` (60 x 80, made by the
reference's own `cli sync` / `calibrate`): the per-sample maps against
grain's `_SampleMap` and `_GroupSampleMap` sample for sample; the worker
stream fed grain's order batch for batch against `make_grain_loader(...,
num_workers=0)`, across epochs, at the stream seeds of a first and a
resumed run; 2 workers against 0 and against `batches()` of the same
indices; a worker that fails raising in the parent. Images are held as
`assert_batches_match` holds them (equal but for pixels one level apart
where the host undistortion maps differ), keypoints within 1e-3 px, every
other field equal. `cli visualize`'s panels against the reference's: the
same files, each within one level where the undistortion differs.
"""

from __future__ import annotations

import copy

import cv2
import grain
import numpy as np
import pytest
import torch

from mvropose_tpu.cli.main import main as jax_main
from mvropose_tpu.data import grain_loader
from mvropose_torch.cli.main import main as port_main
from mvropose_torch.data import worker_loader
from mvropose_torch.data.worker_loader import WorkerStream, batch_indices, make_worker_loader
from test_torch_capture_data import _datasets, assert_batches_match, caps  # noqa: F401

MAP_CASES = ["fr3_multi", "fr3_single", "fr5_roi", "dream"]


def _numpy(batch: dict) -> dict:
    return {k: v.numpy() for k, v in batch.items()}


def _sorted(batch: dict) -> dict:
    """Keys in name order, as grain's batches have them."""
    return {k: batch[k] for k in sorted(batch)}


def _with_extrinsics(name: str, caps):  # noqa: F811
    a, b = _datasets(name, caps)
    if name.startswith("fr3"):
        a.with_extrinsics = b.with_extrinsics = True
    return a, b


@pytest.mark.parametrize("name", MAP_CASES)
def test_sample_maps_match_reference(caps, name):  # noqa: F811
    a, b = _with_extrinsics(name, caps)
    ref = (grain_loader._GroupSampleMap if name == "fr3_multi" else grain_loader._SampleMap)(a)
    port = worker_loader.sample_map(b)
    assert type(port).__name__ == type(ref).__name__.lstrip("_") and len(port) == len(ref) > 0
    one = lambda s: {k: np.asarray(v)[None] for k, v in s.items()}  # noqa: E731
    assert_batches_match([one(ref(i)) for i in range(len(ref))],
                         [_numpy(worker_loader.collate([port(i)])) for i in range(len(port))],
                         a.geometry, b.geometry, undistorted=name != "fr5_roi")


def grain_order(n: int, seed: int):
    """epoch -> grain's permutation of that epoch (its `index_shuffle`,
    reseeded each epoch), read from grain itself."""
    ds = grain.MapDataset.range(n).shuffle(seed=seed).repeat(None)
    return lambda epoch: np.array([ds[epoch * n + i] for i in range(n)])


@pytest.mark.parametrize("name", ["fr3_multi", "fr5"])
def test_worker_stream_matches_grain(caps, name):  # noqa: F811
    """The endless stream of a first run (seed 0) and of a run resumed at
    epoch 1 (seed 0 + 1000003), three epochs of batches of 2 (a batch spans
    two epochs where the length is odd), then a 2-epoch stream whose last
    partial batch is dropped."""
    a, b = _with_extrinsics(name, caps)
    n = len(a.groups) if name == "fr3_multi" else len(a.samples)
    for seed in (0, 1000003):
        ref = iter(grain_loader.make_grain_loader(a, 2, shuffle=True, seed=seed, num_workers=0,
                                                  num_epochs=None))
        port = make_worker_loader(b, 2, seed=seed, num_epochs=None,
                                  order=grain_order(n, seed))
        steps = (3 * n) // 2
        assert_batches_match([next(ref) for _ in range(steps)],
                             [_sorted(_numpy(next(port))) for _ in range(steps)], a.geometry,
                             b.geometry)
    ref = list(grain_loader.make_grain_loader(a, 4, shuffle=True, seed=3, num_epochs=2))
    port = [_sorted(_numpy(x)) for x in make_worker_loader(b, 4, seed=3,
                                                           num_epochs=2, order=grain_order(n, 3))]
    assert len(port) == len(ref) == (2 * n) // 4
    assert_batches_match(ref, port, a.geometry, b.geometry)


def test_two_workers_match_in_process_and_batches(caps):  # noqa: F811
    """The FR3 groups (an unreadable image, a file off the convention and a
    wrong size among them) in 2 worker processes: every batch bit-equal to
    the in-process stream's and to `batches()` of the same groups, in the
    stream's order; the port's own permutations from (seed, epoch)."""
    _, b = _with_extrinsics("fr3_multi", caps)
    n = len(b.groups)
    streams = [make_worker_loader(b, 2, seed=5, num_workers=w, num_epochs=2)
               for w in (0, 2)]
    count = 0
    for x, y in zip(*streams, strict=True):
        assert streams[0].indices.tolist() == streams[1].indices.tolist()
        sub = copy.copy(b)
        sub.groups = [b.groups[i] for i in streams[1].indices]
        z = next(sub.batches(2))
        assert list(x) == list(y) == list(z)
        for k in x:
            assert torch.equal(x[k], y[k]) and np.array_equal(y[k].numpy(), z[k]), k
        count += 1
    assert count == (2 * n) // 2
    order = worker_loader.permutations(n, 5)
    np.testing.assert_array_equal(order(1), order(1))
    assert sorted(order(0)) == list(range(n)) and not np.array_equal(order(0), order(1))


def test_a_failing_worker_raises(caps):  # noqa: F811
    _, b = _with_extrinsics("fr3_multi", caps)
    fn = worker_loader.sample_map(b)
    fn.views[1][0]["cam_idx"] = 99  # no such camera: an IndexError in the worker
    stream = WorkerStream(fn, batch_indices(lambda e: np.arange(len(fn)), 2, 1), num_workers=2)
    try:
        with pytest.raises(IndexError):
            list(stream)
    finally:
        stream.close()


def _visualize(main, name, out, caps, *extra):  # noqa: F811
    robot = name.split("_")[0]
    cap = caps[robot]
    return main(["visualize", "--robot", robot, "--csv", str(cap["csv"]), "--calib-dir",
                 str(cap["calib_dir"]), "--aruco-summary", str(cap["summary"]), "--image-hw",
                 "60", "80", "--out-dir", str(out), "--num-samples", "3", "--sigma", "4.0",
                 *extra])


@pytest.mark.parametrize("name", ["fr5", "meca500", "fr3_multi"])
def test_visualize_matches_reference(caps, tmp_path, name):  # noqa: F811
    extra = ["--multi-view", "--tolerance", "0.05"] if name == "fr3_multi" else []
    assert _visualize(jax_main, name, tmp_path / "ref", caps, *extra) == 0
    assert _visualize(port_main, name, tmp_path / "port", caps, *extra) == 0
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names and sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for f in names:
        x, y = (cv2.imread(str(tmp_path / d / f)).astype(np.int16) for d in ("ref", "port"))
        assert x.shape == y.shape and x.shape[0] == 60
        d = np.abs(x - y).max(axis=-1)
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, f
