"""Fixed-shape datasets and their device preprocessing: port of `mvropose_tpu/data/dataset.py`.

The host side (the datasets) does the I/O and bookkeeping in numpy, as the
reference: decode (cv2), the ROI crop, the full-resolution undistortion
(`cv2.remap` on maps the port computes in torch f32) and the GT keypoints
(FK + projection without distortion, on the CPU in f32, once per sample).
The resize, augmentation, normalization and GT heatmap render run on the
device in one call of `make_device_preprocessor`'s function; the render is
the CUDA kernel on the card (`ops.heatmap_render.fused_render_heatmaps`).

Fixed shapes everywhere:
  * single-view batch: images_u8 (B, H, W, 3), cam_idx (B,), angles (B, A),
    keypoints_2d (B, J, 2) in raw-image pixels, sample_weight (B,)
  * multi-view batch: images_u8 (B, V, H, W, 3), view_ids (B, V),
    view_mask (B, V), cam_idx (B, V), angles (B, A), keypoints_2d (B, V, J, 2)
Partial final batches and captures that fail (an unreadable image, a file
name off the convention, a degenerate ROI) are padded with weight or mask 0;
none of them raises.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Iterator, Mapping, Sequence

import numpy as np
import torch

from mvropose_torch.calib.registry import RigSpec
from mvropose_torch.data import IMAGENET_MEAN, IMAGENET_STD
from mvropose_torch.data.augment import AugmentConfig, AugmentDraws, augment_batch
from mvropose_torch.geometry.camera import project_points, remap_bilinear, undistort_map
from mvropose_torch.geometry.robots import forward_kinematics
from mvropose_torch.models.heads import resize_bilinear
from mvropose_torch.models.vit import device_constant
from mvropose_torch.ops.heatmap_render import fused_render_heatmaps


@dataclasses.dataclass(frozen=True)
class SingleViewSample:
    image_path: str
    camera_key: str  # "{view}_{cam}" into rig.calibs / rig.extrinsics
    view: str
    angles: np.ndarray  # (A,) native units
    keypoints_2d: np.ndarray | None = None  # (J, 2) raw-image px (DREAM-style)
    # Camera-frame 3D keypoints (J, 3) where the dataset stores them (DREAM).
    keypoints_3d_cam: np.ndarray | None = None
    # Optional robot ROI (x1, y1, x2, y2) in raw-image px: the sample is
    # cropped to this box and stretched to the dataset's image_hw, its GT
    # keypoints moved to match.
    roi: tuple[int, int, int, int] | None = None


def _load_image_rgb(path: str) -> np.ndarray | None:
    import cv2

    img = cv2.imread(path)
    if img is None:
        return None
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _parse_serial_cam(path: str) -> tuple[str, str] | None:
    """zed_<serial>_<side>_<ts>.jpg -> (serial, '<side>cam'); None for a
    file name off the convention (skip, do not crash)."""
    parts = Path(path).name.split("_")
    if len(parts) < 3:
        return None
    return parts[1], parts[2] + "cam"


def _apply_roi_and_undistort(
    geometry: "_RigGeometry",
    s: SingleViewSample,
    img: np.ndarray,
    kp: np.ndarray,
    undistort_on_host: bool,
) -> tuple[np.ndarray, np.ndarray] | None:
    """The ROI crop (the box clamped to the image first, so crop and
    keypoints agree), the host undistortion and the shape gate -> (image at
    image_hw, keypoints in that frame), or None for a degenerate ROI or a
    wrong size."""
    H, W = geometry.image_hw
    if s.roi is not None:
        import cv2

        x1, y1, x2, y2 = (int(v) for v in s.roi)
        Hs, Ws = img.shape[:2]
        x1, y1 = max(0, x1), max(0, y1)
        x2, y2 = min(Ws, x2), min(Hs, y2)
        if x2 - x1 < 2 or y2 - y1 < 2:
            return None
        img = cv2.resize(img[y1:y2, x1:x2], (W, H))
        kp = (kp - np.array([x1, y1], np.float32)) * np.array(
            [W / (x2 - x1), H / (y2 - y1)], np.float32
        )
    if img.shape[:2] != (H, W):
        return None
    if undistort_on_host and s.roi is None:
        img = geometry.undistort_host(img, geometry.key_to_idx[s.camera_key])
    return img, kp


class _RigGeometry:
    """Per-camera tables the datasets share."""

    def __init__(self, rig: RigSpec, image_hw: tuple[int, int]):
        self.rig = rig
        self.image_hw = image_hw
        self.camera_keys = sorted(rig.calibs)
        self.key_to_idx = {k: i for i, k in enumerate(self.camera_keys)}
        self.K = np.stack(
            [rig.calibs[k].camera_matrix for k in self.camera_keys]
        ).astype(np.float32)
        self.dist = np.stack(
            [rig.calibs[k].distortion_coeffs for k in self.camera_keys]
        ).astype(np.float32)

    @functools.cached_property
    def remaps(self) -> np.ndarray:
        """(C, 2, H, W) undistortion grid per camera (torch f32 on the CPU)."""
        H, W = self.image_hw
        return np.stack([
            undistort_map(torch.from_numpy(K), torch.from_numpy(d), H, W).numpy()
            for K, d in zip(self.K, self.dist)
        ])

    @functools.cached_property
    def cv2_maps(self) -> list:
        """Per-camera (map_x, map_y) float32 pairs for the host's cv2.remap."""
        return [(np.ascontiguousarray(g[1], np.float32), np.ascontiguousarray(g[0], np.float32))
                for g in self.remaps]

    def undistort_host(self, image: np.ndarray, cam_idx: int) -> np.ndarray:
        import cv2

        mx, my = self.cv2_maps[cam_idx]
        return cv2.remap(image, mx, my, cv2.INTER_LINEAR)

    def gt_keypoints(self, sample: SingleViewSample, extr_key: str | None = None) -> np.ndarray:
        """FK + projection GT keypoints in raw-image pixels (J, 2), on the
        CPU in f32. The projection has no distortion: the keypoints live on
        the undistorted image."""
        if sample.keypoints_2d is not None:
            return sample.keypoints_2d
        rig = self.rig
        extr = rig.extrinsics[extr_key or sample.camera_key]
        f32 = functools.partial(torch.tensor, dtype=torch.float32)
        pts = forward_kinematics(rig.robot, f32(np.asarray(sample.angles, np.float32)),
                                 f32(rig.robot.base_rotation(sample.view)))
        px = project_points(pts, f32(np.asarray(extr.rvec, np.float32)),
                            f32(np.asarray(extr.tvec, np.float32)),
                            f32(np.asarray(rig.calibs[sample.camera_key].camera_matrix,
                                           np.float32)))
        return px.numpy()


class _HostTables:
    """What the per-sample preparation needs of a `_RigGeometry`, and no
    more, so that a sample map pickles to worker processes: the image size,
    the camera indices and the host undistortion's cv2 remap tables (None
    where nothing is undistorted on the host)."""

    def __init__(self, geometry: _RigGeometry, undistort: bool):
        self.image_hw = geometry.image_hw
        self.key_to_idx = geometry.key_to_idx
        self.cv2_maps = geometry.cv2_maps if undistort else None

    undistort_host = _RigGeometry.undistort_host


def stack_samples(samples: Sequence[dict]) -> dict:
    """Sample dicts -> one batch of numpy arrays, each key stacked."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _batch_orders(n: int, batch_size: int, shuffle: bool, seed: int,
                  drop_last: bool) -> Iterator[np.ndarray]:
    """The indices of each batch: in order, or in the order of
    `np.random.default_rng(seed).shuffle`; the last may be short, or
    dropped with `drop_last`."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, n, batch_size):
        idxs = order[start : start + batch_size]
        if len(idxs) < batch_size and drop_last:
            return
        yield idxs


class SampleMap:
    """Index -> fixed-shape single-view sample dict, the one per-sample
    preparation of the port: `SingleViewDataset.batches`, the mixed
    batches and the worker processes (`data/worker_loader.py`) all call it.
    Load, ROI crop with clamping, host undistortion and shape gate
    (`_apply_roi_and_undistort`); the GT keypoints and extrinsic fields are
    resolved when the map is made, so it pickles without the rig. A sample
    that fails keeps its angles and extrinsics with weight 0. The
    reference's grain `_SampleMap` (`mvropose_tpu/data/grain_loader.py:29`)."""

    def __init__(self, dataset: "SingleViewDataset"):
        self.samples = dataset.samples
        geometry, rig = dataset.geometry, dataset.geometry.rig
        self.num_keypoints, self.num_angles = rig.num_keypoints, rig.robot.n_joints
        self.undistort_on_host = dataset.undistort_on_host
        self.has_kp3d = dataset.has_kp3d
        self.with_extrinsics = dataset.with_extrinsics
        self.kp_raw = [dataset.gt_keypoints(i) for i in range(len(self.samples))]
        if self.with_extrinsics:
            self.extr = []
            for s in self.samples:
                extr = rig.extrinsics.get(dataset.extr_key(s) or s.camera_key)
                rvec = (np.asarray(extr.rvec, np.float32) if extr is not None
                        else np.zeros(3, np.float32))
                tvec = (np.asarray(extr.tvec, np.float32) if extr is not None
                        else np.array([0, 0, 1], np.float32))
                self.extr.append((rvec, tvec,
                                  np.asarray(rig.calibs[s.camera_key].camera_matrix, np.float32),
                                  np.asarray(rig.robot.base_rotation(s.view), np.float32)))
        self.geometry = _HostTables(geometry, self.undistort_on_host
                                    and any(s.roi is None for s in self.samples))

    def __len__(self) -> int:
        return len(self.samples)

    def blank(self) -> dict:
        """A padding slot: weight 0, every field zero but the identity
        matrices and tvec (0, 0, 1)."""
        H, W = self.geometry.image_hw
        J = self.num_keypoints
        out = {
            "images_u8": np.zeros((H, W, 3), np.uint8),
            "cam_idx": np.int32(0),
            "angles": np.zeros(self.num_angles, np.float32),
            "keypoints_2d": np.zeros((J, 2), np.float32),
            "sample_weight": np.float32(0.0),
        }
        if self.has_kp3d:
            out["keypoints_3d_cam"] = np.zeros((J, 3), np.float32)
        if self.with_extrinsics:
            out.update(rvec=np.zeros(3, np.float32), tvec=np.array([0, 0, 1], np.float32),
                       K=np.eye(3, dtype=np.float32), base_rotation=np.eye(3, dtype=np.float32))
        return out

    def __call__(self, idx: int) -> dict:
        s = self.samples[idx]
        out = self.blank()
        out["angles"] = np.asarray(s.angles, np.float32)
        if self.with_extrinsics:
            rvec, tvec, K, base = self.extr[idx]
            out.update(rvec=rvec, tvec=tvec, K=K, base_rotation=base)
        img = _load_image_rgb(s.image_path)
        if img is None:
            return out
        prepared = _apply_roi_and_undistort(self.geometry, s, img, self.kp_raw[idx],
                                            self.undistort_on_host)
        if prepared is None:
            return out
        out["images_u8"], kp = prepared
        out["cam_idx"] = np.int32(self.geometry.key_to_idx[s.camera_key])
        out["keypoints_2d"] = np.asarray(kp, np.float32)
        out["sample_weight"] = np.float32(1.0)
        if self.has_kp3d:
            out["keypoints_3d_cam"] = np.asarray(s.keypoints_3d_cam, np.float32)
        return out


class GroupSampleMap:
    """Index -> fixed-shape multi-view group dict, the one per-group
    preparation of the port: `MultiViewDataset.batches` and the worker
    processes call it. The views' resolution, GT keypoints and extrinsics
    are done when the map is made; a call loads each resolved view, gates
    its shape and undistorts it on the host. A view that does not resolve
    or load leaves its slot masked. The reference's grain
    `_GroupSampleMap`."""

    def __init__(self, dataset: "MultiViewDataset"):
        geometry, rig = dataset.geometry, dataset.geometry.rig
        self.max_views = dataset.max_views
        self.num_keypoints = rig.num_keypoints
        self.undistort_on_host = dataset.undistort_on_host
        self.with_extrinsics = dataset.with_extrinsics
        A = rig.robot.n_joints
        self.angles = np.zeros((len(dataset.groups), A), np.float32)
        self.views = []
        for gi, g in enumerate(dataset.groups):
            raw = np.asarray(g["joint_angles"], np.float32)
            if dataset.angles_transform:
                raw = dataset.angles_transform(raw)
            self.angles[gi] = raw[:A]
            slots = []
            for v, vd in enumerate(g["views"][: self.max_views]):
                rv = dataset._resolve_view(vd["image_path"])
                if rv is None:
                    slots.append(None)
                    continue
                slot = {
                    "image_path": rv["image_path"],
                    "cam_idx": geometry.key_to_idx[rv["camera_key"]],
                    "view_id": rig.view_index(rv["serial"], rv["cam"]),
                    "kp": dataset.gt_keypoints(g, v, rv, self.angles[gi]),
                }
                if self.with_extrinsics:
                    extr = rig.extrinsics[rv["extr_key"]]
                    slot.update(
                        rvec=np.asarray(extr.rvec, np.float32),
                        tvec=np.asarray(extr.tvec, np.float32),
                        K=np.asarray(rig.calibs[rv["camera_key"]].camera_matrix, np.float32),
                        base=np.asarray(rig.robot.base_rotation(rv["view"]), np.float32))
                slots.append(slot)
            self.views.append(slots)
        self.geometry = _HostTables(geometry, self.undistort_on_host)

    def __len__(self) -> int:
        return len(self.views)

    def blank(self) -> dict:
        """A padding slot: no view, weight 0, angles 0."""
        H, W = self.geometry.image_hw
        V, J = self.max_views, self.num_keypoints
        out = {
            "images_u8": np.zeros((V, H, W, 3), np.uint8),
            "view_ids": np.zeros((V,), np.int32),
            "view_mask": np.zeros((V,), bool),
            "cam_idx": np.zeros((V,), np.int32),
            "angles": np.zeros(self.angles.shape[1], np.float32),
            "keypoints_2d": np.zeros((V, J, 2), np.float32),
            "sample_weight": np.float32(0.0),
        }
        if self.with_extrinsics:
            out["rvec"] = np.zeros((V, 3), np.float32)
            out["tvec"] = np.zeros((V, 3), np.float32)
            out["tvec"][:, 2] = 1.0
            out["K"] = np.tile(np.eye(3, dtype=np.float32), (V, 1, 1))
            out["base_rotation"] = np.tile(np.eye(3, dtype=np.float32), (V, 1, 1))
        return out

    def __call__(self, idx: int) -> dict:
        H, W = self.geometry.image_hw
        out = self.blank()
        out["angles"] = self.angles[idx]
        for v, slot in enumerate(self.views[idx]):
            if slot is None:
                continue
            img = _load_image_rgb(slot["image_path"])
            if img is None or img.shape[:2] != (H, W):
                continue
            if self.undistort_on_host:
                img = self.geometry.undistort_host(img, slot["cam_idx"])
            out["images_u8"][v] = img
            out["view_ids"][v] = slot["view_id"]
            out["cam_idx"][v] = slot["cam_idx"]
            out["keypoints_2d"][v] = slot["kp"]
            out["view_mask"][v] = True
            if self.with_extrinsics:
                out["rvec"][v] = slot["rvec"]
                out["tvec"][v] = slot["tvec"]
                out["K"][v] = slot["K"]
                out["base_rotation"][v] = slot["base"]
        out["sample_weight"] = np.float32(out["view_mask"].any())
        return out


def _imagenet_stats():
    return IMAGENET_MEAN, IMAGENET_STD


def _keypoint_scale(hm_w: int, w: int, hm_h: int, h: int):
    """Raw-image pixels -> heatmap pixels, (Wm / W, Hm / H) in f32."""
    return (np.array([hm_w / w, hm_h / h], np.float32),)


def device_preprocess(
    images_u8: torch.Tensor,  # (N, H, W, 3) uint8 raw
    cam_idx: torch.Tensor,  # (N,) int
    keypoints_2d: torch.Tensor,  # (N, J, 2) raw px
    remaps: torch.Tensor | None,  # (C, 2, H, W) or None: no device undistortion
    sigma: float,
    model_size: int,
    heatmap_size: tuple[int, int],
    augment_cfg: AugmentConfig | None = None,
    generator: torch.Generator | None = None,
    draws: AugmentDraws | None = None,
):
    """/255 [-> device undistortion] -> bilinear resize (antialiased on a
    downscale, as jax.image.resize) [-> augment] -> normalize, and the GT
    heatmaps of the keypoints scaled to heatmap pixels: (N, S, S, 3) f32
    images, (N, J, Hm, Wm) f32 maps. Augmentation runs with `augment_cfg`
    and either `generator` or the given `draws`."""
    N, H, W, _ = images_u8.shape
    f = images_u8.float() / 255.0
    if remaps is not None:
        f = remap_bilinear(f, remaps[cam_idx.long()])
    out = resize_bilinear(f.permute(0, 3, 1, 2), (model_size, model_size)).permute(0, 2, 3, 1)
    if augment_cfg is not None and (generator is not None or draws is not None):
        out = augment_batch(out, augment_cfg, generator=generator, draws=draws)
    mean, std = device_constant(_imagenet_stats, (), out.device)
    out = (out - mean) / std
    Hm, Wm = heatmap_size
    (scale,) = device_constant(_keypoint_scale, (Wm, W, Hm, H), keypoints_2d.device)
    heatmaps = fused_render_heatmaps(keypoints_2d.float() * scale, Hm, Wm, sigma=sigma)
    return out, heatmaps


def make_device_preprocessor(
    geometry: _RigGeometry,
    model_size: int,
    heatmap_size: tuple[int, int],
    sigma: float,
    augment_cfg: AugmentConfig | None = None,
    undistort_on_device: bool = False,
    device="cpu",
):
    """Bind the static tables: f(images_u8, cam_idx, keypoints_2d,
    generator=None, draws=None) -> (model images, GT heatmaps) on (B, ...)
    or (B, V, ...) tensors on `device` (the view axis folds into the batch).
    Augmentation runs only with both `augment_cfg` and a generator (or
    draws). The remap tables go to the device only with
    `undistort_on_device` (at 1080p they are 16 MB a camera)."""
    remaps = torch.from_numpy(geometry.remaps).to(device) if undistort_on_device else None

    def preprocess(images_u8, cam_idx, keypoints_2d, generator=None, draws=None):
        lead = images_u8.shape[:-3]
        out, hms = device_preprocess(
            images_u8.reshape(-1, *images_u8.shape[-3:]), cam_idx.reshape(-1),
            keypoints_2d.reshape(-1, *keypoints_2d.shape[-2:]), remaps, sigma, model_size,
            heatmap_size, augment_cfg, generator, draws)
        return (out.reshape(*lead, model_size, model_size, 3),
                hms.reshape(*lead, *hms.shape[-3:]))

    return preprocess


class SingleViewDataset:
    """Synced rows -> fixed-shape host batches (images still uint8 raw).

    with_extrinsics=True adds per-sample (rvec, tvec, K, base_rotation) to
    every batch, the inputs of the FK-consistency term."""

    def __init__(
        self,
        samples: Sequence[SingleViewSample],
        rig: RigSpec,
        image_hw: tuple[int, int],
        extr_key_fn=None,  # sample -> extrinsic key (multi-pose rigs)
        with_extrinsics: bool = False,
        undistort_on_host: bool = True,
    ):
        self.samples = list(samples)
        self.geometry = _RigGeometry(rig, image_hw)
        self.extr_key_fn = extr_key_fn
        self.with_extrinsics = with_extrinsics
        self.undistort_on_host = undistort_on_host
        # Datasets whose samples carry camera-frame 3D keypoints (DREAM)
        # emit them as batch["keypoints_3d_cam"] (J, 3).
        self.has_kp3d = bool(self.samples) and all(
            s.keypoints_3d_cam is not None for s in self.samples
        )
        # GT keypoints once per sample, keyed by the sample object:
        # train_val_split's shallow copies share the samples.
        self._kp_cache: dict = {}

    def __len__(self) -> int:
        return len(self.samples)

    def extr_key(self, s: SingleViewSample) -> str | None:
        return self.extr_key_fn(s) if self.extr_key_fn else None

    def gt_keypoints(self, i: int) -> np.ndarray:
        """Sample i's GT keypoints in raw-image pixels (f32), computed once
        per sample."""
        s = self.samples[i]
        kp = self._kp_cache.get(id(s))
        if kp is None:
            kp = np.asarray(self.geometry.gt_keypoints(s, self.extr_key(s)), np.float32)
            self._kp_cache[id(s)] = kp
        return kp

    def batches(
        self, batch_size: int, shuffle: bool = False, seed: int = 0, drop_last: bool = False
    ) -> Iterator[dict]:
        """Batches of `SampleMap` samples, the last padded with blank slots.
        A sample that fails to load or prepare leaves its slot blank too, as
        the reference's batches do (its map keeps the angles and
        extrinsics)."""
        fn = SampleMap(self)
        blank = fn.blank()
        for idxs in _batch_orders(len(self.samples), batch_size, shuffle, seed, drop_last):
            items = [item if item["sample_weight"] else blank for item in map(fn, idxs)]
            batch = stack_samples(items + [blank] * (batch_size - len(items)))
            if self.has_kp3d:  # last, as the reference's batches have it
                batch["keypoints_3d_cam"] = batch.pop("keypoints_3d_cam")
            yield batch


class MultiViewDataset:
    """Grouped rows -> fixed-shape multi-view batches with view masks.

    with_extrinsics=True adds per-view (rvec, tvec, K, base_rotation)."""

    def __init__(
        self,
        groups: Sequence[Mapping],
        rig: RigSpec,
        image_hw: tuple[int, int],
        max_views: int | None = None,
        pose_from_path=None,  # path -> pose name prefix for extrinsics
        angles_transform=None,  # raw group angles -> model angle vector
        with_extrinsics: bool = False,
        undistort_on_host: bool = True,
    ):
        self.groups = list(groups)
        self.geometry = _RigGeometry(rig, image_hw)
        self.max_views = max_views or rig.max_views
        self.pose_from_path = pose_from_path
        self.angles_transform = angles_transform
        self.with_extrinsics = with_extrinsics
        self.undistort_on_host = undistort_on_host
        # (id(group), view slot) -> GT keypoints, once per group view.
        self._kp_cache: dict = {}

    def __len__(self) -> int:
        return len(self.groups)

    def _resolve_view(self, path: str) -> dict | None:
        """path -> {image_path, camera_key, extr_key, view, serial, cam}, or
        None where the file name, serial, calibration or extrinsic does not
        resolve."""
        rig = self.geometry.rig
        parsed = _parse_serial_cam(path)
        if parsed is None:
            return None
        serial, cam = parsed
        view = rig.serial_to_view.get(serial)
        if view is None:
            return None
        ckey = f"{view}_{cam}"
        if ckey not in self.geometry.key_to_idx:
            return None
        pose = self.pose_from_path(path) if self.pose_from_path else None
        ekey = f"{pose}_{ckey}" if pose else ckey
        if ekey not in rig.extrinsics:
            if ckey in rig.extrinsics:
                ekey = ckey  # unprefixed summary fallback
            else:
                return None
        return {
            "image_path": path, "camera_key": ckey, "extr_key": ekey,
            "view": view, "serial": serial, "cam": cam,
        }

    def resolve_group_views(self, group: Mapping) -> list[dict]:
        """A group's views that resolve (`_resolve_view`), in slot order:
        what `cli visualize --multi-view` draws."""
        out = []
        for vd in group["views"][: self.max_views]:
            rv = self._resolve_view(vd["image_path"])
            if rv is not None:
                out.append(rv)
        return out

    def gt_keypoints(self, group: Mapping, v: int, rv: dict, angles: np.ndarray) -> np.ndarray:
        """The GT keypoints (f32) of view slot v of `group`, resolved as
        `rv` (`_resolve_view`) at the group's model `angles`, computed once
        per group view."""
        kp = self._kp_cache.get((id(group), v))
        if kp is None:
            sample = SingleViewSample(image_path=rv["image_path"], camera_key=rv["camera_key"],
                                      view=rv["view"], angles=angles)
            kp = np.asarray(self.geometry.gt_keypoints(sample, rv["extr_key"]), np.float32)
            self._kp_cache[(id(group), v)] = kp
        return kp

    def batches(
        self, batch_size: int, shuffle: bool = False, seed: int = 0, drop_last: bool = False
    ) -> Iterator[dict]:
        """Batches of `GroupSampleMap` groups, the last padded with blank
        slots."""
        fn = GroupSampleMap(self)
        blank = fn.blank()
        for idxs in _batch_orders(len(self.groups), batch_size, shuffle, seed, drop_last):
            items = [fn(i) for i in idxs]
            yield stack_samples(items + [blank] * (batch_size - len(items)))
