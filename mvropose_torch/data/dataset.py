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

    def prepared(self, i: int) -> tuple[np.ndarray, np.ndarray] | None:
        """Sample i's image at image_hw and its GT keypoints in that frame:
        loaded, ROI-cropped, undistorted on the host and shape-gated
        (`_apply_roi_and_undistort`), or None where the image fails to load
        or prepare. The per-sample preparation of `batches` and of the
        mixed-robot batches (the reference's grain `_SampleMap`,
        `mvropose_tpu/data/grain_loader.py:29`)."""
        s = self.samples[i]
        img = _load_image_rgb(s.image_path)
        if img is None:
            return None
        kp = self._kp_cache.get(id(s))
        if kp is None:
            kp = self.geometry.gt_keypoints(s, self.extr_key_fn(s) if self.extr_key_fn else None)
            self._kp_cache[id(s)] = kp
        return _apply_roi_and_undistort(self.geometry, s, img, kp, self.undistort_on_host)

    def batches(
        self, batch_size: int, shuffle: bool = False, seed: int = 0, drop_last: bool = False
    ) -> Iterator[dict]:
        n = len(self.samples)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        H, W = self.geometry.image_hw
        rig = self.geometry.rig
        J = rig.num_keypoints
        A = rig.robot.n_joints
        for start in range(0, n, batch_size):
            idxs = order[start : start + batch_size]
            if len(idxs) < batch_size and drop_last:
                break
            B = batch_size
            images = np.zeros((B, H, W, 3), np.uint8)
            cam_idx = np.zeros((B,), np.int32)
            angles = np.zeros((B, A), np.float32)
            kpts = np.zeros((B, J, 2), np.float32)
            weight = np.zeros((B,), np.float32)
            kp3d = np.zeros((B, J, 3), np.float32) if self.has_kp3d else None
            if self.with_extrinsics:
                rvecs = np.zeros((B, 3), np.float32)
                tvecs = np.zeros((B, 3), np.float32)
                tvecs[:, 2] = 1.0  # harmless default for padded slots
                Ks = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
                base_rots = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
            for slot, i in enumerate(idxs):
                prepared = self.prepared(i)
                if prepared is None:
                    continue  # weight stays 0
                s = self.samples[i]
                images[slot], kpts[slot] = prepared
                cam_idx[slot] = self.geometry.key_to_idx[s.camera_key]
                angles[slot] = s.angles
                if kp3d is not None:
                    kp3d[slot] = s.keypoints_3d_cam
                weight[slot] = 1.0
                if self.with_extrinsics:
                    ek = self.extr_key_fn(s) if self.extr_key_fn else None
                    extr = rig.extrinsics.get(ek or s.camera_key)
                    if extr is not None:
                        rvecs[slot] = extr.rvec
                        tvecs[slot] = extr.tvec
                    Ks[slot] = rig.calibs[s.camera_key].camera_matrix
                    base_rots[slot] = rig.robot.base_rotation(s.view)
            batch = {
                "images_u8": images,
                "cam_idx": cam_idx,
                "angles": angles,
                "keypoints_2d": kpts,
                "sample_weight": weight,
            }
            if self.with_extrinsics:
                batch.update(rvec=rvecs, tvec=tvecs, K=Ks, base_rotation=base_rots)
            if kp3d is not None:
                batch["keypoints_3d_cam"] = kp3d
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

    def batches(
        self, batch_size: int, shuffle: bool = False, seed: int = 0, drop_last: bool = False
    ) -> Iterator[dict]:
        n = len(self.groups)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        H, W = self.geometry.image_hw
        rig = self.geometry.rig
        V = self.max_views
        J = rig.num_keypoints
        A = rig.robot.n_joints
        for start in range(0, n, batch_size):
            idxs = order[start : start + batch_size]
            if len(idxs) < batch_size and drop_last:
                break
            B = batch_size
            images = np.zeros((B, V, H, W, 3), np.uint8)
            view_ids = np.zeros((B, V), np.int32)
            view_mask = np.zeros((B, V), bool)
            cam_idx = np.zeros((B, V), np.int32)
            angles = np.zeros((B, A), np.float32)
            kpts = np.zeros((B, V, J, 2), np.float32)
            weight = np.zeros((B,), np.float32)
            if self.with_extrinsics:
                rvecs = np.zeros((B, V, 3), np.float32)
                tvecs = np.zeros((B, V, 3), np.float32)
                tvecs[:, :, 2] = 1.0
                Ks = np.tile(np.eye(3, dtype=np.float32), (B, V, 1, 1))
                base_rots = np.tile(np.eye(3, dtype=np.float32), (B, V, 1, 1))
            for slot, i in enumerate(idxs):
                g = self.groups[i]
                raw_angles = np.asarray(g["joint_angles"], np.float32)
                if self.angles_transform:
                    raw_angles = self.angles_transform(raw_angles)
                angles[slot] = raw_angles[:A]
                any_view = False
                for v, vd in enumerate(g["views"][:V]):
                    # Resolve before decoding: a view that cannot resolve
                    # costs dict lookups, not an image read.
                    rv = self._resolve_view(vd["image_path"])
                    if rv is None:
                        continue
                    img = _load_image_rgb(rv["image_path"])
                    if img is None or img.shape[:2] != (H, W):
                        continue
                    ckey, ekey, view = rv["camera_key"], rv["extr_key"], rv["view"]
                    sample = SingleViewSample(
                        image_path=rv["image_path"], camera_key=ckey, view=view,
                        angles=angles[slot],
                    )
                    if self.undistort_on_host:
                        img = self.geometry.undistort_host(img, self.geometry.key_to_idx[ckey])
                    images[slot, v] = img
                    view_ids[slot, v] = rig.view_index(rv["serial"], rv["cam"])
                    cam_idx[slot, v] = self.geometry.key_to_idx[ckey]
                    kp = self._kp_cache.get((id(g), v))
                    if kp is None:
                        kp = self.geometry.gt_keypoints(sample, ekey)
                        self._kp_cache[(id(g), v)] = kp
                    kpts[slot, v] = kp
                    view_mask[slot, v] = True
                    any_view = True
                    if self.with_extrinsics:
                        extr = rig.extrinsics[ekey]
                        rvecs[slot, v] = extr.rvec
                        tvecs[slot, v] = extr.tvec
                        Ks[slot, v] = rig.calibs[ckey].camera_matrix
                        base_rots[slot, v] = rig.robot.base_rotation(view)
                weight[slot] = 1.0 if any_view else 0.0
            batch = {
                "images_u8": images,
                "view_ids": view_ids,
                "view_mask": view_mask,
                "cam_idx": cam_idx,
                "angles": angles,
                "keypoints_2d": kpts,
                "sample_weight": weight,
            }
            if self.with_extrinsics:
                batch.update(rvec=rvecs, tvec=tvecs, K=Ks, base_rotation=base_rots)
            yield batch
