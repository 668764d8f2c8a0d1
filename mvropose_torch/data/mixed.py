"""Mixed-robot batches: several robots in one fixed-shape train stream.

Port of `mvropose_tpu/data/mixed.py`. One model trains on several robots
through batches padded to the widest keypoint and angle arity:

  * a robot's missing keypoints are `PAD_KEYPOINT`, far outside any frame,
    so their GT heatmaps render exactly zero and the heatmap MSE trains the
    model to suppress the channels a robot does not have;
  * a robot's missing angles are 0 with an `angle_mask` (B, A_max) of 0,
    which the Huber loss of the single-view step drops;
  * every robot's angles are in radians (Fr5 and Meca500 record degrees,
    FR3 radians), so one unit's error does not outweigh another's; the eval
    converts back per robot (`angle_scale`);
  * `robot_id` (B,) names each row's robot, for the per-robot eval.
The model tells the robots apart from the image alone.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from mvropose_torch.data.dataset import SampleMap, SingleViewDataset, _batch_orders

# Far outside any frame: the render's gaussian at this centre underflows to
# exactly 0.0 over the whole map (f32 exp of about -1e12).
PAD_KEYPOINT = -1.0e6


class MixedRobotDataset:
    """The union of per-robot SingleViewDatasets, padded to shared arities.

    `samples` is the global index list [(child, sample)], so
    `builders.train_val_split` splits it as it splits a single dataset."""

    def __init__(self, datasets: Sequence[SingleViewDataset], robot_names: Sequence[str]):
        if not len(datasets) == len(robot_names) >= 1:
            raise ValueError(f"{len(datasets)} datasets for robots {list(robot_names)}")
        hws = {d.geometry.image_hw for d in datasets}
        if len(hws) != 1:
            raise ValueError(f"the robots' datasets must share image_hw, got {hws}")
        for d, name in zip(datasets, robot_names):
            # cam_idx collides across the children: only the host undistortion
            # is safe, since the device never reads it then.
            if not d.undistort_on_host:
                raise ValueError(f"{name}: mixed batches need the host undistortion")
            if d.with_extrinsics:
                raise ValueError(f"{name}: the extrinsics fields are per-robot shaped")
        self.children = list(datasets)
        self.robot_names = list(robot_names)
        self.geometry = datasets[0].geometry  # image and heatmap sizes for the preprocessor
        self.num_keypoints = max(d.geometry.rig.num_keypoints for d in datasets)
        self.num_angles = max(d.geometry.rig.robot.n_joints for d in datasets)
        # Each robot's native unit -> radians.
        self.angle_scale = [np.float32(np.pi / 180.0) if d.geometry.rig.robot.angle_unit == "deg"
                            else np.float32(1.0) for d in datasets]
        self.samples = [(ci, si) for ci, d in enumerate(datasets) for si in range(len(d.samples))]

    def __len__(self) -> int:
        return len(self.samples)

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0):
        """Fixed-shape batches of `batch_size` rows in sample order, or in
        the order of `np.random.default_rng(seed).shuffle`; the last batch
        padded with weight-0 rows. The single-view fields plus angle_mask
        (B, A) and robot_id (B,). A sample whose image fails to load or
        prepare keeps its angles, with weight 0 and angle_mask 0, as the
        reference's per-sample map leaves it."""
        H, W = self.geometry.image_hw
        J, A = self.num_keypoints, self.num_angles
        maps = [SampleMap(child) for child in self.children]
        for idxs in _batch_orders(len(self.samples), batch_size, shuffle, seed, False):
            B = batch_size
            batch = {
                "images_u8": np.zeros((B, H, W, 3), np.uint8),
                "cam_idx": np.zeros((B,), np.int32),
                "angles": np.zeros((B, A), np.float32),
                "keypoints_2d": np.full((B, J, 2), PAD_KEYPOINT, np.float32),
                "sample_weight": np.zeros((B,), np.float32),
                "angle_mask": np.zeros((B, A), np.float32),
                "robot_id": np.zeros((B,), np.int32),
            }
            for slot, gi in enumerate(idxs):
                ci, si = self.samples[gi]
                item = maps[ci](si)
                a = item["angles"].shape[0]
                batch["angles"][slot, :a] = item["angles"] * self.angle_scale[ci]
                batch["robot_id"][slot] = ci
                if not item["sample_weight"]:
                    continue
                kp = item["keypoints_2d"]
                batch["images_u8"][slot] = item["images_u8"]
                batch["cam_idx"][slot] = item["cam_idx"]
                batch["keypoints_2d"][slot, :kp.shape[0]] = kp
                batch["sample_weight"][slot] = 1.0
                batch["angle_mask"][slot, :a] = 1.0
            yield batch
