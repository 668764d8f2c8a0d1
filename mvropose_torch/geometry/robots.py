"""Robot specifications and batched forward kinematics.

Port of `mvropose_tpu/geometry/robots.py`: the same four specs (FR3, FR5,
Meca500, DREAM panda), their DH tables copied (a test holds them equal to the
reference's), and FK as a loop over the DH rows with any leading batch
dimensions (the reference scans one sample and vmaps). Angles are in the
spec's native unit (`angle_unit`: FR5 and Meca500 joints are degrees, FR3
radians).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from mvropose_torch.geometry.dh import modified_dh_matrix, standard_dh_matrix
from mvropose_torch.geometry.rotations import euler_zyx_deg_to_matrix


@dataclasses.dataclass(frozen=True)
class RobotSpec:
    """Kinematic description of one robot family. dh_params rows are
    (a_m, d_m, alpha_deg, theta_offset_deg), one per actuated joint plus
    `n_passive_rows` trailing fixed links; keypoints are [base] + one origin
    per row unless `keypoint_fk_indices` picks a subset."""

    name: str
    convention: str  # "standard" | "modified"
    dh_params: Tuple[Tuple[float, float, float, float], ...]
    angle_unit: str  # "rad" | "deg"
    view_base_rotations_zyx_deg: Dict[str, Tuple[float, float, float]]
    extrinsic_rvec_unit: str = "rad"
    links: Tuple[Tuple[int, int], ...] = ()
    keypoint_fk_indices: Tuple[int, ...] | None = None
    n_passive_rows: int = 0

    def __hash__(self):
        # The dict field defeats the frozen-dataclass hash; specs key caches.
        return hash((self.name, self.convention, self.dh_params, self.angle_unit,
                     self.keypoint_fk_indices, self.n_passive_rows))

    @property
    def n_joints(self) -> int:
        return len(self.dh_params) - self.n_passive_rows

    @property
    def n_keypoints(self) -> int:
        if self.keypoint_fk_indices is not None:
            return len(self.keypoint_fk_indices)
        return len(self.dh_params) + 1

    def keypoints_from_fk(self, fk_points: torch.Tensor) -> torch.Tensor:
        """The keypoint set from FK chain origins (..., rows+1, 3); slices, so
        no index tensor is copied to the device."""
        if self.keypoint_fk_indices is None:
            return fk_points
        return torch.stack([fk_points[..., i, :] for i in self.keypoint_fk_indices], -2)

    def base_rotation(self, view: str | None) -> np.ndarray:
        """(3, 3) base correction matrix for a named view (identity if none)."""
        if view is None or view not in self.view_base_rotations_zyx_deg:
            return np.eye(3, dtype=np.float32)
        angles = torch.tensor(self.view_base_rotations_zyx_deg[view], dtype=torch.float32)
        return euler_zyx_deg_to_matrix(angles).numpy()


FR3 = RobotSpec(
    name="fr3",
    convention="modified",
    dh_params=(
        (0.0, 0.333, 0.0, 0.0),
        (0.0, 0.0, -90.0, 0.0),
        (0.0, 0.316, 90.0, 0.0),
        (0.0825, 0.0, 90.0, 0.0),
        (-0.0825, 0.384, -90.0, 0.0),
        (0.0, 0.0, 90.0, 0.0),
        (0.088, 0.0, 90.0, 0.0),
    ),
    angle_unit="rad",
    view_base_rotations_zyx_deg={
        "view1": (90.0, 180.0, 0.0),
        "view2": (90.0, 180.0, 0.0),
        "view3": (90.0, 180.0, 0.0),
        "view4": (90.0, 180.0, 0.0),
    },
    extrinsic_rvec_unit="rad",
    links=((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7)),
)

FR5 = RobotSpec(
    name="fr5",
    convention="standard",
    dh_params=(
        (0.0, 0.152, 90.0, 0.0),
        (-0.425, 0.0, 0.0, 0.0),
        (-0.395, 0.0, 0.0, 0.0),
        (0.0, 0.102, 90.0, 0.0),
        (0.0, 0.102, -90.0, 0.0),
        (0.0, 0.100, 0.0, 0.0),
    ),
    angle_unit="deg",
    view_base_rotations_zyx_deg={
        "top": (-85.0, 0.0, 180.0),
        "left": (180.0, 0.0, 90.0),
        "right": (0.0, 0.0, 90.0),
    },
    extrinsic_rvec_unit="deg",
    links=((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6)),
)

MECA500 = RobotSpec(
    name="meca500",
    convention="standard",
    dh_params=(
        (0.0, 0.135, -90.0, 0.0),
        (0.135, 0.0, 0.0, -90.0),
        (0.038, 0.0, -90.0, 0.0),
        (0.0, 0.120, 90.0, 0.0),
        (0.0, 0.0, -90.0, 0.0),
        (0.0, 0.070, 0.0, 0.0),
    ),
    angle_unit="deg",
    view_base_rotations_zyx_deg={},
    extrinsic_rvec_unit="deg",
    links=((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6)),
)

# The panda chain is the FR3 chain plus the passive flange row; DREAM's 7
# keypoints are chain origins 0, 2, 3, 4, 6, 7 and 8 (the flange).
DREAM_PANDA = dataclasses.replace(
    FR3,
    name="dream_panda",
    view_base_rotations_zyx_deg={},
    dh_params=FR3.dh_params + ((0.0, 0.107, 0.0, 0.0),),
    n_passive_rows=1,
    keypoint_fk_indices=(0, 2, 3, 4, 6, 7, 8),
    links=((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6)),
)

_REGISTRY = {r.name: r for r in (FR3, FR5, MECA500, DREAM_PANDA)}


def get_robot(name: str) -> RobotSpec:
    return _REGISTRY[name]


@functools.lru_cache(maxsize=32)
def _spec_tables(spec: RobotSpec, device: torch.device):
    """a, d, alpha (rad), theta offset (rad): f32 tensors on `device`, made
    once, so FK inside a step copies nothing to the card. Made outside
    inference mode (the table too: on the CPU `.to` returns it as is), so an
    FK with autograd may follow one under `torch.inference_mode`."""
    with torch.inference_mode(False):
        p = torch.tensor(spec.dh_params, dtype=torch.float32)
        return tuple(t.to(device) for t in (p[:, 0], p[:, 1], torch.deg2rad(p[:, 2]),
                                            torch.deg2rad(p[:, 3])))


def forward_kinematics(spec: RobotSpec, joint_angles: torch.Tensor,
                       base_rotation: torch.Tensor | None = None) -> torch.Tensor:
    """Joint angles (..., n_joints) -> chain origins (..., rows+1, 3) in the
    robot base frame; row 0 is the base. `base_rotation` (3, 3) or
    (..., 3, 3) is the optional per-view base correction."""
    angles = joint_angles.float()
    a, d, alpha, theta_off = _spec_tables(spec, angles.device)
    if spec.angle_unit == "deg":
        angles = torch.deg2rad(angles)
    if spec.n_passive_rows:
        angles = torch.cat([angles, angles.new_zeros(*angles.shape[:-1], spec.n_passive_rows)], -1)
    theta = angles + theta_off
    T = torch.eye(4, dtype=torch.float32, device=angles.device).expand(*angles.shape[:-1], 4, 4)
    if base_rotation is not None:
        R = torch.as_tensor(base_rotation, dtype=torch.float32, device=angles.device)
        T = T.clone()
        T[..., :3, :3] = R
    dh_matrix = standard_dh_matrix if spec.convention == "standard" else modified_dh_matrix
    positions = [torch.zeros_like(T[..., :3, 3])]
    for i in range(theta.shape[-1]):
        T = T @ dh_matrix(a[i], d[i], alpha[i], theta[..., i])
        positions.append(T[..., :3, 3])
    return torch.stack(positions, -2)


def forward_kinematics_batch(spec: RobotSpec, joint_angles: torch.Tensor,
                             base_rotation: torch.Tensor | None = None) -> torch.Tensor:
    """Batched FK (B, n_joints) -> (B, rows+1, 3), the reference's name for it."""
    return forward_kinematics(spec, joint_angles, base_rotation)
