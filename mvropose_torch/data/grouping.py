"""Multi-view temporal grouping: port of `mvropose_tpu/data/grouping.py`
(`group_by_time_tolerance` and `tolerance_grid_search`) on the port's CSV
`Table`.

Rows are ordered by timestamp as pandas orders them (`Table.sort_values`:
numpy's unstable quicksort, so tied timestamps, the rule for FR3 rows synced
to one joint record, keep pandas' order and with it each group's view
order). A new group starts when the gap to the group's FIRST timestamp
exceeds the tolerance or the group is full; the group's joint angles come
from its first row.
"""

from __future__ import annotations

import re
from typing import Mapping, Sequence

import numpy as np

from mvropose_torch.data.table import Table


def group_by_time_tolerance(
    df: Table,
    tolerance_s: float,
    max_views: int,
    ts_col: str = "robot_timestamp",
    angle_cols: Sequence[str] | None = None,
    min_views: int = 1,
) -> list[dict]:
    """-> [{"views": [{"image_path": ...}], "joint_angles": [...],
            "timestamp": float}]"""
    if df.empty:
        return []
    if angle_cols is None:
        # position_<name> (FR3 YAML schema) or joint_<N> (per-file schema);
        # excludes joint_timestamp / joint_path bookkeeping columns.
        angle_cols = [c for c in df.columns
                      if c.startswith("position_") or re.fullmatch(r"joint_\d+", c)]
    df = df.sort_values(ts_col)
    ts = df[ts_col]
    paths = df["image_path"].tolist()
    angles = df[list(angle_cols)].to_numpy(float)
    groups: list[dict] = []
    start_i = 0
    for i in range(1, len(df) + 1):
        if i == len(df) or ts[i] - ts[start_i] > tolerance_s or i - start_i >= max_views:
            groups.append({
                "views": [{"image_path": paths[j]} for j in range(start_i, i)],
                "joint_angles": angles[start_i].tolist(),
                "timestamp": float(ts[start_i]),
            })
            start_i = i
    if min_views > 1:
        groups = [g for g in groups if len(g["views"]) >= min_views]
    return groups


def tolerance_grid_search(
    df: Table,
    candidates: Sequence[float],
    max_views: int,
    ts_col: str = "robot_timestamp",
    angle_cols: Sequence[str] | None = None,
) -> tuple[float, dict[float, Mapping[int, int]]]:
    """The tolerance with the most FULL (`max_views`) groups, the first on a
    tie -> (best tolerance, {tolerance: {group size: count}})."""
    distributions: dict[float, Mapping[int, int]] = {}
    best_tol, best_full = float(candidates[0]), -1
    for tol in candidates:
        groups = group_by_time_tolerance(df, tol, max_views, ts_col, angle_cols)
        sizes, counts = np.unique([len(g["views"]) for g in groups], return_counts=True)
        distributions[tol] = {int(k): int(v) for k, v in zip(sizes, counts)}
        full = distributions[tol].get(max_views, 0)
        if full > best_full:
            best_full, best_tol = full, float(tol)
    return best_tol, distributions
