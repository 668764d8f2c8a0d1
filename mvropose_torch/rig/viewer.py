"""Host-side visualization: skeleton overlays + tiled multi-camera canvas.

A copy of `mvropose_tpu/rig/viewer.py` (numpy and cv2 only), so that the port
imports nothing of the JAX package;
`tests/test_torch_cli_tools.py::test_viewer_copy_matches_reference` holds the
two bit-equal on the same inputs.

Equivalent of the original project's display loop (DIP_REAL.py:218-258): top
view over a left|right bottom row, placeholder panels for failed cameras,
aspect-preserving fit to the screen. Pure numpy/cv2 - viz is host work by
design.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np


def draw_keypoints_overlay(
    image: np.ndarray,  # (H, W, 3) uint8, modified in place on a copy
    keypoints: np.ndarray,  # (J, 2) image px
    links: Sequence[tuple[int, int]],
    scores: np.ndarray | None = None,
    min_score: float = 0.0,
    color=(0, 255, 0),
) -> np.ndarray:
    import cv2

    out = image.copy()
    J = len(keypoints)
    ok = np.ones(J, bool)
    if scores is not None:
        ok = np.asarray(scores) >= min_score
    ok &= np.isfinite(keypoints).all(axis=-1)
    for j, (x, y) in enumerate(keypoints):
        if ok[j]:
            cv2.circle(out, (int(x), int(y)), 5, color, -1)
    for a, b in links:
        if a < J and b < J and ok[a] and ok[b]:
            cv2.line(
                out,
                (int(keypoints[a][0]), int(keypoints[a][1])),
                (int(keypoints[b][0]), int(keypoints[b][1])),
                color,
                2,
            )
    return out


def _placeholder(hw: tuple[int, int]) -> np.ndarray:
    import cv2

    img = np.zeros((*hw, 3), np.uint8)
    cv2.putText(
        img, "Camera Not Found", (hw[1] // 3, hw[0] // 2),
        cv2.FONT_HERSHEY_SIMPLEX, 1.5, (255, 255, 255), 2, cv2.LINE_AA,
    )
    return img


def tile_frames(
    frames: Mapping[str, Optional[np.ndarray]],
    layout: tuple[Sequence[str], ...] = (("top",), ("left", "right")),
    frame_hw: tuple[int, int] = (720, 1280),
    max_wh: tuple[int, int] = (1800, 950),
) -> np.ndarray:
    """Tile named frames into rows; None/missing -> placeholder panel."""
    import cv2

    rows = []
    for names in layout:
        tiles = []
        for n in names:
            f = frames.get(n)
            tiles.append(f if f is not None else _placeholder(frame_hw))
        min_h = min(t.shape[0] for t in tiles)
        tiles = [
            cv2.resize(t, (int(t.shape[1] * min_h / t.shape[0]), min_h)) for t in tiles
        ]
        rows.append(np.hstack(tiles))
    max_w = max(r.shape[1] for r in rows)
    rows = [
        np.pad(r, ((0, 0), (0, max_w - r.shape[1]), (0, 0))) if r.shape[1] < max_w else r
        for r in rows
    ]
    canvas = np.vstack(rows)
    h, w = canvas.shape[:2]
    scale = min(max_wh[0] / w, max_wh[1] / h)
    if scale < 1.0:
        canvas = cv2.resize(canvas, (int(w * scale), int(h * scale)), interpolation=cv2.INTER_AREA)
    return canvas
