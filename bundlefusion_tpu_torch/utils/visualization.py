"""Debug visualization (SiftVisualization analog).

Port of ``bundlefusion_tpu/utils/visualization.py``.

The reference dumps keypoint/match overlay images and match point clouds
for debugging (``SiftVisualization.{h,cpp}``). Host-side numpy/cv2.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return np.clip(np.nan_to_num(img) * 255.0, 0, 255).astype(np.uint8)


def draw_keypoints(color: np.ndarray, pos: np.ndarray, valid: np.ndarray,
                   scale: Optional[np.ndarray] = None) -> np.ndarray:
    """Keypoint overlay (``printKey``)."""
    import cv2

    img = _to_u8(color).copy()
    for i in range(len(pos)):
        if not valid[i]:
            continue
        c = (int(round(pos[i, 0])), int(round(pos[i, 1])))
        r = int(round(float(scale[i]))) if scale is not None else 3
        cv2.circle(img, c, max(r, 2), (0, 255, 0), 1)
    return img


def draw_matches(color_i, color_j, pos_i, pos_j, mask) -> np.ndarray:
    """Side-by-side match visualization (``printMatch``)."""
    import cv2

    a = _to_u8(color_i)
    b = _to_u8(color_j)
    H = max(a.shape[0], b.shape[0])
    canvas = np.zeros((H, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1] :] = b
    off = a.shape[1]
    for i in range(len(mask)):
        if not mask[i]:
            continue
        p = (int(round(pos_i[i, 0])), int(round(pos_i[i, 1])))
        q = (int(round(pos_j[i, 0])) + off, int(round(pos_j[i, 1])))
        cv2.line(canvas, p, q, (0, 200, 255), 1)
        cv2.circle(canvas, p, 3, (0, 255, 0), 1)
        cv2.circle(canvas, q, 3, (0, 255, 0), 1)
    return canvas


def depth_to_color(depth: np.ndarray, d_min: float = 0.1, d_max: float = 4.0) -> np.ndarray:
    """Depth colormap image (``convertDepthToColorSpace`` analog)."""
    import cv2

    t = (np.nan_to_num(depth, nan=d_max) - d_min) / max(d_max - d_min, 1e-6)
    u8 = np.clip(t * 255, 0, 255).astype(np.uint8)
    img = cv2.applyColorMap(u8, cv2.COLORMAP_TURBO)
    img[~np.isfinite(depth)] = 0
    return img


def normals_to_color(normals: np.ndarray) -> np.ndarray:
    return _to_u8((np.nan_to_num(normals) + 1.0) * 0.5)


def save_image(path: str, img: np.ndarray):
    import cv2

    cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img)


def matches_to_pointcloud_ply(path: str, p_world_i: np.ndarray, p_world_j: np.ndarray, mask: np.ndarray):
    """Matched 3D point pairs as a PLY line-soup-ish cloud
    (``saveKeyMatchToPointCloud``)."""
    pts = []
    for i in range(len(mask)):
        if mask[i]:
            pts.append(p_world_i[i])
            pts.append(p_world_j[i])
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    with open(path, "wb") as fh:
        hdr = [
            "ply", "format binary_little_endian 1.0",
            f"element vertex {len(pts)}",
            "property float x", "property float y", "property float z",
            "end_header",
        ]
        fh.write(("\n".join(hdr) + "\n").encode())
        fh.write(pts.astype("<f4").tobytes())
