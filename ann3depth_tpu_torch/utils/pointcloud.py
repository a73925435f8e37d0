"""Depth map -> 3-D point cloud export (PLY).

Counterpart of `ann3depth_tpu/utils/pointcloud.py`, the same numpy code:
back-project a predicted depth map through a centered pinhole camera
(horizontal field of view, default 55 degrees) into a colored point cloud
that standard viewers (MeshLab, CloudCompare, Open3D) open. Host-side I/O,
once per exported frame.
"""

from __future__ import annotations

import numpy as np

DEFAULT_FOV_DEG = 55.0


def intrinsics_from_fov(hw, fov_deg=DEFAULT_FOV_DEG):
    """(fx, fy, cx, cy) for a centered pinhole with the given HORIZONTAL
    field of view and square pixels. hw = (height, width) in pixels."""
    h, w = hw
    if not 0.0 < fov_deg < 180.0:
        raise ValueError(f"fov_deg must be in (0, 180), got {fov_deg}")
    fx = (w / 2.0) / np.tan(np.deg2rad(fov_deg) / 2.0)
    return fx, fx, w / 2.0, h / 2.0


def backproject(depth, rgb=None, fov_deg=DEFAULT_FOV_DEG, depth_eps=1e-3):
    """Back-project a depth map to camera-frame points.

    Args:
      depth: [H, W] (or [H, W, 1]) linear depth in meters (z along the
        optical axis — the quantity the models predict, exp(log-depth)).
      rgb: optional [H, W, 3] uint8 image at the SAME resolution; colors
        ride along per point.
      fov_deg: horizontal field of view of the pinhole model.
      depth_eps: pixels with depth <= eps are dropped (invalid/masked).

    Returns (points [N, 3] float32, colors [N, 3] uint8 or None). Camera
    frame: +x right, +y down, +z forward (image convention).
    """
    depth = np.asarray(depth, np.float32)
    if depth.ndim == 3 and depth.shape[-1] == 1:
        depth = depth[..., 0]
    if depth.ndim != 2:
        raise ValueError(f"depth must be [H, W], got shape {depth.shape}")
    h, w = depth.shape
    fx, fy, cx, cy = intrinsics_from_fov((h, w), fov_deg)
    # Pixel centers: u = col + 0.5 so the grid is symmetric about cx.
    u = np.arange(w, dtype=np.float32) + 0.5
    v = np.arange(h, dtype=np.float32) + 0.5
    uu, vv = np.meshgrid(u, v)
    z = depth
    x = (uu - cx) * z / fx
    y = (vv - cy) * z / fy
    valid = z > depth_eps
    pts = np.stack([x[valid], y[valid], z[valid]], axis=-1).astype(np.float32)
    colors = None
    if rgb is not None:
        rgb = np.asarray(rgb)
        if rgb.shape[:2] != (h, w):
            raise ValueError(
                f"rgb {rgb.shape[:2]} does not match depth {(h, w)}; "
                "resize the image to the depth resolution first")
        colors = rgb[valid].astype(np.uint8)
    return pts, colors


def write_ply(path, points, colors=None, binary=True):
    """Write points [N, 3] (+ optional uint8 colors [N, 3]) as PLY."""
    points = np.ascontiguousarray(points, np.float32)
    n = points.shape[0]
    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        colors = np.ascontiguousarray(colors, np.uint8)
        if colors.shape != (n, 3):
            raise ValueError(f"colors {colors.shape} != ({n}, 3)")
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            if colors is None:
                f.write(points.tobytes())
            else:
                rec = np.empty(n, dtype=[("xyz", np.float32, 3),
                                         ("rgb", np.uint8, 3)])
                rec["xyz"], rec["rgb"] = points, colors
                f.write(rec.tobytes())
        else:
            for i in range(n):
                row = "%.6g %.6g %.6g" % tuple(points[i])
                if colors is not None:
                    row += " %d %d %d" % tuple(colors[i])
                f.write((row + "\n").encode("ascii"))


def read_ply(path):
    """Parse a PLY written by write_ply (either format). Returns
    (points [N, 3] f32, colors [N, 3] u8 or None). Test/round-trip aid."""
    with open(path, "rb") as f:
        blob = f.read()
    end = blob.index(b"end_header\n") + len(b"end_header\n")
    lines = blob[:end].decode("ascii").splitlines()
    binary = any("binary_little_endian" in l for l in lines)
    n = int(next(l.split()[-1] for l in lines if l.startswith("element vertex")))
    has_color = any("uchar red" in l for l in lines)
    body = blob[end:]
    if binary:
        dt = ([("xyz", np.float32, 3), ("rgb", np.uint8, 3)] if has_color
              else [("xyz", np.float32, 3)])
        rec = np.frombuffer(body, dtype=dt, count=n)
        return (rec["xyz"].copy(),
                rec["rgb"].copy() if has_color else None)
    rows = body.decode("ascii").split()
    k = 6 if has_color else 3
    arr = np.asarray(rows, dtype=np.float64).reshape(n, k)
    pts = arr[:, :3].astype(np.float32)
    return pts, (arr[:, 3:6].astype(np.uint8) if has_color else None)


def depth_to_ply(path, depth, rgb=None, fov_deg=DEFAULT_FOV_DEG,
                 binary=True):
    """One-call export: back-project + write. Returns the point count."""
    pts, colors = backproject(depth, rgb=rgb, fov_deg=fov_deg)
    write_ply(path, pts, colors, binary=binary)
    return pts.shape[0]
