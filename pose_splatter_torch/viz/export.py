"""Gaussian export: npz / extended PLY / JSON / point-cloud PLY
(counterpart of ``pose_splatter_tpu/viz/export.py``).

The on-disk formats are the reference exporters' (npz keys, the extended
PLY's layout with scales as integer millimetres and int16 quaternions, the
sampled JSON), so external viewers read either package's files. The savers
are numpy, copied; :func:`extract_world_gaussians` runs the model.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from pose_splatter_torch.utils.geometry import yaw_rotation


def extract_world_gaussians(model, mask, img, p_3d, angle,
                            center_means: bool = True) -> Dict[str, np.ndarray]:
    """Run carve → U-Nets → Gaussian head for one frame; return world-space
    Gaussian parameters as numpy, valid slots only, in selection order.

    Means are yawed by the frame's angle and shifted by ``p_3d``;
    quaternions stay as the head gives them (``export.py:31-41``).
    ``center`` [1, 3] is the mean of the valid means, subtracted from them
    if ``center_means``. 3D models only: a 2D model's Gaussians have no
    ``means`` (KeyError, as in the JAX package)."""
    with torch.no_grad():
        g, _ = model.frame_gaussians(mask, img, p_3d, angle)
        means = (g["means"] @ yaw_rotation(angle, model.device).T
                 + model._tensor(p_3d))
        arrays = dict(means=means, quaternions=g["quats"],
                      scales=torch.exp(g["log_scales"]),
                      opacities=torch.sigmoid(g["logit_opacities"]),
                      colors=g["colors"])
    model.check_selection()
    keep = g["valid"].cpu().numpy()
    out = {k: v.cpu().numpy()[keep] for k, v in arrays.items()}
    center = out["means"].mean(axis=0, keepdims=True)
    if center_means:
        out["means"] = out["means"] - center
    out["center"] = center
    return out


def save_npz(g: Dict[str, np.ndarray], filename: str) -> str:
    np.savez_compressed(
        filename,
        means=g["means"],
        quaternions=g["quaternions"],
        scales=g["scales"],
        opacities=g["opacities"],
        colors=g["colors"],
        center=g["center"],
        metadata={
            "format": "gaussian_splatting_full",
            "num_gaussians": len(g["means"]),
            "version": "1.0",
        },
    )
    return filename


def save_ply_extended(g: Dict[str, np.ndarray], filename: str) -> str:
    """Extended PLY: float xyz, uchar rgba, int16 quats, mm-int scales."""
    means = g["means"]
    colors = np.clip(g["colors"], 0, 1)
    colors_u8 = (colors * 255).astype(np.uint8)
    opac_u8 = (np.asarray(g["opacities"]) * 255).astype(np.uint8).reshape(-1)
    scales_mm = (g["scales"] * 1000).astype(np.int32)
    quats_i16 = (g["quaternions"] * 32767).astype(np.int16)

    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write("comment Gaussian Splatting Extended Format\n")
        f.write(f"element vertex {len(means)}\n")
        for p in ("x", "y", "z"):
            f.write(f"property float {p}\n")
        for p in ("red", "green", "blue", "alpha"):
            f.write(f"property uchar {p}\n")
        for p in ("quat_w", "quat_x", "quat_y", "quat_z"):
            f.write(f"property short {p}\n")
        for p in ("scale_x", "scale_y", "scale_z"):
            f.write(f"property int {p}\n")
        f.write("end_header\n")
        for i in range(len(means)):
            f.write(f"{means[i,0]} {means[i,1]} {means[i,2]} ")
            f.write(f"{colors_u8[i,0]} {colors_u8[i,1]} {colors_u8[i,2]} {opac_u8[i]} ")
            f.write(f"{quats_i16[i,0]} {quats_i16[i,1]} {quats_i16[i,2]} {quats_i16[i,3]} ")
            f.write(f"{scales_mm[i,0]} {scales_mm[i,1]} {scales_mm[i,2]}\n")
    return filename


def save_ply_pointcloud(g: Dict[str, np.ndarray], filename: str) -> str:
    """Plain colored point cloud (export_point_cloud.py contract)."""
    means = g["means"]
    colors_u8 = (np.clip(g["colors"], 0, 1) * 255).astype(np.uint8)
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(means)}\n")
        for p in ("x", "y", "z"):
            f.write(f"property float {p}\n")
        for p in ("red", "green", "blue"):
            f.write(f"property uchar {p}\n")
        f.write("end_header\n")
        for i in range(len(means)):
            f.write(f"{means[i,0]} {means[i,1]} {means[i,2]} ")
            f.write(f"{colors_u8[i,0]} {colors_u8[i,1]} {colors_u8[i,2]}\n")
    return filename


def save_json(g: Dict[str, np.ndarray], filename: str,
              max_gaussians: int = 100) -> str:
    """Sampled JSON for inspection (first ``max_gaussians`` evenly spaced)."""
    means = g["means"]
    n = min(max_gaussians, len(means))
    idx = np.linspace(0, len(means) - 1, n, dtype=int)
    data = {
        "metadata": {
            "format": "gaussian_splatting_full",
            "num_gaussians": len(means),
            "version": "1.0",
        },
        "center": np.asarray(g["center"]).tolist(),
        "gaussians": [
            {
                "position": means[i].tolist(),
                "quaternion": g["quaternions"][i].tolist(),
                "scale": g["scales"][i].tolist(),
                "opacity": float(g["opacities"][i]),
                "color": g["colors"][i].tolist(),
            }
            for i in idx
        ],
    }
    with open(filename, "w") as f:
        json.dump(data, f, indent=2)
    return filename


SAVERS = {"npz": save_npz, "ply_extended": save_ply_extended,
          "json": save_json, "ply": save_ply_pointcloud}
EXTENSIONS = {"npz": "npz", "ply_extended": "ply", "json": "json", "ply": "ply"}


def export_animation_sequence(model, dataset, frame_range, output_dir: str,
                              format_type: str = "npz",
                              progress: bool = True):
    """Multi-frame export loop (export_animation_sequence.py contract):
    ``gaussian_frame{frame:04d}.{ext}`` a frame in ``output_dir``."""
    os.makedirs(output_dir, exist_ok=True)
    saver = SAVERS[format_type]
    paths = []
    for frame in frame_range:
        mask, img, p_3d, angle, _ = dataset.get(frame, view_idx=0)
        g = extract_world_gaussians(model, mask, img, p_3d, angle)
        fn = os.path.join(output_dir,
                          f"gaussian_frame{frame:04d}.{EXTENSIONS[format_type]}")
        paths.append(saver(g, fn))
        if progress and (frame + 1) % 50 == 0:
            print(f"  exported frame {frame}")
    return paths
