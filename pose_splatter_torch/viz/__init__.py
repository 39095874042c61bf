"""Visualisation and export (counterpart of ``pose_splatter_tpu/viz``)."""

from pose_splatter_torch.viz.export import (  # noqa: F401
    extract_world_gaussians,
    save_json,
    save_npz,
    save_ply_extended,
    save_ply_pointcloud,
)
