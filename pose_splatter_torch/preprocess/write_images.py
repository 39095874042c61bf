"""Preprocessing step 4: decode videos → masked white-background images.h5
(a copy of ``pose_splatter_tpu/preprocess/write_images.py``; ``h5py``,
``joblib`` and ``zarr`` imported where they are used).

Parity with the reference's ``scripts/preprocessing/write_images.py``:
joblib process-parallel over frame chunks, downsample by slicing, white-out
where the mask is < 128, chunked ``images_%04d.h5`` then concatenated to
``images.h5`` [T, C, h, w, 3] uint8 gzip.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np


def process_chunk_write_images(config_dict: dict, chunk_num: int,
                               frame_list: Sequence[int]) -> str:
    """Write one chunk's frames to ``images_<chunk>.h5``; returns the path."""
    import h5py

    from pose_splatter_torch.preprocess.video import iter_masked_rgb_frames

    ds = config_dict["image_downsample"]
    C = len(config_dict["video_fns"])
    h = config_dict["image_height"] // ds
    w = config_dict["image_width"] // ds
    out_fn = os.path.join(
        config_dict["image_directory"], f"images_{chunk_num:04d}.h5"
    )
    with h5py.File(out_fn, "w") as hdf:
        dset = hdf.create_dataset(
            "images",
            (len(frame_list), C, h, w, 3),
            dtype="uint8",
            compression="gzip",
            compression_opts=config_dict.get("image_compression_level") or 2,
        )
        for n, (frame_idx, frames) in enumerate(
            iter_masked_rgb_frames(
                config_dict["mask_video_fns"],
                config_dict["video_fns"],
                frame_list,
                config_dict["frame_jump"],
                ds,
            )
        ):
            dset[n] = frames
    return out_fn


def concatenate_h5_files(input_files: List[str], output_file: str,
                         dataset_name: str = "images",
                         compression_level: int = 2) -> None:
    import h5py

    total = 0
    shape, dtype = None, None
    for fp in input_files:
        with h5py.File(fp, "r") as f:
            d = f[dataset_name]
            total += d.shape[0]
            if shape is None:
                shape, dtype = d.shape[1:], d.dtype
            elif d.shape[1:] != shape:
                raise ValueError(f"Dataset shape mismatch in {fp}")
    with h5py.File(output_file, "w") as out:
        dset = out.create_dataset(
            dataset_name, shape=(total,) + shape, dtype=dtype,
            compression="gzip", compression_opts=compression_level,
        )
        cur = 0
        for fp in input_files:
            with h5py.File(fp, "r") as f:
                d = f[dataset_name]
                dset[cur : cur + d.shape[0]] = d[:]
                cur += d.shape[0]


def write_images(config, n_jobs: int = None) -> str:
    """Full step-4 pipeline; returns the output images.h5 path."""
    import h5py  # noqa: F401  (required: fail before any decode)

    from pose_splatter_torch.preprocess.video import video_frame_count

    if n_jobs is None:
        n_jobs = len(os.sched_getaffinity(0))
    os.makedirs(config.image_directory, exist_ok=True)

    total = video_frame_count(config.mask_video_fns[0])
    frame_lists = np.array_split(
        np.arange(0, total, config.frame_jump), n_jobs
    )
    s_config = config.to_serializable()

    try:
        from joblib import Parallel, delayed

        files = Parallel(n_jobs=n_jobs)(
            delayed(process_chunk_write_images)(s_config, i, fl)
            for i, fl in enumerate(frame_lists) if len(fl)
        )
    except ImportError:  # pragma: no cover
        files = [
            process_chunk_write_images(s_config, i, fl)
            for i, fl in enumerate(frame_lists) if len(fl)
        ]

    out = os.path.join(config.image_directory, "images.h5")
    concatenate_h5_files(files, out,
                         compression_level=config.image_compression_level or 2)
    for fp in files:
        os.remove(fp)
    return out


def copy_h5_to_zarr(h5_fn: str, zarr_fn: str = None,
                    codec: str = "zstd", clevel: int = 3) -> str:
    """HDF5 → Zarr copy for chunked random access
    (``copy_to_zarr.py:28-95``). No-op with a warning if zarr is missing
    (the dataset reader falls back to HDF5)."""
    try:
        import zarr
        from zarr.codecs import BloscCodec
    except ImportError:
        print("zarr not installed; training will read images.h5 directly")
        return h5_fn
    import h5py

    if zarr_fn is None:
        zarr_fn = h5_fn[:-3] + ".zarr"
    with h5py.File(h5_fn, "r") as f:
        d = f["images"]
        root = zarr.open(zarr_fn, mode="w")
        arr = root.create_array(
            "images", shape=d.shape, chunks=(1,) + d.shape[1:], dtype=d.dtype,
        )
        for i in range(0, d.shape[0], 64):
            arr[i : i + 64] = d[i : i + 64]
    return zarr_fn
