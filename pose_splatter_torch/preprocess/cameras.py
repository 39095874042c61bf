"""Camera-parameter conversion: pickle → HDF5 (a copy of
``pose_splatter_tpu/preprocess/cameras.py``; numpy, ``h5py`` imported where
it is used).

Parity with the reference's ``scripts/preprocessing/convert_camera_params.py:10-68``:
input is a pickle list of dicts with keys ``K`` [3,3], ``R`` [3,3], ``T``
[3]/[3,1]; output is HDF5 ``/camera_parameters/{intrinsic,rotation,translation}``.
"""

from __future__ import annotations

import pickle

import numpy as np


def convert_camera_params(pkl_path: str, h5_path: str) -> int:
    """Convert and return the number of cameras written."""
    import h5py

    with open(pkl_path, "rb") as f:
        cams = pickle.load(f)

    intrinsics, rotations, translations = [], [], []
    for cam in cams:
        K, R, T = np.asarray(cam["K"]), np.asarray(cam["R"]), np.asarray(cam["T"])
        if T.ndim == 2:
            T = T.flatten()
        intrinsics.append(K)
        rotations.append(R)
        translations.append(T)

    with h5py.File(h5_path, "w") as f:
        grp = f.create_group("camera_parameters")
        grp.create_dataset("intrinsic", data=np.array(intrinsics))
        grp.create_dataset("rotation", data=np.array(rotations))
        grp.create_dataset("translation", data=np.array(translations))
    return len(cams)
