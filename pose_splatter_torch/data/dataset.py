"""Frame dataset and host-side loader (a copy of
``pose_splatter_tpu/data/dataset.py``; the port imports nothing of the JAX
package).

- Frames are stored as uint8 [T, C, H, W, 3], read from ``images.zarr``
  (key ``images``) when zarr is importable and the store exists, else from
  ``images.h5``. ``h5py`` and ``zarr`` are imported inside
  ``FrameDataset.__init__``: a machine without them can still import the
  module and use another dataset (``utils/synthetic.py::FrameSet``).
- The mask comes from the white background: after ``/255`` a pixel is
  background iff its red channel equals 1.0.
- Per-frame centers and angles come from ``center_rotation.npz``.
- Splits: train / valid / test = first / middle / last thirds; ``"all"``
  enumerates frame × view.
- Only observed (non-holdout) views are returned, channel-last.

Not ported: the native C++ decode (``decode_frame`` runs the NumPy path,
which gives the same values).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np


def decode_frame(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 [C,H,W,3] → (mask [C,H,W] f32, img [C,H,W,3] f32 in [0,1])."""
    img = raw.astype(np.float32) / 255.0
    mask = np.where(img[..., 0] == 1.0, 0.0, 1.0).astype(np.float32)
    return mask, img


class FrameDataset:
    """Random access to (mask, img, p_3d, angle, view_idx) samples."""

    SPLITS = ("train", "valid", "test", "all", "all_volumes")

    def __init__(
        self,
        img_fn: str,
        angle_fn: str,
        C: int,
        holdout_views: Sequence[int] = (),
        split: str = "train",
        max_frames: Optional[int] = None,
        seed: int = 0,
    ):
        if split not in self.SPLITS:
            raise ValueError(f"unknown split {split}")
        self.split = split
        self.C = C
        self.observed_views = np.array(
            [i for i in range(C) if i not in holdout_views], dtype=int)
        self._rng = np.random.default_rng(seed)

        zarr_fn = img_fn[:-3] + ".zarr" if img_fn.endswith(".h5") else img_fn
        try:
            import zarr
        except ImportError:
            zarr = None
        if zarr is not None and os.path.exists(zarr_fn):
            self.images = zarr.open(zarr_fn, "r")["images"]
        else:
            import h5py

            self._h5 = h5py.File(img_fn, "r")
            self.images = self._h5["images"]

        T = len(self.images)
        if max_frames is not None:
            T = min(T, max_frames)
        a1, a2 = 0, T // 3
        a3, a4 = 2 * a2, T
        if split == "train":
            self.i1, self.i2 = a1, a2
        elif split == "valid":
            self.i1, self.i2 = a2, a3
        elif split == "test":
            self.i1, self.i2 = a3, a4
        else:
            self.i1, self.i2 = a1, a4

        d = np.load(angle_fn)
        self.angles = d["angles"]
        self.centers = d["centers"]

    def __len__(self) -> int:
        if self.split == "all":
            return (self.i2 - self.i1) * self.C
        return self.i2 - self.i1

    def get(self, idx: int, view_idx: Optional[int] = None,
            angle_offset: float = 0.0, center_offset: float = 0.0):
        """Returns (mask [C',H,W], img [C',H,W,3], p_3d [3], angle, view_idx)."""
        if self.split == "all":
            view_idx = idx % self.C
            idx = idx // self.C
        idx += self.i1
        if view_idx is None:
            view_idx = int(self._rng.choice(self.observed_views))

        raw = np.asarray(self.images[idx])  # [C,H,W,3] uint8
        mask, img = decode_frame(raw)
        mask = mask[self.observed_views]
        img = img[self.observed_views]

        p_3d = (self.centers[idx] + center_offset).astype(np.float32)
        angle = float(self.angles[idx] + angle_offset)
        return mask, img, p_3d, angle, view_idx

    def __getitem__(self, idx):
        return self.get(idx)


class FrameLoader:
    """Shuffling, batching and multi-threaded background prefetch.

    Yields batch dicts matching ``make_train_step``:
        mask [B,C',H,W], img [B,C',H,W,3], p_3d [B,3], angle [B],
        view_idx [B] int32, obs_idx [B] int32, and with ``adaptive_fn``
        K_mask [B,C',3,3] and seed_3d [B,3] (float32).

    ``dataset`` is a :class:`FrameDataset` or anything with its ``get``,
    ``__len__``, ``observed_views``, ``split`` and ``_rng``. ``workers``
    threads build batches concurrently (read and decode release the GIL);
    up to ``prefetch + workers`` batches are in flight, yielded in order.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2, drop_last: bool = True,
                 adaptive_fn=None, workers: int = 4):
        """``adaptive_fn(mask [C',H,W]) -> (temp_K [C',3,3], seed [3])`` is
        the adaptive camera's host hook (``PoseSplatter.make_adaptive_fn``),
        run here on each frame's numpy mask in the loader's threads: the
        batch gains ``K_mask`` (the frame's intrinsics for the observed
        views) and ``seed_3d`` (where the carve grid sits). ``p_3d`` stays
        the dataset's center, which the pose transform uses."""
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.adaptive_fn = adaptive_fn
        self.workers = max(1, workers)
        self._rng = np.random.default_rng(seed)
        obs = list(dataset.observed_views)
        self._obs_pos = {v: i for i, v in enumerate(obs)}

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _make_batch(self, idxs: np.ndarray,
                    view_choices: Optional[np.ndarray] = None
                    ) -> Dict[str, np.ndarray]:
        masks, imgs, p3ds, angles, views, obs = [], [], [], [], [], []
        k_masks, seeds = [], []
        for j, i in enumerate(idxs):
            v_pre = None if view_choices is None else int(view_choices[j])
            m, im, p, a, v = self.ds.get(int(i), view_idx=v_pre)
            if self.adaptive_fn is not None:
                temp_K, seed = self.adaptive_fn(m)
                k_masks.append(np.asarray(temp_K, np.float32))
                seeds.append(np.asarray(seed, np.float32))
            masks.append(m)
            imgs.append(im)
            p3ds.append(p)
            angles.append(a)
            views.append(v)
            obs.append(self._obs_pos[v])
        batch = dict(
            mask=np.stack(masks),
            img=np.stack(imgs),
            p_3d=np.stack(p3ds),
            angle=np.array(angles, np.float32),
            view_idx=np.array(views, np.int32),
            obs_idx=np.array(obs, np.int32),
        )
        if k_masks:
            batch["K_mask"] = np.stack(k_masks)
            batch["seed_3d"] = np.stack(seeds)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        n_batches = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_batches)]
        # Pre-draw the per-sample view choices in iteration order so the
        # thread pool cannot perturb determinism (the dataset's _rng is
        # shared and not thread-safe).
        views = [
            self.ds._rng.choice(self.ds.observed_views, size=len(b)).astype(np.int64)
            if self.ds.split != "all" else None
            for b in batches
        ]

        if self.prefetch <= 0:
            for b, v in zip(batches, views):
                yield self._make_batch(b, v)
            return

        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        n_workers = min(self.workers, max(1, n_batches))
        window = self.prefetch + n_workers
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            futs: deque = deque()
            next_i = 0
            while next_i < n_batches and len(futs) < window:
                futs.append(ex.submit(self._make_batch, batches[next_i],
                                      views[next_i]))
                next_i += 1
            while futs:
                yield futs.popleft().result()
                if next_i < n_batches:
                    futs.append(ex.submit(self._make_batch, batches[next_i],
                                          views[next_i]))
                    next_i += 1
