"""Visual-pose embedding (stage 2): PCA → adversarial PCA → t-SNE plot (a
copy of ``pose_splatter_tpu/preprocess/visual_embedding.py``; host numpy,
``sklearn``, ``joblib`` and ``matplotlib`` imported where they are used).

Parity with the reference's
``scripts/preprocessing/calculate_visual_embedding.py``:
flatten features, center, PCA(2000), AAPCA(50, μ=1e2, pow_iter=20) with the
yaw (cos θ, sin θ) as the adversarial target, save ``embedding.npy``, and a
3-panel t-SNE plot colored by angle / height / time.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from pose_splatter_torch.preprocess.apca import AAPCA

PRE_PCA_COMPONENTS = 2000
PCA_COMPONENTS = 50


def calculate_visual_embedding(config, make_plot: bool = True) -> np.ndarray:
    from sklearn.decomposition import PCA
    from sklearn.metrics import r2_score

    embed = np.load(config.feature_fn)
    embed = embed.reshape(len(embed), -1).astype(np.float64)

    d = np.load(config.center_rotation_fn)
    angles = d["angles"][: len(embed)]
    centers = d["centers"][: len(embed)]
    angles2 = np.stack([np.cos(angles), np.sin(angles)], axis=1)

    embed -= np.mean(embed, axis=0, keepdims=True)

    n_pre = min(PRE_PCA_COMPONENTS, *embed.shape)
    pca = PCA(n_pre, random_state=42)
    embed = pca.fit_transform(embed)

    aapca = AAPCA(min(PCA_COMPONENTS, embed.shape[1]), mu=1e2, pow_iter=20,
                  random_state=42)
    temp_embed = aapca.fit_transform(embed, angles2)
    _, rec_angles = aapca.reconstruct(embed, angles2)
    print("angle-prediction r2 after AAPCA:", r2_score(angles2, rec_angles))
    embed = temp_embed

    out_fn = config.embedding_fn
    np.save(out_fn, embed)

    try:
        import joblib

        joblib.dump(pca, os.path.join(config.project_directory,
                                      "pca_model.joblib"))
        joblib.dump(aapca, os.path.join(config.project_directory,
                                        "aapca_model.joblib"))
    except ImportError:
        pass

    if make_plot:
        plot_tsne(config, embed, angles, centers)
    return embed


def plot_tsne(config, embed: np.ndarray, angles: np.ndarray,
              centers: np.ndarray) -> Optional[str]:
    """3-panel t-SNE scatter colored by angle / height / time."""
    try:
        import matplotlib

        matplotlib.use("agg")
        import matplotlib.pyplot as plt
        from sklearn.manifold import TSNE
    except ImportError:
        return None

    emb2 = TSNE(random_state=42).fit_transform(embed)
    np.random.seed(42)
    perm = np.random.permutation(len(emb2))
    time = np.linspace(0, 1, len(emb2))
    angles, centers, emb2, time = (
        angles[perm], centers[perm], emb2[perm], time[perm]
    )

    angles_c = angles % (2 * np.pi) / (2 * np.pi)
    heights = centers[:, -1] - np.min(centers[:, -1])
    heights = (heights / max(np.quantile(heights, 0.98), 1e-9)).clip(0, 1)

    _, axarr = plt.subplots(ncols=3, figsize=(10, 5))
    color_bys = [angles_c, heights, time]
    cmaps = [matplotlib.colormaps["hsv"], matplotlib.colormaps["viridis"],
             matplotlib.colormaps["viridis"]]
    for ax, colors, cmap in zip(axarr, color_bys, cmaps):
        plt.sca(ax)
        plt.scatter(emb2[:, 0], emb2[:, 1], c=cmap(colors), s=2.0, alpha=0.4)
        ax.set_aspect("equal")
        plt.axis("off")
    for ax, title in zip(axarr, ["Angle", "Height", "Time"]):
        ax.set_title(title)
    out = os.path.join(config.project_directory, "tsne.pdf")
    plt.savefig(out)
    plt.close("all")
    return out
