"""Embedding-space visualization: t-SNE + PCA of dev/eval embeddings with
the loss centers (the reference's visualize.py), the port's own copy of the
JAX package's ``visualize.py``. It runs on the host over numpy arrays;
sklearn and matplotlib (Agg) are imported only when a figure is drawn.
The embeddings come from the port's models (``cli.visualize``, the
training loop's ``visualize``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def visualize_dev_and_eval(
    dev_feat: np.ndarray,
    dev_labels: np.ndarray,
    eval_feat: Optional[np.ndarray],
    eval_labels: Optional[np.ndarray],
    center: np.ndarray,
    seed: int = 688,
    out_fold: str = ".",
    epoch: Optional[int] = None,
    sample: int = 5000,
) -> str:
    """2x2 grid: t-SNE and PCA of up to `sample` dev/eval embeddings plus the
    loss center(s). When no eval embeddings exist (training without
    --test_on_eval), pass ``eval_feat=None`` for a dev-only 2x1 figure —
    the reference always has real eval embeddings here; duplicating the
    dev points under an "Eval" title would be misleading. Returns the written PDF path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.decomposition import PCA
    from sklearn.manifold import TSNE

    rng = np.random.default_rng(888)
    center = np.atleast_2d(center)
    num_centers = center.shape[0]
    has_eval = eval_feat is not None

    ind_dev = rng.permutation(dev_feat.shape[0])[:sample]
    dev_s, dev_l = dev_feat[ind_dev], np.asarray(dev_labels)[ind_dev]
    if has_eval:
        ind_eval = rng.permutation(eval_feat.shape[0])[:sample]
        ev_s, ev_l = eval_feat[ind_eval], np.asarray(eval_labels)[ind_eval]
    else:
        ev_s = np.zeros((0, dev_s.shape[1]), dev_s.dtype)
        ev_l = np.zeros((0,), np.int64)

    X = np.concatenate([center, dev_s, ev_s], axis=0)
    n_dev = dev_s.shape[0]

    X_tsne = TSNE(
        random_state=seed, perplexity=min(40, max(5, X.shape[0] // 4 - 1)),
        early_exaggeration=40, init="random",
    ).fit_transform(X)
    pca = PCA(n_components=2)
    X_pca = pca.fit_transform(X)
    ex_ratio = pca.explained_variance_ratio_

    def split(Z):
        return Z[:num_centers], Z[num_centers:num_centers + n_dev], \
            Z[num_centers + n_dev:]

    n_cols = 2 if has_eval else 1
    fig, axes = plt.subplots(2, n_cols, figsize=(4 * n_cols, 8),
                             squeeze=False)
    for row, Z, title in ((0, X_tsne, "t-SNE"), (1, X_pca, "PCA")):
        c, d, e = split(Z)
        panels = ((d, dev_l, "Dev"), (e, ev_l, "Eval"))[:n_cols]
        for col, (feats, labels, part) in enumerate(panels):
            ax = axes[row][col]
            for lab, color, name in ((0, "#7030a0", "bonafide"),
                                     (1, "#ff0000", "spoof")):
                m = labels == lab
                ax.scatter(feats[m, 0], feats[m, 1], s=3, c=color, label=name)
            ax.scatter(c[:, 0], c[:, 1], s=60, c="#ffff00", marker="*",
                       edgecolors="k", label="center")
            suffix = f" (var {ex_ratio.sum():.2f})" if row == 1 else ""
            ax.set_title(f"{title} {part}{suffix}")
            ax.legend(markerscale=2, fontsize=7)

    os.makedirs(out_fold, exist_ok=True)
    tag = f"_epoch{epoch}" if epoch is not None else ""
    out = os.path.join(out_fold, f"embedding_vis{tag}.pdf")
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return out


