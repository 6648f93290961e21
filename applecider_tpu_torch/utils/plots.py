"""Evaluation plots: confusion matrices, ROC and PR curves (counterpart of
``applecider_tpu/utils/plots.py``).

Re-provides the reference's evaluation figures
(``_archive/AppleCider/core/trainer.py:272-354`` confusion matrices,
``train_utils.py:174-241`` per-class ROC curves,
``AstroMiNN.py:374-725`` PR curves) with matplotlib; all functions return
the figure and optionally save to disk. matplotlib is imported inside each
function, so the package imports where it is not installed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from applecider_tpu_torch.ops.metrics import confusion_matrix


def _roc_points(scores: np.ndarray, positives: np.ndarray):
    order = np.argsort(-scores, kind="mergesort")
    pos = positives[order].astype(np.float64)
    tp = np.concatenate([[0.0], np.cumsum(pos)])
    fp = np.concatenate([[0.0], np.cumsum(1.0 - pos)])
    n_pos = max(pos.sum(), 1e-12)
    n_neg = max(len(pos) - pos.sum(), 1e-12)
    return fp / n_neg, tp / n_pos


def _pr_points(scores: np.ndarray, positives: np.ndarray):
    order = np.argsort(-scores, kind="mergesort")
    pos = positives[order].astype(np.float64)
    tp = np.cumsum(pos)
    precision = tp / np.arange(1, len(pos) + 1)
    recall = tp / max(pos.sum(), 1e-12)
    return recall, precision


def plot_confusion_matrix(
    preds: np.ndarray, labels: np.ndarray, class_names, normalize: bool = True,
    save_path: str | Path | None = None,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = confusion_matrix(preds, labels, len(class_names)).astype(np.float64)
    if normalize:
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(cm, cmap="Blues", vmin=0)
    ax.set_xticks(range(len(class_names)), class_names, rotation=45, ha="right")
    ax.set_yticks(range(len(class_names)), class_names)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, f"{cm[i, j]:.2f}" if normalize else f"{int(cm[i, j])}",
                    ha="center", va="center", fontsize=8)
    fig.colorbar(im)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def plot_roc_curves(probs: np.ndarray, labels: np.ndarray, class_names,
                    save_path: str | Path | None = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from applecider_tpu_torch.ops.metrics import _binary_roc_auc

    fig, ax = plt.subplots(figsize=(6, 5))
    for c, name in enumerate(class_names):
        pos = labels == c
        if not pos.any() or pos.all():
            continue
        fpr, tpr = _roc_points(probs[:, c], pos)
        auc = _binary_roc_auc(probs[:, c], pos)
        ax.plot(fpr, tpr, label=f"{name} (AUC {auc:.3f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.5)
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.legend(fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def plot_pr_curves(probs: np.ndarray, labels: np.ndarray, class_names,
                   save_path: str | Path | None = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from applecider_tpu_torch.ops.metrics import _binary_average_precision

    fig, ax = plt.subplots(figsize=(6, 5))
    for c, name in enumerate(class_names):
        pos = labels == c
        if not pos.any():
            continue
        recall, precision = _pr_points(probs[:, c], pos)
        ap = _binary_average_precision(probs[:, c], pos)
        ax.plot(recall, precision, label=f"{name} (AP {ap:.3f})")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.legend(fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def plot_redshift_scatter(pred_z: np.ndarray, true_z: np.ndarray,
                          save_path: str | Path | None = None):
    """Pred-vs-true redshift plot (reference utils_redshift.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(true_z, pred_z, s=6, alpha=0.5)
    lim = [0, max(float(np.max(true_z)), float(np.max(pred_z))) * 1.05]
    ax.plot(lim, lim, "k--", lw=0.5)
    ax.set_xlabel("true z")
    ax.set_ylabel("predicted z")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig
