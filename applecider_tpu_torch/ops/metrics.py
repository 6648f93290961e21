"""Evaluation metric suite, host-side NumPy (the port's copy of
``applecider_tpu/ops/metrics.py``, which imports only NumPy).

Re-provides the reference's metrics:

* accuracy, top-3 accuracy (overall and per-class), macro F1
  — reference ``_archive/AppleCider/train_utils.py:155-251``
* macro ROC-AUC (one-vs-rest), macro AUPRC
  — reference ``train_utils.py:174-241``, ``AstroMiNN.py:575-631``
* composite score 0.4*acc + 0.3*top3 + 0.3*F1
  — reference ``_archive/AppleCider/utils.py:218-224``
* confusion matrix — reference ``core/trainer.py:272-354``
* redshift regression: MSE/MAE/bias/sigma_NMAD/outlier-rate(>0.15)
  — reference ``preprocess/utils_redshift.py:85-91``
* dirichlet-random PR-AUC floor — reference ``AstroMiNN.py:1404-1434``
* the early-classification report of per-alert serving output.
"""

from __future__ import annotations

import numpy as np


def accuracy(probs: np.ndarray, labels: np.ndarray) -> float:
    return float(np.mean(np.argmax(probs, axis=-1) == labels))


def topk_accuracy(probs: np.ndarray, labels: np.ndarray, k: int = 3) -> float:
    topk = np.argsort(-probs, axis=-1)[:, :k]
    return float(np.mean(np.any(topk == labels[:, None], axis=-1)))


def per_class_topk_accuracy(probs: np.ndarray, labels: np.ndarray, k: int = 3) -> dict[int, float]:
    out = {}
    topk = np.argsort(-probs, axis=-1)[:, :k]
    hit = np.any(topk == labels[:, None], axis=-1)
    for c in np.unique(labels):
        mask = labels == c
        out[int(c)] = float(np.mean(hit[mask]))
    return out


def confusion_matrix(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (labels.astype(int), preds.astype(int)), 1)
    return cm


def macro_f1(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> float:
    cm = confusion_matrix(preds, labels, num_classes)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    # sklearn convention: classes with no support AND no predictions give F1=0
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-12), 0.0)
    present = (cm.sum(axis=1) + cm.sum(axis=0)) > 0
    if not present.any():
        return 0.0
    return float(np.mean(f1[present]))


def _binary_roc_auc(scores: np.ndarray, positives: np.ndarray) -> float:
    """ROC-AUC via the Mann-Whitney U statistic with tie correction."""
    n_pos = int(positives.sum())
    n_neg = len(positives) - n_pos
    if n_pos == 0 or n_neg == 0:
        return np.nan
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    # average ranks over ties
    i = 0
    rank_vals = np.arange(1, len(scores) + 1, dtype=np.float64)
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        rank_vals[i : j + 1] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    ranks[order] = rank_vals
    sum_pos = ranks[positives].sum()
    return float((sum_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def macro_roc_auc(probs: np.ndarray, labels: np.ndarray) -> float:
    """One-vs-rest macro ROC-AUC over classes present in ``labels``."""
    aucs = []
    for c in range(probs.shape[1]):
        pos = labels == c
        if pos.any() and (~pos).any():
            aucs.append(_binary_roc_auc(probs[:, c], pos))
    return float(np.nanmean(aucs)) if aucs else np.nan


def _binary_average_precision(scores: np.ndarray, positives: np.ndarray) -> float:
    n_pos = int(positives.sum())
    if n_pos == 0:
        return np.nan
    order = np.argsort(-scores, kind="mergesort")
    pos_sorted = positives[order].astype(np.float64)
    tp_cum = np.cumsum(pos_sorted)
    precision = tp_cum / np.arange(1, len(scores) + 1)
    # AP = sum over positive ranks of precision at that rank / n_pos
    return float(np.sum(precision * pos_sorted) / n_pos)


def macro_auprc(probs: np.ndarray, labels: np.ndarray) -> float:
    aps = []
    for c in range(probs.shape[1]):
        pos = labels == c
        if pos.any():
            aps.append(_binary_average_precision(probs[:, c], pos))
    return float(np.nanmean(aps)) if aps else np.nan


def composite_score(acc: float, top3: float, f1: float) -> float:
    return 0.4 * acc + 0.3 * top3 + 0.3 * f1


def classification_report(probs: np.ndarray, labels: np.ndarray, num_classes: int | None = None) -> dict:
    """Full metric dict for one evaluation pass."""
    num_classes = num_classes or probs.shape[1]
    preds = np.argmax(probs, axis=-1)
    acc = accuracy(probs, labels)
    top3 = topk_accuracy(probs, labels, k=3)
    f1 = macro_f1(preds, labels, num_classes)
    return {
        "accuracy": acc,
        "top3_accuracy": top3,
        "per_class_top3": per_class_topk_accuracy(probs, labels, k=3),
        "macro_f1": f1,
        "macro_roc_auc": macro_roc_auc(probs, labels),
        "macro_auprc": macro_auprc(probs, labels),
        "composite": composite_score(acc, top3, f1),
        "confusion_matrix": confusion_matrix(preds, labels, num_classes),
    }


def redshift_metrics(pred_z: np.ndarray, true_z: np.ndarray, outlier_thresh: float = 0.15) -> dict:
    """Redshift regression metrics; sigma_NMAD = 1.48 * median|dz/(1+z)|."""
    pred_z = np.asarray(pred_z, dtype=np.float64)
    true_z = np.asarray(true_z, dtype=np.float64)
    dz = (pred_z - true_z) / (1.0 + true_z)
    return {
        "mse": float(np.mean((pred_z - true_z) ** 2)),
        "mae": float(np.mean(np.abs(pred_z - true_z))),
        "bias": float(np.mean(dz)),
        "sigma_nmad": float(1.48 * np.median(np.abs(dz))),
        "outlier_rate": float(np.mean(np.abs(dz) > outlier_thresh)),
    }


def dirichlet_random_pr_auc_baseline(
    labels: np.ndarray, num_classes: int, n_trials: int = 1000, seed: int = 42
) -> float:
    """Macro AUPRC of dirichlet-random predictions — the statistical floor."""
    rng = np.random.default_rng(seed)
    scores = []
    for _ in range(n_trials):
        probs = rng.dirichlet(np.ones(num_classes), size=len(labels))
        scores.append(macro_auprc(probs, labels))
    return float(np.nanmean(scores))


def early_classification_report(
    results: list, labels_by_object: dict, num_classes: int | None = None
) -> dict:
    """Per-alert serving output -> early-classification quality.

    ``results``: serve output rows ({object_id, jd, probs}, per-object jd
    order — ``infer.serve.serve_alert_stream`` emits exactly this);
    ``labels_by_object``: object_id -> integer class.

    Returns the reference's per-alert confusion matrix over ALL alerts
    (``brew_cider.py:1134-1193`` evaluate_alert semantics) plus the
    early-classification curve the production stream actually cares
    about: accuracy at the k-th alert of each object (how soon the
    classifier is right), and accuracy at each object's final alert.
    """
    per_obj: dict = {}
    for r in results:
        oid = r["object_id"]
        if oid in labels_by_object:
            per_obj.setdefault(oid, []).append(np.asarray(r["probs"]))
    if not per_obj:
        raise ValueError("no serve results matched labels_by_object")
    if num_classes is None:
        num_classes = len(next(iter(per_obj.values()))[0])
    bad = {oid: int(labels_by_object[oid]) for oid in per_obj
           if not 0 <= int(labels_by_object[oid]) < num_classes}
    if bad:
        raise ValueError(
            f"labels outside [0, {num_classes}) for objects {sorted(bad)[:5]} "
            f"(model emits {num_classes} classes — pass num_classes or remap "
            "the taxonomy)"
        )

    all_preds, all_true = [], []
    final_preds, final_true = [], []
    max_k = max(len(v) for v in per_obj.values())
    hits_at_k = np.zeros(max_k)
    n_at_k = np.zeros(max_k)
    for oid, seq in per_obj.items():
        y = int(labels_by_object[oid])
        preds = [int(np.argmax(p)) for p in seq]
        all_preds += preds
        all_true += [y] * len(preds)
        final_preds.append(preds[-1])
        final_true.append(y)
        for k, p in enumerate(preds):
            hits_at_k[k] += p == y
            n_at_k[k] += 1
    return {
        "confusion_matrix": confusion_matrix(
            np.asarray(all_preds), np.asarray(all_true), num_classes
        ),
        "per_alert_accuracy": float(np.mean(np.asarray(all_preds) == np.asarray(all_true))),
        "accuracy_at_alert_k": (hits_at_k / np.maximum(n_at_k, 1)).tolist(),
        "objects_at_alert_k": n_at_k.astype(int).tolist(),
        "final_alert_accuracy": float(np.mean(np.asarray(final_preds) == np.asarray(final_true))),
        "n_objects": len(per_obj),
    }
