"""Evaluation metrics — the port of `fac_fake_tpu/evaluate/metrics.py`: the
S3D evaluator's (`S3D-test.py:293-303`: accuracy, F1, ROC dumps) and the
prediction-CSV evaluation (`ROC_AUC_ACC.py`: a ``filename,label`` CSV of
fake-probabilities joined with a metadata.json).

`accuracy`, `f1`, `auc_score` and the CSV evaluation are numpy and the
``csv`` module only: the machine with the card has no scikit-learn and no
pandas. `roc_auc` and `save_roc_curve` import scikit-learn (and
matplotlib) when called; the evaluator calls them only with an
``out_prefix``.

The CSV is read as strings, as the port's and JAX's writers write it: a
column of file names that all look like numbers stays names here, where
pandas (JAX's reader) makes them integers that join no metadata entry.
"""
from __future__ import annotations

import csv
import json
from typing import Dict, List, Sequence

import numpy as np


def accuracy(labels: Sequence[int], preds: Sequence[int]) -> float:
    return float((np.asarray(labels) == np.asarray(preds)).mean())


def f1(labels: Sequence[int], preds: Sequence[int]) -> float:
    """Binary F1 of the positive class 1, as scikit-learn's ``f1_score``:
    2·tp / (2·tp + fp + fn), and 0.0 where that is 0/0 (no positive label
    and no positive prediction)."""
    y = np.asarray(labels) == 1
    p = np.asarray(preds) == 1
    tp = int(np.sum(y & p))
    den = 2 * tp + int(np.sum(~y & p)) + int(np.sum(y & ~p))
    return 2.0 * tp / den if den else 0.0


def auc_score(labels: Sequence[int], scores: Sequence[float]) -> float:
    """The area under the ROC curve of ``scores`` for the positive class 1:
    the Mann-Whitney U over (positive, negative) pairs, a tie counted 0.5,
    over their number. That is the trapezoid area under scikit-learn's
    ``roc_curve`` (tied scores one point). 2U is a sum of midrank
    doubles, exact in float64, so the one division is the only rounding.
    Both classes must be present."""
    y = np.asarray(labels) == 1
    s = np.asarray(scores, np.float64)
    order = np.argsort(s, kind="mergesort")
    ends = np.r_[np.flatnonzero(np.diff(s[order])) + 1, s.size]
    starts = np.r_[0, ends[:-1]]
    twice_rank = np.empty(s.size, np.float64)    # 2 x the 1-based midrank of its tie group
    twice_rank[order] = np.repeat(starts + ends + 1, ends - starts)
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("the AUC needs both classes")
    twice_u = float(twice_rank[y].sum()) - n_pos * (n_pos + 1)
    return twice_u / (2.0 * n_pos * n_neg)


def _read_predictions(csv_path: str) -> List[dict]:
    with open(csv_path, newline="") as fh:
        return list(csv.DictReader(fh))


def evaluate_prediction_csv(csv_path: str, metadata_path: str,
                            drop_no_face: bool = True) -> Dict[str, float]:
    """The ROC_AUC_ACC.py recipe: join the ``filename,label`` fake-prob CSV
    with metadata.json ({name: {'label': 'REAL'|'FAKE'}}) by ``name`` or
    ``name + '.mp4'``, drop the exact-0.5 no-face rows (`ROC_AUC_ACC.py:16`),
    compute accuracy (prob ≥ 0.5 is FAKE) and AUC. No joined row: NaNs and
    ``count`` 0; one class: the AUC NaN with a note (JAX :53-67)."""
    with open(metadata_path) as fh:
        meta = json.load(fh)
    rows = []
    for r in _read_predictions(csv_path):
        name = r["filename"]
        entry = meta.get(name) or meta.get(name + ".mp4")
        if entry is None:
            continue
        prob = float(r["label"])
        if drop_no_face and prob == 0.5:
            continue
        rows.append((1 if str(entry["label"]).upper() == "FAKE" else 0, prob))
    if not rows:
        return {"accuracy": float("nan"), "auc": float("nan"), "count": 0,
                "note": "no scored rows joined the metadata"}
    y = np.array([r[0] for r in rows])
    p = np.array([r[1] for r in rows])
    out = {"accuracy": accuracy(y, (p >= 0.5).astype(int)), "count": len(rows)}
    if len(np.unique(y)) < 2:
        out["auc"] = float("nan")
        out["note"] = ("AUC undefined: only one class present after the "
                       "metadata join/0.5-drop")
        return out
    out["auc"] = auc_score(y, p)
    return out


def legacy_int_accuracy(csv_path: str, metadata_path: str) -> float:
    """The predictor's inverted int-label accuracy block
    (`cvit_prediction.py:363-369`): prob < 0.5 → 1 compared with the
    metadata's integer label of the file name, over every row of the CSV,
    joined or not."""
    with open(metadata_path) as fh:
        meta = json.load(fh)
    rows = _read_predictions(csv_path)
    score = sum((1 if float(r["label"]) < 0.5 else 0) == meta.get(r["filename"])
                for r in rows)
    return score / max(len(rows), 1)


def roc_auc(labels: Sequence[int], scores: Sequence[float]):
    from sklearn import metrics
    fpr, tpr, thr = metrics.roc_curve(labels, scores)
    return fpr, tpr, thr, metrics.auc(fpr, tpr)


def save_roc_curve(labels, scores, out_prefix: str, model_name: str = "model"):
    """ROC plot + fpr/tpr text dumps (`S3D-test.py:100-128`); returns the AUC.
    The plot is skipped where matplotlib is missing."""
    fpr, tpr, _, auc = roc_auc(labels, scores)
    np.savetxt(out_prefix + "_fpr.txt", fpr)
    np.savetxt(out_prefix + "_tpr.txt", tpr)
    try:
        import matplotlib
    except ImportError:
        return auc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.figure()
    plt.plot(fpr, tpr, label=f"{model_name} (AUC {auc:.3f})")
    plt.plot([0, 1], [0, 1], "k--")
    plt.xlabel("FPR")
    plt.ylabel("TPR")
    plt.legend()
    plt.savefig(out_prefix + "_roc.png", dpi=120)
    plt.close()
    return auc
