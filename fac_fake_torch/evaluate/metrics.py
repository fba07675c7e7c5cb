"""The S3D evaluator's metrics — the port of that part of
`fac_fake_tpu/evaluate/metrics.py` (`S3D-test.py:293-303`: accuracy, F1,
ROC dumps).

`accuracy` and `f1` are numpy only: the machine with the card has no
scikit-learn. `roc_auc` and `save_roc_curve` import scikit-learn (and
matplotlib) when called; the evaluator calls them only with an
``out_prefix``.
"""
from __future__ import annotations

from typing import Sequence

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
