"""Training-history plots — the port of `fac_fake_tpu/evaluate/plots.py`
(the reference's `figure/figure.py`): loss and accuracy curves from the
``[train_loss, train_acc, val_loss, val_acc]`` pickles that
`Trainer.save_history` writes (`cvit_train.py:203-204`). matplotlib is
imported when a plot is drawn.
"""
from __future__ import annotations

import pickle
from typing import Optional, Sequence


def load_history(path: str) -> dict:
    with open(path, "rb") as f:
        data = pickle.load(f)
    return {"train_loss": data[0], "train_acc": data[1],
            "val_loss": data[2], "val_acc": data[3]}


def plot_history(paths: Sequence[str], labels: Optional[Sequence[str]] = None,
                 out_path: str = "history.png") -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = labels or [p.rsplit("/", 1)[-1] for p in paths]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for p, lab in zip(paths, labels):
        h = load_history(p)
        ax1.plot(h["train_loss"], label=f"{lab} train")
        ax1.plot(h["val_loss"], "--", label=f"{lab} val")
        ax2.plot(h["train_acc"], label=f"{lab} train")
        ax2.plot(h["val_acc"], "--", label=f"{lab} val")
    ax1.set_title("loss")
    ax2.set_title("accuracy")
    for ax in (ax1, ax2):
        ax.set_xlabel("epoch")
        ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
