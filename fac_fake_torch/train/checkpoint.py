"""Checkpoints — the port of `fac_fake_tpu/train/checkpoint.py`, with
``torch.save`` files in place of orbax directories.

A training checkpoint is ``{"state_dict", "optimizer", "step", "epoch",
"dtype"}``: the model's state dict in the reference torch key layout
(parameters, BatchNorm running stats, LinearNorm's counters; always the
fp32 master weights), the Adam state, the step count and the compute dtype
it trained in (``model.dtype``: float32 or bfloat16). Every save is
atomic: the file is written under a temporary name in the same directory
and then renamed with ``os.replace``, so a file
named ``epoch_<n>.pt`` or ``best.pth`` is always a finished save, and a
crash mid-write leaves at most a stray temporary file.

  * `CheckpointWriter`: periodic saves on a background thread. `save`
    copies the state to host memory and returns; the write overlaps the
    next epoch; `close` drains what is pending;
  * `save_best` / `restore_best`: the best-accuracy snapshot,
    ``best.pth``, which `cli/predict.py --weights` loads strict (it unwraps
    ``state_dict``);
  * `latest_epoch` / `restore_checkpoint`: resume.
"""
from __future__ import annotations

import os
import queue
import re
import threading
from typing import Optional

import torch
from torch import nn

_EPOCH_RE = re.compile(r"^epoch_(\d+)\.pt$")
BEST = "best.pth"


def _host(obj):
    """A copy of ``obj`` (nested dicts, lists, tensors) in host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def snapshot(model: nn.Module, optimizer: Optional[torch.optim.Optimizer], step: int,
             epoch: Optional[int] = None, dtype: str = "float32") -> dict:
    """The training state in host memory."""
    return {"state_dict": _host(model.state_dict()),
            "optimizer": _host(optimizer.state_dict()) if optimizer is not None else None,
            "step": int(step), "epoch": epoch, "dtype": dtype}


def atomic_save(obj, path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def epoch_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"epoch_{epoch:06d}.pt")


class CheckpointWriter:
    """Periodic checkpoints on one background thread. A failed write is
    raised at the next `save`, `wait` or `close`."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self._q: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._error is None:
                    atomic_save(item[1], epoch_path(self.directory, item[0]))
            except Exception as e:          # re-raised on the caller's thread
                self._error = e
            finally:
                self._q.task_done()

    def _raise(self):
        if self._error is not None:
            raise RuntimeError("checkpoint write failed") from self._error

    def save(self, model: nn.Module, optimizer, step: int, epoch: int,
             dtype: str = "float32") -> None:
        self._raise()
        self._q.put((epoch, snapshot(model, optimizer, step, epoch, dtype)))

    def wait(self) -> None:
        self._q.join()
        self._raise()

    def latest(self) -> Optional[int]:
        return latest_epoch(self.directory)

    def close(self) -> None:
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        self._raise()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_checkpoint(directory: str, model: nn.Module, optimizer, step: int, epoch: int,
                    dtype: str = "float32") -> None:
    """One synchronous save (tools; training uses `CheckpointWriter`)."""
    atomic_save(snapshot(model, optimizer, step, epoch, dtype), epoch_path(directory, epoch))


def save_best(directory: str, model: nn.Module, optimizer, step: int,
              dtype: str = "float32") -> None:
    """The best-so-far snapshot (overwrites ``best.pth``)."""
    atomic_save(snapshot(model, optimizer, step, dtype=dtype), os.path.join(directory, BEST))


def latest_epoch(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    epochs = [int(m.group(1)) for f in os.listdir(directory) if (m := _EPOCH_RE.match(f))]
    return max(epochs) if epochs else None


def load(path: str, model: nn.Module, optimizer=None) -> int:
    """Load a checkpoint file into ``model`` (strict) and ``optimizer``;
    returns its step."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ck["state_dict"], strict=True)
    if optimizer is not None and ck.get("optimizer") is not None:
        optimizer.load_state_dict(ck["optimizer"])
    return int(ck.get("step", 0))


def restore_checkpoint(directory: str, model: nn.Module, optimizer=None,
                       epoch: Optional[int] = None) -> int:
    """Load ``epoch`` (by default the latest) from ``directory``; returns
    its step."""
    epoch = latest_epoch(directory) if epoch is None else epoch
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    return load(epoch_path(directory, epoch), model, optimizer)


def restore_best(directory: str, model: nn.Module, optimizer=None) -> int:
    return load(os.path.join(directory, BEST), model, optimizer)
