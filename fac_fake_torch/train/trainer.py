"""The training engine — the port of `fac_fake_tpu/train/trainer.py` for the
CViT and S3D families, on one device (the card unless the caller names the
CPU).

One train step (`Trainer.train_step`): the augmentation chain on the uint8
batch (`data/augment.py`: the CViT's strong_aug with CLAHE through kernel
K7, or the S3D train transform with JPEG through kernel K10) → the input
scaling of ``data.normalize`` (``imagenet``: ImageNet mean and std;
``raw255``, S3D: the augmented [0, 1] batch times 255, JAX :161-166, not the
integer bytes) → forward in training mode → the masked loss (S3D's
``bce_weighted`` takes its ``pos_weight`` through ``loss_kwargs``) →
backward → one Adam update (`train/state.py`). Image batches are (B, H, W,
3) and clip batches (B, T, H, W, 3), uint8; the model sees them as NCHW /
NCDHW views of that memory. BatchNorm running stats and LinearNorm's counters are
the model's buffers and move in its forward, as JAX's mutable collections
do. Options, as JAX's:

  * ``train.grad_accum_steps``: the batch splits into that many
    microbatches; each adds its gradient weighted by its mask count, and one
    Adam update takes their count-weighted mean (JAX :204-259). BatchNorm
    stats and LinearNorm's counters advance a microbatch;
  * ``train.remat``: ``"nothing"`` runs the loss forward under
    ``torch.utils.checkpoint`` (everything recomputed in the backward),
    ``"dots"`` under selective checkpointing that keeps the outputs of
    matmuls and convolutions. The recompute would move the buffers a second
    time, and would read LinearNorm's counters after they ticked: the step
    puts back the buffers the forward started from before the backward,
    and those it ended with after, so the buffers are as one forward leaves
    them and the recompute sees what the forward saw.

`eval_step` normalizes a uint8 image batch with K2 (`ops/preprocess.py
normalize_imagenet`, one launch a batch; a clip batch under ``raw255`` is
``u8 / 255 · 255`` in fp32, as JAX's, with no K2: K2 has no fp32 raw mode)
and runs the model in eval mode.
`cache_data` keeps a whole uint8 dataset on the device (`DeviceCache`): each
epoch shuffles it with a seeded generator and gathers the rows on the
device. Host batches (`data/folder.py`) are read a batch ahead on a worker
thread into pinned memory and uploaded with ``non_blocking`` copies. The
running metrics stay on the device until the epoch ends, or ``log_every``.
`fit` drives the epochs: the LR controller, the best-accuracy snapshot
(saved as ``best.pth``), early stop on the validation loss, periodic
checkpoints on a background thread (`train/checkpoint.py`).

Left out, and raising: the mesh and its tensor-parallel rules (ROADMAP
queue 1 item 12), TensorBoard (item 16) and bf16 training (item 11). A
model that holds a `KANLinear` (``reskan``, ``resvitkan``) is refused: K9,
its spline bases on the card, has no backward, and JAX's `Trainer` cannot
train the KAN family either.
"""
from __future__ import annotations

import csv
import functools
import os
import pickle
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from fac_fake_torch.core.config import Config
from fac_fake_torch.core.device import DeviceLike, resolve_device
from fac_fake_torch.data.augment import augment_batch, check_config
from fac_fake_torch.models.blocks.kan import KANLinear
from fac_fake_torch.ops import preprocess
from fac_fake_torch.train.losses import make_loss
from fac_fake_torch.train.schedules import build_controller
from fac_fake_torch.train.state import make_optimizer, set_learning_rate

_REMAT = ("none", "dots", "nothing")


class DeviceCache:
    """A uint8 dataset held in device memory (`Trainer.cache_data`); usable
    as a ``*_batches_fn`` of `Trainer.fit`."""

    def __init__(self, images: torch.Tensor, labels: torch.Tensor, batch_size: int):
        self.images = images              # (N, H, W, 3) or clips (N, T, H, W, 3), uint8
        self.labels = labels              # (N,) int64
        self.batch_size = batch_size
        self.steps = int(images.shape[0]) // batch_size      # drop_last

    def __call__(self, epoch: int) -> "DeviceCache":
        return self


def count_correct(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    if logits.dim() == 2 and logits.shape[-1] > 1:
        pred = logits.argmax(dim=-1)
    else:   # single-logit sigmoid rounding (`S3D/utils.py:69-85`)
        pred = (torch.sigmoid(logits.reshape(-1)) > 0.5).long()
    return ((pred == labels.reshape(-1)).float() * mask).sum()


# remat "dots" keeps the outputs of these ops and recomputes the rest
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default, torch.ops.aten.convolution.default))


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    """NHWC → NCHW, NDHWC → NCDHW, as views."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


class Trainer:
    def __init__(self, model: nn.Module, cfg: Optional[Config] = None,
                 device: DeviceLike = None, loss_kwargs: Optional[dict] = None):
        self.cfg = cfg or Config()
        if any(isinstance(m, KANLinear) for m in model.modules()):
            raise ValueError(
                f"{type(model).__name__} holds a KANLinear and cannot be trained: K9, its "
                "spline bases on the card, has no backward, and the JAX Trainer cannot train "
                "the KAN family either (its init_state keeps no kan_grid collection, so "
                "KANLinear's grid lookup raises ScopeCollectionNotFound)")
        self.device = resolve_device(device)
        tcfg = self.cfg.train
        if self.cfg.model.dtype != "float32":
            raise NotImplementedError(f"model.dtype={self.cfg.model.dtype!r}: bf16 training is "
                                      "ROADMAP queue 1 item 11")
        if tcfg.tensorboard_dir:
            raise NotImplementedError("train.tensorboard_dir: TensorBoard is ROADMAP queue 1 "
                                      "item 16")
        if self.cfg.mesh.data not in (-1, 1) or self.cfg.mesh.model != 1:
            raise NotImplementedError("a mesh of several devices (data parallel, tensor "
                                      "parallel) is ROADMAP queue 1 item 12")
        if tcfg.remat not in _REMAT:
            raise ValueError(f"train.remat={tcfg.remat!r}: one of {_REMAT}")
        if self.cfg.data.normalize not in ("imagenet", "raw255"):
            raise ValueError(f"data.normalize={self.cfg.data.normalize!r}: imagenet or raw255")
        self.raw255 = self.cfg.data.normalize == "raw255"
        if self.cfg.data.augment.enabled:
            check_config(self.cfg.data.augment)
        self.model = model.to(self.device)
        self.loss_fn = make_loss(tcfg.loss, **(loss_kwargs or {}))
        self.controller = build_controller(tcfg.optim, tcfg.epochs)
        self.optimizer = make_optimizer(self.model, tcfg.optim.lr, tcfg.optim.weight_decay)
        self.accum = max(1, int(tcfg.grad_accum_steps))
        self.step = 0
        self._mean = torch.from_numpy(preprocess.IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(preprocess.IMAGENET_STD).to(self.device)

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> None:
        """Fresh weights from ``seed`` (default ``train.seed``), as
        `build_model` initialises them, and a fresh optimizer."""
        from fac_fake_torch.models import init_weights
        init_weights(self.model, self.cfg.train.seed if seed is None else seed)
        tcfg = self.cfg.train
        self.optimizer = make_optimizer(self.model, tcfg.optim.lr, tcfg.optim.weight_decay)
        self.step = 0

    def load_warm_start(self, torch_ckpt: str):
        """Warm start from a reference ``.pth`` (`cvit_train.py:70-71`,
        ``strict=False``); returns the missing and unexpected keys."""
        from fac_fake_torch.compat.weights import load_reference_pth
        return self.model.load_state_dict(load_reference_pth(torch_ckpt), strict=False)

    # ------------------------------------------------------------------
    def _loss(self, x, labels, mask):
        logits = self.model(x)
        return self.loss_fn(logits, labels, mask), logits

    def _backward(self, x, labels, mask, weight=None):
        """Forward and backward of one (micro)batch; the gradient of
        ``loss · weight`` adds into ``.grad``. Returns (loss, logits)."""
        remat = self.cfg.train.remat
        if remat == "none":
            loss, logits = self._loss(x, labels, mask)
            (loss if weight is None else loss * weight).backward()
            return loss.detach(), logits.detach()
        from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts
        buffers = list(self.model.buffers())
        before = [b.clone() for b in buffers]
        kw = {}
        if remat == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _dots_policy)
        loss, logits = checkpoint(self._loss, x, labels, mask, use_reentrant=False, **kw)
        after = [b.clone() for b in buffers]
        with torch.no_grad():
            for b, v in zip(buffers, before):
                b.copy_(v)
        (loss if weight is None else loss * weight).backward()
        with torch.no_grad():
            for b, v in zip(buffers, after):
                b.copy_(v)
        return loss.detach(), logits.detach()

    def normalize(self, x01: torch.Tensor) -> torch.Tensor:
        """[0, 1] NHWC (NDHWC) → the model's NCHW (NCDHW) input, a view of
        ``channels_last`` (``channels_last_3d``) memory."""
        x = x01 * 255.0 if self.raw255 else (x01 - self._mean) / self._std
        return _channels_first(x)

    def train_step(self, batch: Dict[str, torch.Tensor],
                   gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """One optimizer step on a device batch (``image`` uint8 (B, H, W, 3),
        ``label`` (B,), ``mask`` (B,) float); ``gen`` draws the
        augmentation. Returns the step's loss, correct and count as device
        scalars."""
        self.model.train()
        x = self.normalize(augment_batch(batch["image"], self.cfg.data.augment, gen))
        labels, mask = batch["label"], batch["mask"].float()
        cnt = mask.sum()
        self.optimizer.zero_grad(set_to_none=True)
        if self.accum == 1:
            loss, logits = self._backward(x, labels, mask)
            correct = count_correct(logits, labels, mask)
        else:
            b = x.shape[0]
            if b % self.accum:
                raise ValueError(f"batch {b} not divisible by grad_accum_steps {self.accum}")
            mb = b // self.accum
            denom = cnt.clamp(min=1.0)
            loss = torch.zeros((), device=x.device)
            correct = torch.zeros((), device=x.device)
            for i in range(self.accum):
                s = slice(i * mb, (i + 1) * mb)
                c = mask[s].sum()
                li, logits = self._backward(x[s], labels[s], mask[s], c / denom)
                loss = loss + li * c
                correct = correct + count_correct(logits, labels[s], mask[s])
            loss = loss / denom
        self.optimizer.step()
        self.step += 1
        return {"loss": loss, "correct": correct, "count": cnt}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The uint8 batch through the model in eval mode: ImageNet-normalized
        by K2, or under ``raw255`` (S3D) ``u8 / 255 · 255`` in fp32."""
        self.model.eval()
        mask = batch["mask"].float()
        u8 = batch["image"]
        if self.raw255:
            x = self.normalize(u8.float() / torch.full((1,), 255.0, device=u8.device))
        else:
            x = preprocess.normalize_imagenet(u8)
        logits = self.model(x)
        return {"loss": self.loss_fn(logits, batch["label"], mask),
                "correct": count_correct(logits, batch["label"], mask),
                "count": mask.sum()}

    # --- device-cached epochs --------------------------------------------
    def cache_data(self, images_u8, labels, batch_size: int) -> DeviceCache:
        """Upload a whole uint8 dataset (N, H, W, 3), or clips (N, T, H, W, 3),
        to the device, cut to whole batches."""
        n = (len(images_u8) // batch_size) * batch_size
        images = torch.as_tensor(np.ascontiguousarray(images_u8[:n])).to(self.device)
        labels = torch.as_tensor(np.asarray(labels[:n], np.int64)).to(self.device)
        return DeviceCache(images.contiguous(), labels, batch_size)

    def _cached_batches(self, cache: DeviceCache, gen: torch.Generator, train: bool):
        n, bs = cache.steps * cache.batch_size, cache.batch_size
        perm = torch.randperm(n, generator=gen, device=self.device) if train else None
        mask = torch.ones((bs,), device=self.device)
        for i in range(cache.steps):
            if train:
                idx = perm[i * bs:(i + 1) * bs]
                yield {"image": cache.images.index_select(0, idx),
                       "label": cache.labels.index_select(0, idx), "mask": mask}
            else:
                s = slice(i * bs, (i + 1) * bs)
                yield {"image": cache.images[s], "label": cache.labels[s], "mask": mask}

    # --- host batches ----------------------------------------------------------
    def _pinned(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A host batch of numpy arrays as tensors, pinned where the device
        is the card."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.ascontiguousarray(v))
            if k == "label":
                t = t.long()
            out[k] = t.pin_memory() if self.device.type == "cuda" else t
        return out

    def _streamed_batches(self, batches: Iterator):
        it = iter(batches)
        fetch = lambda: (lambda b: None if b is None else self._pinned(b))(next(it, None))
        with ThreadPoolExecutor(max_workers=1) as pool:
            host = pool.submit(fetch).result()
            while host is not None:
                cur = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
                nxt = pool.submit(fetch)      # the next batch read and pinned meanwhile
                yield cur
                host = nxt.result()

    def _run_epoch(self, batches, gen: Optional[torch.Generator], train: bool) -> Dict[str, float]:
        """One pass; the metrics accumulate on the device and are read once."""
        if isinstance(batches, DeviceCache):
            it = self._cached_batches(batches, gen, train)
        else:
            it = self._streamed_batches(batches)
        acc = torch.zeros(3, device=self.device)        # loss·count, correct, count
        every = self.cfg.train.log_every
        for nb, batch in enumerate(it, 1):
            m = self.train_step(batch, gen) if train else self.eval_step(batch)
            acc += torch.stack([m["loss"] * m["count"], m["correct"], m["count"]])
            if train and every and nb % every == 0:
                print(f"  batch {nb}: loss {float(m['loss']):.4f}")
        loss_sum, correct, count = acc.tolist()
        denom = max(count, 1.0)
        return {"loss": loss_sum / denom, "acc": correct / denom}

    def evaluate(self, batches) -> Dict[str, float]:
        return self._run_epoch(batches, None, train=False)

    # ------------------------------------------------------------------
    def fit(self, train_batches_fn: Callable[[int], Any],
            val_batches_fn: Optional[Callable[[int], Any]] = None,
            start_epoch: int = 0) -> Dict[str, Any]:
        """The train/val loop; ``*_batches_fn(epoch)`` gives the epoch's
        batches (host batch dicts, or a `DeviceCache`)."""
        cfg = self.cfg.train
        set_learning_rate(self.optimizer, self.controller.lr)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        history = {"train_loss": [], "train_acc": [], "val_loss": [], "val_acc": [], "lr": []}
        best = {"acc": -1.0, "state_dict": None}
        writer = None
        if cfg.checkpoint_every and cfg.checkpoint_dir:
            from fac_fake_torch.train.checkpoint import CheckpointWriter
            writer = CheckpointWriter(cfg.checkpoint_dir)
        t0 = time.time()
        try:
            best = self._epoch_loop(gen, start_epoch, history, best, train_batches_fn,
                                    val_batches_fn, writer)
        finally:
            if writer is not None:        # drain: the last snapshot becomes durable
                writer.close()
        history["wall_seconds"] = time.time() - t0
        history["best_acc"] = best["acc"]
        return {"history": history, "best": best}

    def _epoch_loop(self, gen, start_epoch, history, best, train_batches_fn, val_batches_fn,
                    writer):
        cfg = self.cfg.train
        bad_epochs = 0
        for epoch in range(start_epoch, cfg.epochs):
            tr = self._run_epoch(train_batches_fn(epoch), gen, train=True)
            va = (self._run_epoch(val_batches_fn(epoch), None, train=False)
                  if val_batches_fn is not None else dict(tr))
            lr = self.controller.epoch_end(epoch, va["loss"])
            set_learning_rate(self.optimizer, lr)
            for k, v in (("train_loss", tr["loss"]), ("train_acc", tr["acc"]),
                         ("val_loss", va["loss"]), ("val_acc", va["acc"]), ("lr", lr)):
                history[k].append(v)
            print(f"epoch {epoch}: train loss {tr['loss']:.4f} acc {tr['acc']:.4f} | val loss "
                  f"{va['loss']:.4f} acc {va['acc']:.4f} | lr {lr:.2e}")
            if va["acc"] > best["acc"]:       # best-acc snapshot (cvit_train.py:180-190)
                from fac_fake_torch.train.checkpoint import _host, save_best
                best = {"acc": va["acc"], "state_dict": _host(self.model.state_dict())}
                if cfg.checkpoint_dir:
                    save_best(cfg.checkpoint_dir, self.model, self.optimizer, self.step)
            if writer is not None and (epoch + 1) % cfg.checkpoint_every == 0:
                writer.save(self.model, self.optimizer, self.step, epoch)
            if cfg.patience:                  # early stop on val-loss patience
                prior = history["val_loss"][:-1]
                bad_epochs = bad_epochs + 1 if (epoch > 0 and va["loss"] >= min(
                    prior or [float("inf")])) else 0
                if bad_epochs >= cfg.patience:
                    print(f"early stop at epoch {epoch}")
                    break
        return best

    # ------------------------------------------------------------------
    @staticmethod
    def save_history(history: dict, path: str) -> None:
        """A pickle of [train_loss, train_acc, val_loss, val_acc]
        (`cvit_train.py:203-204`) and a CSV of every per-epoch column
        (`ResKan_train.py:187-188`)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump([history["train_loss"], history["train_acc"],
                         history["val_loss"], history["val_acc"]], f)
        cols = [k for k, v in history.items() if isinstance(v, list)]
        with open(path + ".csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            w.writerows(zip(*(history[k] for k in cols)))
