"""Per-epoch learning-rate controllers — the port's own copy of
`fac_fake_tpu/train/schedules.py`.

The reference uses ReduceLROnPlateau(factor .5, patience 3)
(`cvit_train.py:81`), StepLR(15, 0.1) (`ResKan_train.py:84`) and a cosine
LambdaLR ``((1+cos(e·π/E))/2)(1−lrf)+lrf`` (`S3D-train.py:204-205`). All
step once an epoch on the host, plateau on the validation loss; the trainer
writes the new rate into the optimizer (`train/state.py
set_learning_rate`).
"""
from __future__ import annotations

import math

from fac_fake_torch.core.config import OptimConfig


class LRController:
    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr

    def epoch_end(self, epoch: int, val_loss: float) -> float:
        return self.lr


class ConstLR(LRController):
    pass


class StepLR(LRController):
    def __init__(self, base_lr, step_size: int, gamma: float):
        super().__init__(base_lr)
        self.step_size, self.gamma = step_size, gamma

    def epoch_end(self, epoch, val_loss):
        # epoch is 0-based and just finished; the rate for the next epoch
        self.lr = self.base_lr * self.gamma ** ((epoch + 1) // self.step_size)
        return self.lr


class CosineLR(LRController):
    def __init__(self, base_lr, epochs: int, lrf: float):
        super().__init__(base_lr)
        self.epochs, self.lrf = epochs, lrf

    def epoch_end(self, epoch, val_loss):
        x = epoch + 1
        lam = ((1 + math.cos(x * math.pi / self.epochs)) / 2) * (1 - self.lrf) + self.lrf
        self.lr = self.base_lr * lam
        return self.lr


class PlateauLR(LRController):
    """torch ReduceLROnPlateau (mode min, relative threshold 1e-4)."""

    def __init__(self, base_lr, factor: float = 0.5, patience: int = 3,
                 threshold: float = 1e-4):
        super().__init__(base_lr)
        self.factor, self.patience, self.threshold = factor, patience, threshold
        self.best = float("inf")
        self.bad = 0

    def epoch_end(self, epoch, val_loss):
        if val_loss < self.best * (1 - self.threshold):
            self.best = val_loss
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr *= self.factor
                self.bad = 0
        return self.lr


def build_controller(cfg: OptimConfig, epochs: int, world_scale: int = 1) -> LRController:
    lr = cfg.lr * (world_scale if cfg.scale_lr_by_data_parallel else 1)
    if cfg.schedule == "plateau":
        return PlateauLR(lr, cfg.plateau_factor, cfg.plateau_patience)
    if cfg.schedule == "step":
        return StepLR(lr, cfg.step_size, cfg.step_gamma)
    if cfg.schedule == "cosine":
        return CosineLR(lr, epochs, cfg.cosine_lrf)
    return ConstLR(lr)
