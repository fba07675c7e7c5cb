"""S3D building blocks — the port of `fac_fake_tpu/models/s3d/layers.py`.

Layout NCDHW (batch, channels, time, H, W), as the reference torch S3D
takes it, in ``channels_last_3d`` memory; module names are the reference's
(`S3D/model.py:50-82`): ``conv``/``bn`` and ``conv_s``/``bn_s``/
``conv_t``/``bn_t``.

  * `BasicConv3d`: conv → BN → act;
  * `SepConv3d`: spatial (1,k,k) stride (1,s,s) conv-BN-act, then temporal
    (k,1,1) stride (s,1,1) conv-BN-act; ``spatial_bn=False`` is the msca
    ``SepConv3dV2`` (no spatial BN, and no spatial act with
    ``spatial_act=False``); ``depthwise=True`` groups both convs by channel;
  * `DWSepConv3d`: the msca family's depthwise separable conv
    (`new_model/Conv3d.py:45-64`), BN and ReLU6 after the temporal conv only;
  * the frozen SRM high-pass banks (`S3D/SRM/HPF.py:11-65`), read from this
    package's own copy of the ``.npy`` assets: the 30-filter input bank and
    the msca family's residual 3-filter bank.

`BN3D` runs with the reference's eps 1e-3 (torch's default is 1e-5) and
momentum 0.001 (flax decay 0.999), and in training updates its running
variance with the biased batch variance, as flax does
(`models/layers.py _FlaxRunningStats`).
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fac_fake_torch.models.layers import Conv3d, _FlaxRunningStats, widen

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")

BN3D_EPS = 1e-3
BN3D_MOMENTUM = 0.001

Int3 = Union[int, Tuple[int, int, int]]


def _triple(v: Int3) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


class BN3D(_FlaxRunningStats, nn.BatchNorm3d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN3D_EPS, momentum=BN3D_MOMENTUM)


def act_fn(name: Optional[str]):
    """``relu`` | ``relu6`` | None (identity)."""
    if name is None:
        return lambda x: x
    if name == "relu":
        return F.relu
    if name == "relu6":
        return F.relu6
    raise KeyError(name)


class BasicConv3d(nn.Module):
    """conv → BN → act (`S3D/model.py:50-61`)."""

    def __init__(self, cin: int, cout: int, kernel: Int3 = 1, stride: Int3 = 1,
                 padding: Int3 = 0, act: str = "relu"):
        super().__init__()
        self.conv = Conv3d(cin, cout, _triple(kernel), _triple(stride), _triple(padding),
                              bias=False)
        self.bn = BN3D(cout)
        self.act = act

    def forward(self, x):
        return act_fn(self.act)(self.bn(self.conv(x)))


class SepConv3d(nn.Module):
    """Spatial (1,k,k) then temporal (k,1,1) factored conv (`S3D/model.py:63-82`;
    ``spatial_bn=False``: `new_model/Conv3d.py:24-43`)."""

    def __init__(self, cin: int, cout: int, kernel: Int3 = 3, stride: int = 1,
                 padding: Int3 = 1, act: str = "relu", spatial_bn: bool = True,
                 spatial_act: bool = True, depthwise: bool = False):
        super().__init__()
        kt, kh, kw = _triple(kernel)
        pt, ph, pw = _triple(padding)
        s = stride
        if depthwise:
            cout = cin
        groups = cin if depthwise else 1
        self.conv_s = Conv3d(cin, cout, (1, kh, kw), (1, s, s), (0, ph, pw), groups=groups,
                                bias=False)
        self.bn_s = BN3D(cout) if spatial_bn else None
        self.conv_t = Conv3d(cout, cout, (kt, 1, 1), (s, 1, 1), (pt, 0, 0), groups=groups,
                                bias=False)
        self.bn_t = BN3D(cout)
        self.act = act
        self.spatial_act = spatial_act

    def forward(self, x):
        x = self.conv_s(x)
        if self.bn_s is not None:
            x = self.bn_s(x)
        if self.spatial_act:
            x = act_fn(self.act)(x)
        return act_fn(self.act)(self.bn_t(self.conv_t(x)))


class DWSepConv3d(SepConv3d):
    """Depthwise separable 3D conv (`new_model/Conv3d.py:45-64`): grouped
    spatial then grouped temporal conv, BN and ReLU6 after the temporal one
    only. Its keys sit directly under the module (``conv_s``, ``conv_t``,
    ``bn_t``), as the reference's."""

    def __init__(self, channels: int, kernel: Int3, stride: int = 1, padding: Int3 = 0):
        super().__init__(channels, channels, kernel, stride, padding, act="relu6",
                         spatial_bn=False, spatial_act=False, depthwise=True)


def max_pool3d(x, kernel: Tuple[int, int, int], strides: Tuple[int, int, int],
               padding: Tuple[int, int, int] = (0, 0, 0)):
    """Max-pool with −inf padding (JAX's ``reduce_window`` identity)."""
    return F.max_pool3d(x, kernel, strides, padding)


def avg_pool3d(x, kernel: Tuple[int, int, int]):
    """Stride-1 mean over ``kernel`` windows, no padding; a bf16 ``x``'s
    summed in fp32 and rounded once (torch's CPU pool has no bf16 kernel)."""
    return F.avg_pool3d(widen(x), kernel, stride=1).to(x.dtype)


@functools.lru_cache(maxsize=2)
def _srm_kernel(name: str, rescale: float) -> np.ndarray:
    """(1,5,5,3,K) DHWIO bank from the asset: filter k applied to every RGB
    channel, ×``rescale`` (÷3 for the 30-bank, ×1 for the msca 3-bank;
    `HPF.py:24-27,52-55`), as `fac_fake_tpu/models/s3d/layers.py:143-154`."""
    bank = np.load(os.path.join(ASSETS, name))  # (K, 5, 5)
    k = bank.shape[0]
    w = np.zeros((1, 5, 5, 3, k), np.float32)
    for i in range(k):
        for c in range(3):
            w[0, :, :, c, i] = bank[i] * rescale
    w.flags.writeable = False
    return w


def srm_weight(full: bool = True) -> torch.Tensor:
    """The SRM bank as a torch (K, 3, 1, 5, 5) conv weight."""
    w = _srm_kernel("srm_30.npy", 1.0 / 3.0) if full else _srm_kernel("srm_msca3.npy", 1.0)
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (4, 3, 0, 1, 2))))


def srm_filter(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Frozen SRM high-pass bank: (B,3,T,H,W) → (B,K,T,H,W), padding (0,2,2)
    (the residual input of the msca family is ``x + srm_filter(x, w3)``)."""
    return F.conv3d(x, weight, padding=(0, 2, 2))
