"""DEConv, detail-enhanced convolution — the port of
`fac_fake_tpu/models/blocks/deconv.py`.

Five difference-operator branches (center, horizontal, vertical, angular
difference and a vanilla conv) whose 3×3 kernels sum into one weight, applied
as one stride-1 pad-1 convolution (`cvit_GGCA_ADD_DEConv_RepBn8.py:214-340`).
The module tree is the reference's: ``conv1_1.conv`` (cd), ``conv1_2.conv``
(hd, a ``Conv1d`` (O, I, 3)), ``conv1_3.conv`` (vd, ``Conv1d``),
``conv1_4.conv`` (ad) and ``conv1_5`` (std), each with a bias.

Weights are OIHW; the 9 taps flatten row-major (idx = 3·row + col), as the
JAX package's HWIO does, and compose in its order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# angular-diff permutation of the 9 kernel taps (`Conv2d_ad.get_weight`,
# cvit_GGCA_ADD_DEConv_RepBn8.py:246)
_AD_PERM = (3, 0, 1, 6, 4, 2, 7, 8, 5)


def compose_deconv_weight(w_cd: torch.Tensor, w_hd: torch.Tensor, w_vd: torch.Tensor,
                          w_ad: torch.Tensor, w_std: torch.Tensor) -> torch.Tensor:
    """The five branch kernels → one (O, I, 3, 3) weight. ``w_hd``/``w_vd``
    are the 1-D taps (O, I, 3); the others (O, I, 3, 3)."""
    o, i = w_cd.shape[:2]
    cd9 = w_cd.reshape(o, i, 9).clone()
    # center-difference: identity but the center tap, less the full sum
    cd9[..., 4] = cd9[..., 4] - w_cd.reshape(o, i, 9).sum(-1)
    # angular-difference: w − w[perm] (the reference's θ is 1 in every model)
    ad9 = w_ad.reshape(o, i, 9)
    ad9 = ad9 - ad9[..., list(_AD_PERM)]
    # horizontal-difference: left column +w, right column −w
    hd9 = w_hd.new_zeros((o, i, 9))
    hd9[..., [0, 3, 6]] = w_hd
    hd9[..., [2, 5, 8]] = -w_hd
    # vertical-difference: top row +w, bottom row −w
    vd9 = w_vd.new_zeros((o, i, 9))
    vd9[..., [0, 1, 2]] = w_vd
    vd9[..., [6, 7, 8]] = -w_vd
    w9 = cd9 + ad9 + hd9 + vd9 + w_std.reshape(o, i, 9)
    return w9.reshape(o, i, 3, 3)


_NAMES = ("conv1_1.conv", "conv1_2.conv", "conv1_3.conv", "conv1_4.conv", "conv1_5")


def compose_deconv_state(sd, prefix: str = "") -> tuple:
    """(weight, bias) of the one conv that a DEConv's weights (its state
    dict's keys under ``prefix``) compose into; the bias is the branches'
    sum in JAX's order (cd, hd, vd, ad, std)."""
    weight = compose_deconv_weight(*(sd[f"{prefix}{n}.weight"] for n in _NAMES))
    bias = sd[f"{prefix}{_NAMES[0]}.bias"]
    for name in _NAMES[1:]:
        bias = bias + sd[f"{prefix}{name}.bias"]
    return weight, bias


class _Branch(nn.Module):
    """A reference difference-conv wrapper: its kernel is ``.conv``."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv


class DEConv(nn.Module):
    """y = conv(x, w_cd + w_hd + w_vd + w_ad + w_std, Σb), stride 1 pad 1,
    on NCHW ``x``; ``dim`` channels in and out."""

    def __init__(self, dim: int):
        super().__init__()
        conv2d = lambda: nn.Conv2d(dim, dim, 3, padding=1, bias=True)
        conv1d = lambda: nn.Conv1d(dim, dim, 3, padding=1, bias=True)
        self.conv1_1 = _Branch(conv2d())
        self.conv1_2 = _Branch(conv1d())
        self.conv1_3 = _Branch(conv1d())
        self.conv1_4 = _Branch(conv2d())
        self.conv1_5 = conv2d()

    def composed(self) -> tuple:
        """(weight, bias) of the one conv the branches sum into."""
        return compose_deconv_state(dict(self.named_parameters()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.composed()
        return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), padding=1)
