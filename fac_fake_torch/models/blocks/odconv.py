"""ODConv2d, omni-dimensional dynamic convolution — the port of
`fac_fake_tpu/models/blocks/odconv.py` (`other/cvit_GGCA_ADD_ODConv.py:158-293`).

An attention head on the map's spatial mean (1×1 conv, BatchNorm, ReLU)
gives four attentions: over the input channels, the output channels, the
k×k taps (sigmoids of ``/ temperature``) and the ``kernel_num`` candidate
kernels (a softmax). Each sample's kernel is the candidates blended by its
kernel attention, times its tap attention; the input times its channel
attention is convolved with it, and the output times its filter attention.
JAX vmaps the per-sample convolution over the batch; here it is one conv
with the batch folded into the groups (its backward too). NCHW in and out,
in the input's dtype. In training the head's BatchNorm normalizes by the
batch's B values a channel and moves its running stats by flax's rule.

The weight is the reference's (kernel_num, O, I, k, k). The JAX package's
`export_cvit` writes it as flax holds it, (kernel_num, k, k, I, O) (its
inverse transforms have no case for the ODConv layout); such a tensor
loads too, transposed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fac_fake_torch.models.layers import Conv2d, batch_norm, widen


class Attention(nn.Module):
    """The reference's ``attention`` head (``fc``, ``bn``, ``channel_fc``,
    ``filter_fc``, ``spatial_fc``, ``kernel_fc``)."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int, kernel_num: int,
                 reduction: float):
        super().__init__()
        att = max(int(in_planes * reduction), 16)
        self.fc = Conv2d(in_planes, att, 1, bias=False)
        self.bn = batch_norm(att)
        self.channel_fc = Conv2d(att, in_planes, 1)
        self.filter_fc = Conv2d(att, out_planes, 1)
        self.spatial_fc = Conv2d(att, kernel_size * kernel_size, 1)
        self.kernel_fc = Conv2d(att, kernel_num, 1)
        self.relu = nn.ReLU()


class ODConv2d(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, reduction: float = 0.0625,
                 kernel_num: int = 4, temperature: float = 1.0):
        super().__init__()
        self.stride, self.padding, self.temperature = stride, padding, temperature
        self.attention = Attention(in_planes, out_planes, kernel_size, kernel_num, reduction)
        self.weight = nn.Parameter(torch.empty(kernel_num, out_planes, in_planes, kernel_size,
                                               kernel_size))

    def reset_own(self, gen: torch.Generator) -> None:
        """He-normal over each candidate's fan-in (JAX: ``he_normal`` with
        in_axis (k, k, I))."""
        fan_in = self.weight[0, 0].numel()
        self.weight.data.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)

    def _apply(self, fn, recurse=True):
        """``Module.to``'s conversions, with the 5-D weight converted as its
        4-D (kernel_num·O, I, k, k) view: ``channels_last`` takes 4-D
        tensors only, and the model converts to it whole."""
        shape = self.weight.shape
        fn5 = lambda t: fn(t.flatten(0, 1)).reshape(shape) if t.dim() == 5 else fn(t)
        return super()._apply(fn5, recurse)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "weight"
        t = state_dict.get(key)
        kn, o, i, k, _ = self.weight.shape
        if t is not None and tuple(t.shape) == (kn, k, k, i, o) != tuple(self.weight.shape):
            state_dict[key] = t.permute(0, 4, 3, 1, 2)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, cin, h, w = x.shape
        kn, cout, _, k, _ = self.weight.shape
        att, t = self.attention, self.temperature
        a = att.relu(att.bn(att.fc(x.mean(dim=(2, 3), keepdim=True))))
        ch_att = torch.sigmoid(att.channel_fc(a) / t)                        # (b, Ci, 1, 1)
        f_att = torch.sigmoid(att.filter_fc(a) / t)                          # (b, Co, 1, 1)
        s_att = torch.sigmoid(att.spatial_fc(a) / t).reshape(b, 1, 1, k, k)
        k_att = torch.softmax(att.kernel_fc(a) / t, dim=1).reshape(b, kn, 1, 1, 1, 1)
        # the blend in the weight's dtype (JAX: a bf16 attention times the
        # fp32 candidates is fp32), rounded once to x's for the conv
        agg = (widen(k_att) * self.weight[None]).sum(dim=1) * widen(s_att)   # (b, Co, Ci, k, k)
        y = F.conv2d((x * ch_att).reshape(1, b * cin, h, w),
                     agg.reshape(b * cout, cin, k, k).to(x.dtype),
                     stride=self.stride, padding=self.padding, groups=b)
        return y.reshape(b, cout, y.shape[2], y.shape[3]) * f_att
