"""Simplified linear attention — the port of
`fac_fake_tpu/models/blocks/sla.py` (`other/cvit_GGCA_SLA.py:160-245`).

ReLU-kernelized linear attention over (B, N, C) tokens: ``qkv`` (Linear),
a learned positional encoding added to K (zeros at the start), ReLU on Q
and K, ``num_heads`` heads; each head's output is ``Q (Kᵀ V) / (Q · ΣK +
1e-6)`` (or ``(Q Kᵀ) V`` where that is cheaper, the reference's selector),
plus a depthwise 5×5 conv of V seen as a √N × √N map; then ``proj``. In the
CViT (``cvit_ggca_sla``) the tokens are the embedding's channels and the
features its patches. The module tree is the reference's (``qkv``,
``proj``, ``dwc``, ``positional_encoding``). In a bf16 model ``qkv``, the
local conv and ``proj`` compute in bf16 and the attention's products in
fp32 (the fp32 encoding promotes K, as in JAX's).
"""
from __future__ import annotations

import torch
from torch import nn

from fac_fake_torch.models.layers import Conv2d, Linear


class SimplifiedLinearAttention(nn.Module):
    def __init__(self, dim: int, window_size=(32, 32), num_heads: int = 8,
                 qkv_bias: bool = True, kernel_size: int = 5):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        hd = dim // num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.dwc = Conv2d(hd, hd, kernel_size, padding=kernel_size // 2, groups=hd)
        self.positional_encoding = nn.Parameter(
            torch.empty(1, window_size[0] * window_size[1], dim))
        self.relu = nn.ReLU()

    def reset_own(self, gen: torch.Generator) -> None:
        self.positional_encoding.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        hd = self.dim // h
        q, k, v = self.qkv(x).reshape(b, n, 3, c).unbind(2)
        # the fp32 encoding promotes K (JAX's promotion in a bf16 model), and
        # the products with K then run in its dtype
        k = k + self.positional_encoding[:, :n]
        q, k = self.relu(q), self.relu(k)
        split = lambda t: t.reshape(b, n, h, hd).transpose(1, 2).reshape(b * h, n, hd)
        q, k, v = split(q), split(k), split(v)
        qa, va = q.to(k.dtype), v.to(k.dtype)
        z = 1.0 / (torch.einsum("bic,bc->bi", qa, k.sum(dim=1)) + 1e-6)
        if n * n * (hd + hd) > hd * hd * (n + n):
            kv = torch.einsum("bjc,bjd->bcd", k, va)
            out = torch.einsum("bic,bcd->bid", qa, kv) * z[..., None]
        else:
            qk = torch.einsum("bic,bjc->bij", qa, k)
            out = torch.einsum("bij,bjd->bid", qk, va) * z[..., None]
        side = int(round(n ** 0.5))
        fm = self.dwc(v.reshape(b * h, side, side, hd).permute(0, 3, 1, 2))
        out = out + fm.permute(0, 2, 3, 1).reshape(b * h, n, hd)
        out = out.reshape(b, h, n, hd).transpose(1, 2).reshape(b, n, c)
        return self.proj(out.to(x.dtype))
