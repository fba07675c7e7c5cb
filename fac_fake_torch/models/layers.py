"""Model building blocks of the base CViT — the port of the parts of
`fac_fake_tpu/models/layers.py` that base ``cvit`` uses.

Module and attribute names mirror the reference torch CViT
(`CViT-main/model/cvit.py:5-78`), so a reference ``.pth`` and the JAX
package's `export_cvit` output both load with ``strict=True``:
``transformer.layers.{i}.0.fn.norm`` / ``.0.fn.fn.to_qkv`` /
``.1.fn.fn.net.{0,2}``. Eval-mode only: BatchNorm uses its running stats.
"""
from __future__ import annotations

import torch
from torch import nn

# torch BatchNorm defaults, as the JAX package's TorchBatchNorm
BN_EPS = 1e-5
LN_EPS = 1e-5


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=1, padding=1, bias=True)


def batch_norm(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS)


class MultiHeadSelfAttention(nn.Module):
    """Reference CViT attention (`model/cvit.py:34-62`). Quirk kept: the
    softmax scale is ``dim ** -0.5`` on the model dimension, not the head
    dimension; qkv unpacks as ``(b, n, 3, h, head_dim)``."""

    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.scale = dim ** -0.5
        self.to_qkv = nn.Linear(dim, dim * 3, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h = self.heads
        qkv = self.to_qkv(x).reshape(b, n, 3, h, self.dim // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (b, h, n, hd)
        dots = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        attn = torch.softmax(dots.float(), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, self.dim)
        return self.to_out(out)


class FeedForward(nn.Module):
    """dim → hidden (exact GELU) → dim (`model/cvit.py:22-32`)."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU(),
                                 nn.Linear(hidden_dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fn(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class TransformerEncoder(nn.Module):
    """depth × (PreNorm-Attention + PreNorm-FFN) with residuals
    (`model/cvit.py:64-78`), the ``ffn_norm="ln"`` branch."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 ffn_norm: str = "ln"):
        super().__init__()
        if ffn_norm != "ln":
            raise NotImplementedError(
                f"ffn_norm={ffn_norm!r} (LinearNorm/RepBN) is ROADMAP queue 1 "
                "item 4, the flagship slice")
        self.layers = nn.ModuleList(
            nn.ModuleList([Residual(PreNorm(dim, MultiHeadSelfAttention(dim, heads))),
                           Residual(PreNorm(dim, FeedForward(dim, mlp_dim)))])
            for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, ffn in self.layers:
            x = ffn(attn(x))
        return x


def mlp_head(dim: int, mlp_dim: int, num_classes: int) -> nn.Sequential:
    """dim → mlp_dim (ReLU) → num_classes (`model/cvit.py:161-165`)."""
    return nn.Sequential(nn.Linear(dim, mlp_dim), nn.ReLU(),
                         nn.Linear(mlp_dim, num_classes))
