"""CViT — Convolutional Vision Transformer, the port of
`fac_fake_tpu/models/cvit.py` for slot-free specs (base ``cvit``).

The module tree mirrors the reference torch CViT
(`CViT-main/model/cvit.py:80-179`): ``features.{i}``,
``patch_to_embedding``, ``cls_token``, ``pos_embedding``,
``transformer.layers.{i}``, ``mlp_head.{0,2}``.

Quirks kept:
  * ``pos_mode='legacy'``: the (32, 1, dim) *batch-indexed* positional
    embedding (`model/cvit.py:154,174-175`), one learned vector per batch
    row; ``pos_indices`` picks the row per sample, which is how the scorer
    reproduces the reference's 0:32/32:64/64:90 chunking in one forward;
  * ``pos_mode='patch'``: the per-position embedding;
  * patchify token order ``(h w)(p1 p2 c)``.

Input is NCHW float (the first conv's input; `ops/preprocess.py` hands it
over in ``channels_last`` memory), as the reference torch model takes it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fac_fake_torch.core.registry import register
from fac_fake_torch.models.layers import TransformerEncoder, mlp_head
from fac_fake_torch.models.stems import Stem, StemSpec, vgg_stem

LEGACY_POS_ROWS = 32


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """NCHW (b, c, h·p, w·p) → (b, h·w, p·p·c), the reference's
    `rearrange('b c (h p1) (w p2) -> b (h w) (p1 p2 c)')`."""
    b, c, hh, ww = x.shape
    h, w = hh // p, ww // p
    x = x.reshape(b, c, h, p, w, p).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, h * w, p * p * c)


class CViT(nn.Module):
    def __init__(self, stem_spec: StemSpec, image_size: int = 224,
                 patch_size: int = 7, num_classes: int = 2, dim: int = 1024,
                 depth: int = 6, heads: int = 8, mlp_dim: int = 2048,
                 pos_mode: str = "legacy", ffn_norm: str = "ln"):
        super().__init__()
        # constructor arguments, so `compat/fold.py` can rebuild the model
        self.config = dict(stem_spec=tuple(stem_spec), image_size=image_size,
                           patch_size=patch_size, num_classes=num_classes,
                           dim=dim, depth=depth, heads=heads, mlp_dim=mlp_dim,
                           pos_mode=pos_mode, ffn_norm=ffn_norm)
        self.stem_spec = tuple(stem_spec)
        self.patch_size = patch_size
        self.dim = dim
        self.pos_mode = pos_mode
        self.features = Stem(self.stem_spec)
        side = image_size // (2 ** self.features.pools) // patch_size
        num_patches = side * side
        patch_dim = self.features.out_channels * patch_size ** 2
        self.patch_to_embedding = nn.Linear(patch_dim, dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        if pos_mode == "legacy":
            self.pos_embedding = nn.Parameter(torch.empty(LEGACY_POS_ROWS, 1, dim))
        elif pos_mode == "patch":
            self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim))
        else:
            raise ValueError(f"unknown pos_mode {pos_mode}")
        self.transformer = TransformerEncoder(dim, depth, heads, mlp_dim, ffn_norm)
        self.mlp_head = mlp_head(dim, mlp_dim, num_classes)

    def forward(self, img: torch.Tensor,
                pos_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.features(img)
        y = self.patch_to_embedding(patchify(x, self.patch_size))
        b = y.shape[0]
        tokens = torch.cat([self.cls_token.expand(b, 1, self.dim).to(y.dtype), y], dim=1)
        if self.pos_mode == "legacy":
            if pos_indices is None and b > LEGACY_POS_ROWS:
                raise ValueError(
                    f"legacy pos-embedding caps batch at {LEGACY_POS_ROWS} "
                    f"(got {b}) — the reference's (32,1,dim) quirk "
                    "(model/cvit.py:154). Use pos_embedding_mode='patch' for "
                    "larger batches, or pass pos_indices.")
            pe = self.pos_embedding[:b] if pos_indices is None \
                else self.pos_embedding[pos_indices]
        else:
            pe = self.pos_embedding
        tokens = tokens + pe.to(tokens.dtype)
        tokens = self.transformer(tokens)
        return self.mlp_head(tokens[:, 0]).float()


def _common(cfg) -> dict:
    return dict(image_size=cfg.image_size, patch_size=cfg.patch_size,
                num_classes=cfg.num_classes, dim=cfg.dim, depth=cfg.depth,
                heads=cfg.heads, mlp_dim=cfg.mlp_dim,
                pos_mode=cfg.pos_embedding_mode)


@register("model", "cvit")
def _build_cvit(cfg) -> CViT:
    """canonical CViT(224,7,2,512,1024,6,8,2048) — model/cvit.py"""
    return CViT(vgg_stem(), **_common(cfg))
