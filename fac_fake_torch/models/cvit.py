"""CViT — Convolutional Vision Transformer, the port of
`fac_fake_tpu/models/cvit.py` for base ``cvit`` and the flagship
``cvit_repbn8``.

The module tree mirrors the reference torch CViT
(`CViT-main/model/cvit.py:80-179`): ``features.{i}``,
``patch_to_embedding``, ``cls_token``, ``pos_embedding``,
``transformer.layers.{i}``, ``mlp_head.{0,2}``. A model of several stems
names them ``features1``, ``features2`` (``features3``), as the reference
variants do (JAX `compat/torch_weights.py:76-81`), and runs them in order;
``use_ggca`` then takes ``x · ggca(x)`` of the last stem's map (the
flagship, `cvit_GGCA_ADD_DEConv_RepBn8.py:438-439`): GGCA returns x·gates,
so the net effect is x²·gates.

Quirks kept:
  * ``pos_mode='legacy'``: the (32, 1, dim) *batch-indexed* positional
    embedding (`model/cvit.py:154,174-175`), one learned vector per batch
    row; ``pos_indices`` picks the row per sample, which is how the scorer
    reproduces the reference's 0:32/32:64/64:90 chunking in one forward;
  * ``pos_mode='patch'``: the per-position embedding;
  * patchify token order ``(h w)(p1 p2 c)``.

``quant_dense`` (JAX `CViT.quant_dense`): the patch embedding, every
attention ``to_qkv``/``to_out``, every FFN ``net.0``/``net.2`` and
``mlp_head.0`` are int8 `QuantLinear`s, as `compat/quantize.py` writes
them; ``mlp_head.2``, the 2-logit output, stays fp.

Input is NCHW float (the first conv's input; `ops/preprocess.py` hands it
over in ``channels_last`` memory), as the reference torch model takes it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from fac_fake_torch.core.registry import register
from fac_fake_torch.models.blocks.ggca import GGCA
from fac_fake_torch.models.layers import TransformerEncoder, mlp_head, quant_linear
from fac_fake_torch.models.stems import (Stem, StemSpec, repbn8_stem1, repbn8_stem2,
                                         vgg_stem, walk_counts)

LEGACY_POS_ROWS = 32
# the constructor's stem arguments, in the order the stems run
STEM_FIELDS = ("stem_spec", "stem2_spec", "stem3_spec")


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
                 pos_mode: str = "legacy", ffn_norm: str = "ln",
                 quant_dense: bool = False, stem2_spec: Optional[StemSpec] = None,
                 stem3_spec: Optional[StemSpec] = None, use_ggca: bool = False):
        super().__init__()
        specs = {f: tuple(s) for f, s in zip(STEM_FIELDS, (stem_spec, stem2_spec, stem3_spec))
                 if s is not None}
        if list(specs) != list(STEM_FIELDS[:len(specs)]):
            raise ValueError("stem3_spec needs a stem2_spec")
        # constructor arguments, so `compat/fold.py` and `compat/quantize.py`
        # can rebuild the model
        self.config = dict(image_size=image_size, patch_size=patch_size,
                           num_classes=num_classes, dim=dim, depth=depth, heads=heads,
                           mlp_dim=mlp_dim, pos_mode=pos_mode, ffn_norm=ffn_norm,
                           quant_dense=quant_dense, use_ggca=use_ggca, **specs)
        self.stem_spec = specs["stem_spec"]
        self.patch_size = patch_size
        self.dim = dim
        self.pos_mode = pos_mode
        self.quant_dense = quant_dense
        self.use_ggca = use_ggca
        #: {constructor field: module name}: ``features``, or ``features1``...
        self.stem_names = ({"stem_spec": "features"} if len(specs) == 1 else
                           {f: f"features{i + 1}" for i, f in enumerate(specs)})
        ch, pools = 3, 0
        for field, name in self.stem_names.items():
            stem = Stem(specs[field], ch)
            setattr(self, name, stem)
            ch, pools = stem.out_channels, pools + stem.pools
        if use_ggca:
            self.ggca = GGCA(ch)
        side = image_size // (2 ** pools) // patch_size
        num_patches = side * side
        patch_dim = ch * patch_size ** 2
        self.patch_to_embedding = quant_linear(patch_dim, dim, quant_dense)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        if pos_mode == "legacy":
            self.pos_embedding = nn.Parameter(torch.empty(LEGACY_POS_ROWS, 1, dim))
        elif pos_mode == "patch":
            self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim))
        else:
            raise ValueError(f"unknown pos_mode {pos_mode}")
        self.transformer = TransformerEncoder(dim, depth, heads, mlp_dim, ffn_norm,
                                              quant_dense)
        self.mlp_head = mlp_head(dim, mlp_dim, num_classes, quant_dense)

    def stems(self) -> List[Tuple[str, str, Stem]]:
        """(constructor field, module name, `Stem`) of each stem, in order."""
        return [(f, n, getattr(self, n)) for f, n in self.stem_names.items()]

    def stem_ops(self) -> List[Tuple]:
        """The ops of every stem's spec, in the order they run."""
        return [op for f in self.stem_names for op in self.config[f]]

    def walk_counts(self) -> Dict[str, int]:
        """What one `forward_crops` runs in its stems, summed over them
        (`stems.walk_counts`: the first stem from the crops, each later one
        from the fp map before it)."""
        counts = [walk_counts(self.config[f], crops=i == 0)
                  for i, f in enumerate(self.stem_names)]
        return {k: sum(c.get(k, 0) for c in counts) for k in counts[0]}

    def forward(self, img: torch.Tensor,
                pos_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._head(self._after_first_stem(self.stems()[0][2](img)), pos_indices)

    def forward_crops(self, crops_u8: torch.Tensor, dtype: torch.dtype = torch.float32,
                      pos_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """uint8 NHWC (B, H, W, 3) crops → what `forward` gives for their
        ImageNet normalize in ``dtype`` (`Stem.forward_crops`: on the card,
        K2 makes the first stem's input, and a quantized stem's int8 walk
        starts from K2's int8 entry; a later stem's walk quantizes its fp
        input in one pass)."""
        x = self.stems()[0][2].forward_crops(crops_u8, dtype)
        return self._head(self._after_first_stem(x), pos_indices)

    def _after_first_stem(self, x: torch.Tensor) -> torch.Tensor:
        """The later stems, then ``x · ggca(x)`` with ``use_ggca``."""
        for _, _, stem in self.stems()[1:]:
            x = stem(x)
        if self.use_ggca:
            x = x * self.ggca(x)
        return x

    def _head(self, x: torch.Tensor, pos_indices: Optional[torch.Tensor]) -> torch.Tensor:
        """The stem's NCHW output → logits."""
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


@register("model", "cvit_repbn8")
def _build_cvit_repbn8(cfg) -> CViT:
    """flagship cvit_GGCA_ADD_DEConv_RepBn8.py: two DEConv stems, x·GGCA(x),
    LinearNorm FFN pre-norms"""
    return CViT(repbn8_stem1(), stem2_spec=repbn8_stem2(), use_ggca=True,
                ffn_norm="linearnorm", **_common(cfg))
