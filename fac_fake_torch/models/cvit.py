"""CViT — Convolutional Vision Transformer, the port of
`fac_fake_tpu/models/cvit.py`: base ``cvit``, the flagship ``cvit_repbn8``
and the variant zoo, every entry of the JAX registry.

The module tree mirrors the reference torch CViT
(`CViT-main/model/cvit.py:80-179`): ``features.{i}``,
``patch_to_embedding``, ``cls_token``, ``pos_embedding``,
``transformer.layers.{i}``, ``mlp_head.{0,2}``. A model of several stems
names them ``features1``, ``features2`` (``features3``), as the reference
variants do (JAX `compat/torch_weights.py:74-78`), and runs them in order.

A variant is data, as in the JAX package: up to three stem specs
(`models/stems.py`), a block slot after each stem (``slot1..3``: (kind,
mode, channels), mode ``replace`` (``x = block(x)``), ``add`` (``x +
block(x)``) or ``mul`` (``x · block(x)``)), an embedding-space block
(``embed_block``: ``("sla", n)``, linear attention over the embedding
axis, the n patches as features, added; or ``("glu", dim, h, w)``, a
ConvolutionalGLU on the h × w patch tokens, replacing them) and a
token-space block (``token_block``: ``("mdfa" | "bfm", 2)`` on the
(B, 2, dim) tokens seen as a 2-channel √dim × √dim map). A block's module
is named by its kind (``ggca``, ``bfm``, ``mdfa``, ``odconv``, ``moga``,
``smfa``, ``uffc``, ``sla``, ``glu``), as in the reference files.
``use_ggca`` takes ``x · ggca(x)`` of the last stem's map (the flagship,
`cvit_GGCA_ADD_DEConv_RepBn8.py:438-439`): GGCA returns x·gates, so the
net effect is x²·gates. Placements and modes follow each reference file's
forward (cited per registration below); file-name vs math mismatches are
kept (``cvit_ggca_add`` multiplies).

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
them; ``mlp_head.2``, the 2-logit output, and the zoo's blocks stay fp.

Input is NCHW float (the first conv's input; `ops/preprocess.py` hands it
over in ``channels_last`` memory), as the reference torch model takes it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from fac_fake_torch.core.registry import register
from fac_fake_torch.models.blocks.attention2d import BFM, MDFA
from fac_fake_torch.models.blocks.ggca import GGCA
from fac_fake_torch.models.blocks.glu import ConvolutionalGLU
from fac_fake_torch.models.blocks.moga import MultiOrderGatedAggregation
from fac_fake_torch.models.blocks.odconv import ODConv2d
from fac_fake_torch.models.blocks.sla import SimplifiedLinearAttention
from fac_fake_torch.models.blocks.smfa import SMFA
from fac_fake_torch.models.blocks.uffc import FourierUnitModified
from fac_fake_torch.models.layers import TransformerEncoder, mlp_head, quant_linear
from fac_fake_torch.models.stems import (Stem, StemSpec, deconv_stem1, deconv_stem2, glu_stem,
                                         idw_stem, odconv_stem1, repbn3_stems, repbn4_stem2,
                                         repbn8_stem1, repbn8_stem2, repbn_stem1, scconv_stem1,
                                         sla_stems, vgg_split, vgg_stem, walk_counts,
                                         wtconv_stem)

LEGACY_POS_ROWS = 32
# the constructor's stem arguments, in the order the stems run
STEM_FIELDS = ("stem_spec", "stem2_spec", "stem3_spec")
SLOT_FIELDS = ("slot1", "slot2", "slot3")
BlockRef = Tuple[str, str, int]     # (kind, mode, channels) of a slot

# a slot's block from its kind, (channels, map side) of the map it runs on
_SLOT_BLOCKS = {
    "ggca": lambda ch, side: GGCA(ch),
    "bfm": lambda ch, side: BFM(ch),
    "mdfa": lambda ch, side: MDFA(ch, ch),
    "odconv": lambda ch, side: ODConv2d(ch, ch, 3),
    "moga": lambda ch, side: MultiOrderGatedAggregation(ch),
    "smfa": lambda ch, side: SMFA(ch),
    "uffc": lambda ch, side: FourierUnitModified(ch, side),
}


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
                 stem3_spec: Optional[StemSpec] = None, use_ggca: bool = False,
                 slot1: Optional[BlockRef] = None, slot2: Optional[BlockRef] = None,
                 slot3: Optional[BlockRef] = None, embed_block: Optional[Tuple] = None,
                 token_block: Optional[Tuple] = None):
        super().__init__()
        specs = {f: tuple(s) for f, s in zip(STEM_FIELDS, (stem_spec, stem2_spec, stem3_spec))
                 if s is not None}
        if list(specs) != list(STEM_FIELDS[:len(specs)]):
            raise ValueError("stem3_spec needs a stem2_spec")
        slots = {f: tuple(b) for f, b in zip(SLOT_FIELDS, (slot1, slot2, slot3))
                 if b is not None}
        if "slot2" in slots and len(specs) < 2:
            raise ValueError("slot2 needs a stem2_spec")
        extra = {k: tuple(v) for k, v in (("embed_block", embed_block),
                                          ("token_block", token_block)) if v is not None}
        # constructor arguments, so `compat/fold.py` and `compat/quantize.py`
        # can rebuild the model
        self.config = dict(image_size=image_size, patch_size=patch_size,
                           num_classes=num_classes, dim=dim, depth=depth, heads=heads,
                           mlp_dim=mlp_dim, pos_mode=pos_mode, ffn_norm=ffn_norm,
                           quant_dense=quant_dense, use_ggca=use_ggca, **specs, **slots,
                           **extra)
        self.stem_spec = specs["stem_spec"]
        self.patch_size = patch_size
        self.dim = dim
        self.pos_mode = pos_mode
        self.quant_dense = quant_dense
        self.use_ggca = use_ggca
        #: {constructor field: module name}: ``features``, or ``features1``...
        self.stem_names = ({"stem_spec": "features"} if len(specs) == 1 else
                           {f: f"features{i + 1}" for i, f in enumerate(specs)})
        #: {slot field: (kind, mode)}: slot1 after the first stem, slot2
        #: after the second, slot3 after the last
        self.slot_modes: Dict[str, Tuple[str, str]] = {}
        kinds = []
        ch, pools, ends = 3, 0, []
        for field, name in self.stem_names.items():
            stem = Stem(specs[field], ch)
            setattr(self, name, stem)
            ch, pools = stem.out_channels, pools + stem.pools
            ends.append((ch, pools))
        for f, (kind, mode, arg) in slots.items():
            at_ch, at_pools = ends[-1] if f == "slot3" else ends[SLOT_FIELDS.index(f)]
            if mode not in ("replace", "add", "mul") or kind not in _SLOT_BLOCKS:
                raise ValueError(f"{f}: unknown block {slots[f]}")
            if kind != "ggca" and arg != at_ch:
                raise ValueError(f"{f}: {kind} on {arg} channels, the map has {at_ch}")
            setattr(self, kind, _SLOT_BLOCKS[kind](at_ch, image_size >> at_pools))
            self.slot_modes[f] = (kind, mode)
            kinds.append(kind)
        if use_ggca:
            self.ggca = GGCA(ch)
            kinds.append("ggca")
        side = image_size // (2 ** pools) // patch_size
        num_patches = side * side
        patch_dim = ch * patch_size ** 2
        self.patch_to_embedding = quant_linear(patch_dim, dim, quant_dense)
        self.embed_kind = self.token_kind = None
        if embed_block is not None:
            self.embed_kind = embed_block[0]
            if embed_block[0] == "sla" and embed_block[1] == num_patches:
                self.sla = SimplifiedLinearAttention(num_patches)
            elif embed_block[0] == "glu" and tuple(embed_block[1:]) == (dim, side, side):
                self.glu = ConvolutionalGLU(dim)
                self.glu_hw = (side, side)
            else:
                raise ValueError(f"embed_block {embed_block}: {num_patches} patches of "
                                 f"{side}x{side}, dim {dim}")
            kinds.append(self.embed_kind)
        if token_block is not None:
            kind, arg = token_block
            tside = int(round(dim ** 0.5))
            if kind not in ("mdfa", "bfm") or arg != num_patches + 1 or tside * tside != dim:
                raise ValueError(f"token_block {token_block}: {num_patches + 1} tokens of "
                                 f"dim {dim}")
            self.token_kind, self.token_side = kind, tside
            setattr(self, kind, MDFA(arg, arg) if kind == "mdfa" else BFM(arg))
            kinds.append(kind)
        if len(set(kinds)) != len(kinds):
            raise ValueError(f"two blocks of one kind would share a module name: {kinds}")
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

    def forward(self, img: Optional[torch.Tensor],
                pos_indices: Optional[torch.Tensor] = None,
                features_override: Optional[torch.Tensor] = None,
                embed_override: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits of ``img``. The Grad-CAM hooks (JAX `CViT.__call__`'s):
        ``features_override`` stands for `stem_features` (the stems' NCHW
        output, after every slot and GGCA) and ``embed_override`` for
        `patch_tokens` (the patch embedding's (B, n, dim) output, before the
        SLA/GLU embedding block, the cls token and the positions); ``img``
        is not read where an override stands for what it would give."""
        if embed_override is None:
            x = self.stem_features(img) if features_override is None else features_override
            embed_override = self.patch_tokens(x)
        return self._head(embed_override, pos_indices)

    def forward_crops(self, crops_u8: torch.Tensor, dtype: torch.dtype = torch.float32,
                      pos_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """uint8 NHWC (B, H, W, 3) crops → what `forward` gives for their
        ImageNet normalize in ``dtype`` (`Stem.forward_crops`: on the card,
        K2 makes the first stem's input, and a quantized stem's int8 walk
        starts from K2's int8 entry; a later stem's walk quantizes its fp
        input in one pass)."""
        return self._head(self.patch_tokens(self.stem_features_crops(crops_u8, dtype)),
                          pos_indices)

    def stem_features(self, img: torch.Tensor) -> torch.Tensor:
        """The stems' NCHW output from the NCHW float input (JAX's sown
        ``stem_features``)."""
        return self._after_first_stem(self.stems()[0][2](img))

    def stem_features_crops(self, crops_u8: torch.Tensor,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """`stem_features` of uint8 NHWC crops, their normalize by K2."""
        return self._after_first_stem(self.stems()[0][2].forward_crops(crops_u8, dtype))

    def patch_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The patch embedding of the stems' NCHW output: (B, n, dim), JAX's
        sown ``patch_tokens``."""
        return self.patch_to_embedding(patchify(x, self.patch_size))

    def _block(self, x: torch.Tensor, kind: str, mode: str) -> torch.Tensor:
        y = getattr(self, kind)(x, x) if kind == "bfm" else getattr(self, kind)(x)
        if mode == "replace":
            return y
        return x + y if mode == "add" else x * y

    def _slot(self, x: torch.Tensor, field: str) -> torch.Tensor:
        if field not in self.slot_modes:
            return x
        kind, mode = self.slot_modes[field]
        return self._block(x, kind, mode)

    def _after_first_stem(self, x: torch.Tensor) -> torch.Tensor:
        """slot1, the later stems (stem 2 and slot2, stem 3), slot3, then
        ``x · ggca(x)`` with ``use_ggca`` (JAX `CViT.__call__` :121-140)."""
        stems = self.stems()
        x = self._slot(x, "slot1")
        if len(stems) > 1:
            x = self._slot(stems[1][2](x), "slot2")
        if len(stems) > 2:
            x = stems[2][2](x)
        x = self._slot(x, "slot3")
        if self.use_ggca:
            x = x * self.ggca(x)
        return x

    def _head(self, y: torch.Tensor, pos_indices: Optional[torch.Tensor]) -> torch.Tensor:
        """The patch tokens (`patch_tokens`) → logits."""
        if self.embed_kind == "sla":
            # the embedding's channels are SLA's tokens (`cvit_GGCA_SLA.py`)
            y = y + self.sla(y.transpose(1, 2)).transpose(1, 2)
        elif self.embed_kind == "glu":
            y = self.glu(y, *self.glu_hw)
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
        if self.token_kind is not None:
            # the tokens as a map of one channel a token (`cvit_BFM_GGCA_MDFA.py:484-489`)
            n, s = tokens.shape[1], self.token_side
            tokens = self._block(tokens.reshape(b, n, s, s), self.token_kind,
                                 "replace").reshape(b, n, self.dim)
        tokens = self.transformer(tokens)
        return self.mlp_head(tokens[:, 0]).float()


# ---------------------------------------------------------------------------
# the registry: placements extracted from each reference file's forward, as
# the JAX package registers them (`fac_fake_tpu/models/cvit.py:233-315`)
# ---------------------------------------------------------------------------

def _common(cfg) -> dict:
    return dict(image_size=cfg.image_size, patch_size=cfg.patch_size,
                num_classes=cfg.num_classes, dim=cfg.dim, depth=cfg.depth,
                heads=cfg.heads, mlp_dim=cfg.mlp_dim,
                pos_mode=cfg.pos_embedding_mode)


def _reg(name: str, doc: str, **fixed) -> None:
    def build(cfg, _fixed=fixed) -> CViT:
        return CViT(**_common(cfg), **_fixed)
    build.__doc__ = doc
    build.__name__ = f"_build_{name}"
    register("model", name)(build)


_VGG1, _VGG2 = vgg_split()          # split after the 256-ch stage (14×14)

_reg("cvit", "canonical CViT(224,7,2,512,1024,6,8,2048) — model/cvit.py",
     stem_spec=vgg_stem())
_reg("cvit_repbn8", "flagship cvit_GGCA_ADD_DEConv_RepBn8.py: two DEConv stems, "
     "x·GGCA(x), LinearNorm FFN pre-norms",
     stem_spec=repbn8_stem1(), stem2_spec=repbn8_stem2(), use_ggca=True,
     ffn_norm="linearnorm")
_reg("cvit_ggca", "other/cvit_GGCA.py: GGCA replace post-stem",
     stem_spec=vgg_stem(), slot1=("ggca", "replace", 512))
_reg("cvit_ggca_add", "cvit_GGCA_ADD.py: x·GGCA(x) post-stem (name says add, "
     "code multiplies)", stem_spec=vgg_stem(), slot1=("ggca", "mul", 512))
_reg("cvit_ggca_add_repbn", "cvit_GGCA_ADD_RepBn.py: GGCA add + LinearNorm FFN",
     stem_spec=vgg_stem(), slot1=("ggca", "add", 512), ffn_norm="linearnorm")
_reg("cvit_ggca4", "other/cvit_GGCA4.py: GGCA replace at 256ch/14²",
     stem_spec=_VGG1, stem2_spec=_VGG2, slot1=("ggca", "replace", 256))
_reg("cvit_ggca_add3", "other/cvit_GGCA_ADD3.py: GGCA add at 256ch/14²",
     stem_spec=_VGG1, stem2_spec=_VGG2, slot1=("ggca", "add", 256))
_reg("cvit_deconv", "cvit_DEConv.py: DEConv stems + LinearNorm FFN, no GGCA",
     stem_spec=deconv_stem1(), stem2_spec=deconv_stem2(), ffn_norm="linearnorm")
_reg("cvit_ggca_add_deconv", "cvit_GGCA_ADD_DEConv.py: DEConv stems, GGCA mul",
     stem_spec=deconv_stem1(), stem2_spec=deconv_stem2(), use_ggca=True)
_reg("cvit_repbn", "cvit_GGCA_ADD_DEConv_RepBn.py: sparse-DEConv stem, GGCA "
     "add, LinearNorm", stem_spec=repbn_stem1(), stem2_spec=vgg_split()[1],
     slot2=("ggca", "add", 512), ffn_norm="linearnorm")
_reg("cvit_repbn3", "cvit_GGCA_ADD_DEConv_RepBn3.py: GGCA add at 64ch/56²",
     **repbn3_stems(), ffn_norm="linearnorm")
_reg("cvit_repbn4", "cvit_GGCA_ADD_DEConv_RepBn4.py",
     stem_spec=deconv_stem1(tail_deconv=False), stem2_spec=repbn4_stem2(),
     slot2=("ggca", "add", 512), ffn_norm="linearnorm")
_reg("cvit_repbn5", "cvit_GGCA_ADD_DEConv_RepBn5.py (RepBn8 stems, GGCA add)",
     stem_spec=repbn8_stem1(), stem2_spec=repbn8_stem2(),
     slot2=("ggca", "add", 512), ffn_norm="linearnorm")
_reg("cvit_ggca_add_dconv", "cvit_GGCA_ADD_DConv.py: InceptionDW stem, GGCA add",
     stem_spec=idw_stem(), slot1=("ggca", "add", 512))
_reg("cvit_ggca_add_scconv", "other/cvit_GGCA_ADD_ScConv.py",
     stem_spec=scconv_stem1(), stem2_spec=vgg_split()[1],
     slot2=("ggca", "add", 512))
_reg("cvit_ggca_add_wtconv", "other/cvit_GGCA_ADD_WTConv.py",
     stem_spec=wtconv_stem(), slot1=("ggca", "add", 512))
_reg("cvit_ggca_add_odconv", "other/cvit_GGCA_ADD_ODConv.py: ODConv stem ops",
     stem_spec=odconv_stem1(), stem2_spec=vgg_split()[1],
     slot2=("ggca", "add", 512))
_reg("cvit_ggca_odconv", "other/cvit_GGCA_ODConv.py: ODConv block at 256ch",
     stem_spec=_VGG1, stem2_spec=_VGG2, slot1=("odconv", "replace", 256),
     slot2=("ggca", "replace", 512))
_reg("cvit_ggca_add_moga", "other/cvit_GGCA_ADD_MOGA.py: MOGA at 64ch/56²",
     stem_spec=vgg_split(2)[0], stem2_spec=vgg_split(2)[1],
     slot1=("moga", "replace", 64), slot2=("ggca", "add", 512))
_reg("cvit_ggca_smfa", "other/cvit_GGCA_SMFA.py: SMFA residual at 256ch",
     stem_spec=_VGG1, stem2_spec=_VGG2, slot1=("smfa", "add", 256),
     slot2=("ggca", "add", 512))
_reg("cvit_ggca_uffc", "other/cvit_GGCA_UFFC.py: Fourier unit at 256ch/14²",
     stem_spec=_VGG1, stem2_spec=_VGG2, slot1=("uffc", "replace", 256),
     slot2=("ggca", "replace", 512))
_reg("cvit_ggca_sla", "other/cvit_GGCA_SLA.py: 28² stems + linear attention "
     "over the embedding axis (16 patches act as features)",
     **sla_stems(), embed_block=("sla", 16))
_reg("cvit_ggca_add_glu", "other/cvit_GGCA_ADD_GLUconv.py: 56² stem + "
     "ConvGLU on 64 tokens", stem_spec=glu_stem(),
     slot1=("ggca", "add", 512), embed_block=("glu", 1024, 8, 8))
_reg("cvit_ggca4_bfm5", "other/cvit_GGCA4_BFM5.py",
     stem_spec=_VGG1, stem2_spec=_VGG2, slot1=("ggca", "replace", 256),
     slot2=("bfm", "replace", 512))
_reg("cvit_ggca4_mdfa5", "other/cvit_GGCA4_MDFA5.py",
     stem_spec=_VGG1, stem2_spec=_VGG2, slot1=("mdfa", "replace", 256),
     slot2=("ggca", "replace", 512))
_reg("cvit_bfm_ggca_mdfa", "other/cvit_BFM_GGCA_MDFA.py: BFM mid, GGCA post, "
     "MDFA on tokens", stem_spec=_VGG1, stem2_spec=_VGG2,
     slot1=("bfm", "replace", 256), slot2=("ggca", "replace", 512),
     token_block=("mdfa", 2))
_reg("cvit_bfm_mdfa", "other/cvit_BFM_MDFA.py",
     stem_spec=_VGG1, stem2_spec=_VGG2, slot1=("bfm", "replace", 256),
     slot2=("mdfa", "replace", 512))
_reg("cvit_ggca_bfm_mdfa", "other/cvit_GGCA_BFM_MDFA.py",
     stem_spec=_VGG1, stem2_spec=_VGG2, slot1=("ggca", "replace", 256),
     slot2=("bfm", "replace", 512), token_block=("mdfa", 2))
_reg("cvit_ggca_mdfa_bfm", "other/cvit_GGCA_MDFA_BFM.py",
     stem_spec=_VGG1, stem2_spec=_VGG2, slot1=("ggca", "replace", 256),
     slot2=("mdfa", "replace", 512), token_block=("bfm", 2))
_reg("cvit_mdfa_bfm", "other/cvit_MDFA_BFM.py",
     stem_spec=_VGG1, stem2_spec=_VGG2, slot1=("mdfa", "replace", 256),
     slot2=("bfm", "replace", 512))
_reg("cvit_mdfa_ggca_bfm", "other/cvit_MDFA_GGCA_BFM.py",
     stem_spec=_VGG1, stem2_spec=_VGG2, slot1=("mdfa", "replace", 256),
     slot2=("ggca", "replace", 512), token_block=("bfm", 2))
