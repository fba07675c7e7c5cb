"""The ResNet/KAN family — the port of `fac_fake_tpu/models/resnet.py`.

  * ``reskan`` (`ResKan/kan_resnet.py:132-256`): a torchvision-style v1.5
    ResNet-34 (stride on the 3×3), global average pool, and the KAN head
    ``KAN([512·expansion, 64, classes])``;
  * ``resvitkan`` (`ResVitKan/ResVitKan.py:284-330`): the vendored
    ResNet-50, whose Bottleneck has a ReLU *before* the residual add
    (``relu_before_add``, `:170-182`) and a 2048→512 1×1 squeeze + BN tail
    (``channel``, ``bn2``), under ``features``; patchify, the CViT
    transformer, and the head ``kan_head`` = Linear, Dropout, ReLU, KAN;
  * ``resvit`` (`model/other/resvit.py:284-322`): the same skeleton on a
    ResNet-18 with no squeeze and the plain head ``mlp_head`` = Linear,
    Dropout, ReLU, Linear.

Module names give the reference torch keys (JAX `compat/torch_weights.py`
`_resnet_key`, `_kan_key`, `convert_resvitkan`): ``conv1``, ``bn1``,
``layer{L}.{i}.conv{k}``/``bn{k}``, ``layer{L}.{i}.downsample.{0,1}``,
``channel``, ``bn2``; ``kan.layers.{i}`` in `ResKan`; ``kan_head.3.layers.{i}``
or ``mlp_head.{0,3}`` in `ResVitKan`. NCHW in (``channels_last`` memory);
the KAN heads run K9 (`ops/kan.py`) twice a forward. `ResVitKan` keeps the
CViT's 32-row batch-indexed pos-embedding quirk (``pos_mode='legacy'``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fac_fake_torch.core.registry import register
from fac_fake_torch.models.blocks.kan import KAN
from fac_fake_torch.models.cvit import LEGACY_POS_ROWS, patchify
from fac_fake_torch.models.layers import Conv2d, Linear, TransformerEncoder, batch_norm
from fac_fake_torch.ops import preprocess

LAYER_PLANS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
               101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
RESNET_STRIDE = 32   # the stem's conv and pool, and layers 2-4


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(Conv2d(cin, cout, 1, stride, bias=False), batch_norm(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(planes)
        self.downsample = _downsample(cin, planes, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 relu_before_add: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.relu_before_add = relu_before_add
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = batch_norm(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = batch_norm(out)
        self.downsample = _downsample(cin, out, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.relu_before_add:
            y = torch.relu(y)
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + res)


class ResNet(nn.Module):
    """The stem (7×7/2 conv, BN, ReLU, 3×3/2 max-pool over a -inf pad),
    ``layer1``-``layer4``, and with ``squeeze_512`` the 1×1 ``channel`` +
    ``bn2`` tail. Returns the final NCHW feature map."""

    def __init__(self, depth: int = 34, relu_before_add: bool = False,
                 squeeze_512: bool = False):
        super().__init__()
        if depth not in LAYER_PLANS:
            raise ValueError(f"ResNet depth {depth}: expected one of {sorted(LAYER_PLANS)}")
        block = Bottleneck if depth >= 50 else BasicBlock
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = batch_norm(64)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        cin = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), LAYER_PLANS[depth])):
            layer = []
            for bi in range(blocks):
                stride = 2 if li > 0 and bi == 0 else 1
                kw = {"relu_before_add": relu_before_add} if block is Bottleneck else {}
                layer.append(block(cin, planes, stride,
                                   bi == 0 and (stride != 1 or cin != planes * block.expansion),
                                   **kw))
                cin = planes * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
        self.squeeze_512 = squeeze_512
        if squeeze_512:
            self.channel = Conv2d(cin, 512, 1, bias=False)
            self.bn2 = batch_norm(512)
            cin = 512
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.squeeze_512:
            x = self.bn2(self.channel(x))
        return x


class ResKan(ResNet):
    """ResNet + global average pool + KAN head (`kan_resnet.py:132-256`);
    the ResNet's modules sit at the top level, as in the reference."""

    def __init__(self, depth: int = 34, num_classes: int = 2):
        super().__init__(depth)
        self.kan = KAN((self.out_channels, 64, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.kan(super().forward(x).mean(dim=(2, 3))).float()


class ResVitKan(nn.Module):
    """ResNet features → patchify → CViT transformer → head. ``head='kan'``:
    Linear, Dropout(0.5), ReLU, KAN((mlp_dim, 64, classes)); ``'mlp'``:
    Linear, Dropout(0.5), ReLU, Linear. ResNet-50 and deeper take the
    vendored ReLU-before-add blocks and the 512 squeeze."""

    def __init__(self, image_size: int = 224, patch_size: int = 7, num_classes: int = 2,
                 dim: int = 1024, depth: int = 6, heads: int = 8, mlp_dim: int = 2048,
                 pos_mode: str = "legacy", resnet_depth: int = 50, head: str = "kan"):
        super().__init__()
        if head not in ("kan", "mlp"):
            raise ValueError(f"ResVitKan head {head!r}: expected kan or mlp")
        big = resnet_depth >= 50
        self.features = ResNet(resnet_depth, relu_before_add=big, squeeze_512=big)
        self.patch_size, self.dim, self.pos_mode = patch_size, dim, pos_mode
        ch = self.features.out_channels
        self.patch_to_embedding = Linear(ch * patch_size ** 2, dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        if pos_mode == "legacy":
            self.pos_embedding = nn.Parameter(torch.empty(LEGACY_POS_ROWS, 1, dim))
        elif pos_mode == "patch":
            side = image_size // RESNET_STRIDE // patch_size
            self.pos_embedding = nn.Parameter(torch.empty(1, side * side + 1, dim))
        else:
            raise ValueError(f"unknown pos_mode {pos_mode}")
        self.transformer = TransformerEncoder(dim, depth, heads, mlp_dim, "ln")
        last = (KAN((mlp_dim, 64, num_classes)) if head == "kan"
                else Linear(mlp_dim, num_classes))
        setattr(self, f"{head}_head", nn.Sequential(Linear(dim, mlp_dim), nn.Dropout(0.5),
                                                    nn.ReLU(), last))
        self.head = head

    def forward(self, img: torch.Tensor,
                pos_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.patch_to_embedding(patchify(self.features(img), self.patch_size))
        b = y.shape[0]
        tokens = torch.cat([self.cls_token.expand(b, 1, self.dim).to(y.dtype), y], dim=1)
        if self.pos_mode == "legacy":
            if pos_indices is None and b > LEGACY_POS_ROWS:
                raise ValueError(
                    f"legacy pos-embedding caps batch at {LEGACY_POS_ROWS} (got {b}) — the "
                    "reference's (32,1,dim) quirk (ResVitKan.py:294). Use "
                    "pos_embedding_mode='patch' for larger batches, or pass pos_indices.")
            pe = self.pos_embedding[:b] if pos_indices is None \
                else self.pos_embedding[pos_indices]
        else:
            pe = self.pos_embedding
        tokens = self.transformer(tokens + pe.to(tokens.dtype))
        return getattr(self, f"{self.head}_head")(tokens[:, 0]).float()

    def forward_crops(self, crops_u8: torch.Tensor, dtype: torch.dtype = torch.float32,
                      pos_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """uint8 NHWC (B, H, W, 3) crops → `forward` of their ImageNet
        normalize in ``dtype`` (K2's fp entry on the card)."""
        return self.forward(preprocess.normalize_imagenet(crops_u8, dtype), pos_indices)


def _transformer_args(cfg) -> dict:
    return dict(image_size=cfg.image_size, patch_size=cfg.patch_size,
                num_classes=cfg.num_classes, dim=cfg.dim, depth=cfg.depth, heads=cfg.heads,
                mlp_dim=cfg.mlp_dim, pos_mode=cfg.pos_embedding_mode)


@register("model", "reskan")
def _build_reskan(cfg) -> ResKan:
    """`ResKan/kan_resnet.py` resnet34 + KAN((512, 64, classes))"""
    return ResKan(depth=34, num_classes=cfg.num_classes)


@register("model", "resvitkan")
def _build_resvitkan(cfg) -> ResVitKan:
    """`ResVitKan/ResVitKan.py`: vendored ResNet-50 + ViT + KAN head"""
    return ResVitKan(**_transformer_args(cfg))


@register("model", "resvit")
def _build_resvit(cfg) -> ResVitKan:
    """`model/other/resvit.py`: ResNet-18 + ViT + Dropout-MLP head"""
    return ResVitKan(resnet_depth=18, head="mlp", **_transformer_args(cfg))
