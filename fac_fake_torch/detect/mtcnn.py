"""MTCNN face-detection cascade (P/R/O-net): the port of
`fac_fake_tpu/detect/mtcnn.py`.

The reference uses facenet_pytorch's MTCNN as a box detector
(`preprocessing/face_detector.py:34-46`), for masking landmarks
(`S3D/face_mask/get_masked_face_simple.py:35-36`) and on the predictors'
``face_mtcnn`` path (`cvit_prediction.py:86-102`), which the scorer runs
under ``infer.detector="mtcnn"``.

As in the JAX package, every stage is a fixed-capacity padded candidate
set: per pyramid scale the top ``caps[0]`` P-net cells (a stable
descending sort, so ties keep the lower index as `lax.top_k`), then greedy
NMS at 0.5; over all scales NMS at 0.7 to ``caps[1]``; R-net on 24² patches
and NMS at 0.7; O-net on 48² patches and NMS at 0.7 with the ``min``
denominator to ``caps[2]``. The NMS is kernel K8 (`ops/nms.py`): one launch
for a frame's per-scale calls and one for each later stage, four a frame.
The pyramid and the patches are bilinear resamples on the device
(`ops/resize.py`), with out-of-frame patch regions edge-clamped, as JAX's.

The nets keep facenet_pytorch's module names (`PNet`, `RNet`, `ONet`;
``conv1``, ``prelu1``, …, ``dense6_3``), so a facenet_pytorch MTCNN
state_dict (``pnet.conv1.weight``, …) loads into `MTCNN` with
``strict=True``; `load_mtcnn_npz` / `save_mtcnn_npz` read and write the JAX
package's flat ``.npz`` (``pnet/params/conv1/kernel``, HWIO), so one file
serves both packages. No pretrained weights ship: without a state_dict the
nets are seeded.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fac_fake_torch.core.device import DeviceLike, resolve_device
from fac_fake_torch.ops import nms
from fac_fake_torch.ops.resize import crop_resize_bilinear, resize_bilinear

CELL = 12       # P-net receptive cell
STRIDE = 2      # P-net output stride


def _flatten(x: torch.Tensor) -> torch.Tensor:
    """facenet_pytorch's flatten before the first dense: NCHW permuted to
    (N, W, H, C), then flattened."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    """Proposal net, fully convolutional: NCHW in, (reg (B, 4, h, w), probs
    (B, 2, h, w) post-softmax) out."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 10, 3)
        self.prelu1 = nn.PReLU(10)
        self.pool1 = nn.MaxPool2d(2, 2, ceil_mode=True)
        self.conv2 = nn.Conv2d(10, 16, 3)
        self.prelu2 = nn.PReLU(16)
        self.conv3 = nn.Conv2d(16, 32, 3)
        self.prelu3 = nn.PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.prelu3(self.conv3(self.prelu2(self.conv2(x))))
        return self.conv4_2(x), torch.softmax(self.conv4_1(x), dim=1)


class RNet(nn.Module):
    """Refine net over 24² patches: (reg (B, 4), probs (B, 2))."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 28, 3)
        self.prelu1 = nn.PReLU(28)
        self.pool1 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv2 = nn.Conv2d(28, 48, 3)
        self.prelu2 = nn.PReLU(48)
        self.pool2 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv3 = nn.Conv2d(48, 64, 2)
        self.prelu3 = nn.PReLU(64)
        self.dense4 = nn.Linear(576, 128)
        self.prelu4 = nn.PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x):
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.prelu4(self.dense4(_flatten(self.prelu3(self.conv3(x)))))
        return self.dense5_2(x), torch.softmax(self.dense5_1(x), dim=1)


class ONet(nn.Module):
    """Output net over 48² patches: (reg (B, 4), landmarks (B, 10), probs
    (B, 2))."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.prelu1 = nn.PReLU(32)
        self.pool1 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.prelu2 = nn.PReLU(64)
        self.pool2 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.prelu3 = nn.PReLU(64)
        self.pool3 = nn.MaxPool2d(2, 2, ceil_mode=True)
        self.conv4 = nn.Conv2d(64, 128, 2)
        self.prelu4 = nn.PReLU(128)
        self.dense5 = nn.Linear(1152, 256)
        self.prelu5 = nn.PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x):
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.pool3(self.prelu3(self.conv3(x)))
        x = self.prelu5(self.dense5(_flatten(self.prelu4(self.conv4(x)))))
        return self.dense6_2(x), self.dense6_3(x), torch.softmax(self.dense6_1(x), dim=1)


# --- cascade geometry ----------------------------------------------------------

def pyramid_scales(h: int, w: int, min_face_size: int = 20,
                   factor: float = 0.709) -> list:
    """The torch cascade's scale schedule: m = 12/minsize, then ×factor
    while the scaled short side still fits a 12-px cell."""
    m = CELL / float(min_face_size)
    minl = min(h, w) * m
    scales = []
    while minl >= CELL:
        scales.append(m * factor ** len(scales))
        minl = minl * factor
    return scales


def _fix(x: torch.Tensor) -> torch.Tensor:
    return torch.trunc(x)   # round toward zero, like numpy.fix


def _f32(v, dev) -> torch.Tensor:
    """A 0-d fp32 tensor: JAX rounds a Python float operand to fp32, and CUDA
    would divide by a host scalar as a multiply by its reciprocal."""
    return torch.tensor(v, dtype=torch.float32, device=dev)


def decode_pnet_boxes(probs: torch.Tensor, reg: torch.Tensor, scale: float,
                      thresh, k: int):
    """(h, w) face-prob map + (h, w, 4) reg → the padded top-k candidate set
    (boxes (k, 4) x1y1x2y2, scores (k,), reg (k, 4), valid (k,)); cell →
    pixel q1 = fix((stride·cell + 1)/scale), q2 = fix((stride·cell +
    cellsize)/scale). Cells below ``thresh`` score -1.0 and tie: the stable
    sort keeps them in index order, as `lax.top_k`."""
    dev = probs.device
    hc, wc = probs.shape
    flat = probs.reshape(-1)
    kk = min(k, flat.shape[0])   # small pyramid levels have < k cells
    thresh = _f32(thresh, dev) if not torch.is_tensor(thresh) else thresh
    masked = torch.where(flat >= thresh, flat, -1.0)
    scores, idx = torch.sort(masked, descending=True, stable=True)
    scores, idx = scores[:kk], idx[:kk]
    if kk < k:
        scores = torch.cat([scores, scores.new_full((k - kk,), -1.0)])
        idx = torch.cat([idx, idx.new_zeros((k - kk,))])
    valid = scores >= thresh
    yy = torch.div(idx, wc, rounding_mode="floor").to(torch.float32)
    xx = (idx % wc).to(torch.float32)
    s = _f32(scale, dev)
    q1x = _fix((STRIDE * xx + 1) / s)
    q1y = _fix((STRIDE * yy + 1) / s)
    q2x = _fix((STRIDE * xx + CELL) / s)
    q2y = _fix((STRIDE * yy + CELL) / s)
    boxes = torch.stack([q1x, q1y, q2x, q2y], dim=-1)
    return boxes, scores, reg.reshape(-1, 4)[idx], valid


def bbreg(boxes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """Apply bounding-box regression offsets (scaled by box w/h)."""
    w = (boxes[:, 2] - boxes[:, 0]) + 1
    h = (boxes[:, 3] - boxes[:, 1]) + 1
    return torch.stack([boxes[:, 0] + reg[:, 0] * w, boxes[:, 1] + reg[:, 1] * h,
                        boxes[:, 2] + reg[:, 2] * w, boxes[:, 3] + reg[:, 3] * h], dim=-1)


def rerec(boxes: torch.Tensor) -> torch.Tensor:
    """Square each box around its centre (longest side)."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = torch.maximum(w, h)
    x1 = (boxes[:, 0] + w * 0.5) - side * 0.5
    y1 = (boxes[:, 1] + h * 0.5) - side * 0.5
    return torch.stack([x1, y1, x1 + side, y1 + side], dim=-1)


def _extract_patches(img_f: torch.Tensor, boxes: torch.Tensor, size: int) -> torch.Tensor:
    """Crop + resize of K candidate boxes to (K, size, size, 3), normalized
    (x − 127.5)/128 like the torch cascade."""
    yxyx = torch.stack([boxes[:, 1], boxes[:, 0], boxes[:, 3] + 1, boxes[:, 2] + 1], dim=-1)
    return (crop_resize_bilinear(img_f, yxyx, (size, size)) - 127.5) * 0.0078125


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


# --- the cascade -------------------------------------------------------------------

class MTCNN(nn.Module):
    """P/R/O-net cascade on ``device`` (the card unless the caller names the
    CPU): `detect(img)` → padded (boxes x1y1x2y2, probs, landmarks (K, 5, 2)
    xy, valid) numpy arrays. ``state_dict``: facenet_pytorch's layout (as
    `load_mtcnn_npz` returns it); None seeds the nets from ``seed``."""

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 thresholds: Sequence[float] = (0.6, 0.7, 0.7),
                 min_face_size: int = 20, factor: float = 0.709,
                 caps: Tuple[int, int, int] = (128, 64, 32), seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.pnet, self.rnet, self.onet = PNet(), RNet(), ONet()
        if state_dict is None:
            init_mtcnn(self, seed)
        else:
            self.load_state_dict(state_dict, strict=True)
        self.device = resolve_device(device)
        self.to(self.device).eval()
        self.thresholds = tuple(thresholds)
        self.min_face_size = min_face_size
        self.factor = factor
        self.caps = tuple(caps)

    @torch.inference_mode()
    def run(self, img_u8: torch.Tensor):
        """The cascade on one (H, W, 3) uint8 RGB frame on the device →
        (boxes (K, 4), probs (K,), landmarks (K, 5, 2), valid (K,)) tensors
        there, K = caps[2]. Four K8 launches."""
        dev = img_u8.device
        h, w = img_u8.shape[:2]
        t0, t1, t2 = (_f32(t, dev) for t in self.thresholds)
        k1, k2, k3 = self.caps
        img = img_u8.to(torch.float32)

        # stage 1: pyramid proposals, per-scale top-k, then NMS 0.5 over the
        # scales' candidate sets as one batched call
        levels = []
        for s in pyramid_scales(h, w, self.min_face_size, self.factor):
            im = resize_bilinear(img[None], (int(h * s + 1), int(w * s + 1)))
            reg, probs = self.pnet(_nchw((im - 127.5) * 0.0078125))
            levels.append(decode_pnet_boxes(probs[0, 1], reg[0].permute(1, 2, 0), s, t0, k1))
        boxes, scores, regs, valid = (torch.stack(x) for x in zip(*levels))
        idx, keep = nms.hard_nms(boxes, scores, valid, 0.5, "union", k1)
        sc = torch.gather(scores, 1, idx)
        boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)).reshape(-1, 4)
        regs = torch.gather(regs, 1, idx[..., None].expand(-1, -1, 4)).reshape(-1, 4)
        valid = (keep & (sc >= t0)).reshape(-1)
        scores = torch.where(keep, sc, -1.0).reshape(-1)

        idx, keep = nms.hard_nms(boxes, scores, valid, 0.7, "union", k2)
        boxes, regs = boxes[idx], regs[idx]
        valid = keep & valid[idx]
        boxes = _fix(rerec(bbreg(boxes, regs)))

        # stage 2: R-net refinement on 24² patches
        reg, probs = self.rnet(_nchw(_extract_patches(img, boxes, 24)))
        scores = probs[:, 1].contiguous()
        valid = valid & (scores > t1)
        idx, keep = nms.hard_nms(boxes, scores, valid, 0.7, "union", k2)
        boxes, reg = boxes[idx], reg[idx]
        valid = keep & valid[idx]
        boxes = _fix(rerec(bbreg(boxes, reg)))

        # stage 3: O-net: final boxes, scores, 5-point landmarks
        reg, lmk, probs = self.onet(_nchw(_extract_patches(img, boxes, 48)))
        scores = probs[:, 1].contiguous()
        valid = valid & (scores > t2)
        bw = (boxes[:, 2] - boxes[:, 0]) + 1
        bh = (boxes[:, 3] - boxes[:, 1]) + 1
        pts_x = (bw[:, None] * lmk[:, 0:5] + boxes[:, 0:1]) - 1
        pts_y = (bh[:, None] * lmk[:, 5:10] + boxes[:, 1:2]) - 1
        boxes = bbreg(boxes, reg)
        idx, keep = nms.hard_nms(boxes, scores, valid, 0.7, "min", k3)
        points = torch.stack([pts_x[idx], pts_y[idx]], dim=-1)
        return boxes[idx], scores[idx], points, keep & valid[idx]

    def detect(self, img_u8: np.ndarray):
        """img (H, W, 3) uint8 RGB → (boxes (K, 4) x1y1x2y2, probs (K,),
        landmarks (K, 5, 2) xy, valid (K,) bool), padded numpy arrays."""
        x = torch.from_numpy(np.ascontiguousarray(img_u8)).to(self.device)
        return tuple(o.cpu().numpy() for o in self.run(x))

    def detect_batch(self, frames: np.ndarray) -> List[tuple]:
        """(F, H, W, 3) → one `detect` tuple a frame."""
        return [self.detect(f) for f in frames]

    def landmarks(self, img_u8: np.ndarray) -> Optional[np.ndarray]:
        """5-point landmarks of the best face, (5, 2) xy, or None
        (`get_masked_face_simple.py:35-44`)."""
        _, probs, points, valid = self.detect(img_u8)
        if not valid.any():
            return None
        return points[np.argmax(np.where(valid, probs, -1))]


def init_mtcnn(mt: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded weights from one `torch.Generator`: convs and denses
    N(0, 1/fan_in), biases 0, PReLU slopes 0.25 (flax's initial slope)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in mt.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = torch.empty(m.weight.shape).normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()),
                                                        generator=gen)
                m.weight.copy_(w)
                m.bias.zero_()
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)
    return mt


# --- weights: the JAX package's flat npz ----------------------------------------------

_NPZ_SEP = "/"


def _flax_shapes() -> Dict[str, tuple]:
    from fac_fake_torch.compat.weights import mtcnn_flax_from_state_dict
    nets = nn.ModuleDict({"pnet": PNet(), "rnet": RNet(), "onet": ONet()})
    return {k: v.shape for k, v in _flat(mtcnn_flax_from_state_dict(nets.state_dict())).items()}


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}{_NPZ_SEP}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def validate_mtcnn_variables(variables: Mapping) -> Mapping:
    """Shape-check a cascade tree in the JAX package's layout (``pnet`` →
    ``params`` → ``conv1`` → ``kernel``, …) against the port's nets; raises
    ValueError naming the first missing, mis-shaped or extra leaf. Returns
    ``variables``."""
    ref = _flax_shapes()
    got = _flat(variables)
    for key, shape in ref.items():
        if key not in got:
            raise ValueError(f"converted MTCNN tree is missing {key}")
        if tuple(got[key].shape) != tuple(shape):
            raise ValueError(f"MTCNN leaf {key} has shape {tuple(got[key].shape)}, "
                             f"expected {tuple(shape)}")
    extra = set(got) - set(ref)
    if extra:
        raise ValueError(f"converted MTCNN tree has extra leaves {sorted(extra)}")
    return variables


def save_mtcnn_npz(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """The port's (facenet_pytorch-layout) state_dict → the JAX package's
    flat-key ``.npz`` (``pnet/params/conv1/kernel`` → HWIO array), no pickle."""
    from fac_fake_torch.compat.weights import mtcnn_flax_from_state_dict
    variables = validate_mtcnn_variables(mtcnn_flax_from_state_dict(state_dict))
    np.savez(path, **_flat(variables))


def load_mtcnn_npz(path: str) -> Dict[str, torch.Tensor]:
    """A flat-key cascade ``.npz`` (either package's) → the port's state_dict,
    shape-validated."""
    from fac_fake_torch.compat.weights import mtcnn_state_dict_from_flax
    tree: Dict = {}
    with np.load(path) as data:
        for name in data.files:
            node = tree
            *parents, leaf = name.split(_NPZ_SEP)
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[name]
    return mtcnn_state_dict_from_flax(validate_mtcnn_variables(tree))
