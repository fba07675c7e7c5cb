"""BlazeFace face detector — the port of `fac_fake_tpu/detect/blazeface.py`.

NCHW modules in ``channels_last`` memory, named as the reference
`CViT-main/helpers/blazeface.py` names them (``backbone1.{i}``,
``backbone2.{i}.convs.{0,1}``, ``classifier_8``, …), so the reference
``blazeface.pth`` loads with ``strict=True``. The packaged weights are the
JAX package's ``blazeface_flax.npz`` and ``anchors.npy``, copied byte for
byte into ``assets/``.

Post-process as in the JAX package: a dense (B, 896, 17) anchor decode with
a score ≥ 0.75 validity mask, and the weighted-blend NMS
(`blazeface.py:301-356`) as 8 fixed steps. `weighted_nms_plain` is the
plain PyTorch version of that scan; on the card it runs inside kernel K1
(`detect/extractor.py frame_detections`).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fac_fake_torch.core.device import DeviceLike, resolve_device

NUM_ANCHORS = 896
NUM_COORDS = 16
SCALE = 128.0
SCORE_CLIP = 100.0
MIN_SCORE = 0.75
IOU_THRESH = 0.3

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


class BlazeBlock(nn.Module):
    """Depthwise-separable residual block with the TFLite stride-2 quirk
    (`blazeface.py:7-42`): stride 2 pads right/bottom by 2 before the
    depthwise conv and max-pools the residual; the channel deficit is
    zero-padded."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.channel_pad = out_ch - in_ch
        pad = 0 if stride == 2 else (kernel - 1) // 2
        self.convs = nn.Sequential(
            nn.Conv2d(in_ch, in_ch, kernel, stride, pad, groups=in_ch),
            nn.Conv2d(in_ch, out_ch, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            h = F.pad(x, (0, 2, 0, 2))
            x = F.max_pool2d(x, 2, 2)
        else:
            h = x
        if self.channel_pad > 0:
            x = F.pad(x, (0, 0, 0, 0, 0, self.channel_pad))
        return torch.relu(self.convs(h) + x)


_B1 = ((24, 24, 1), (24, 28, 1), (28, 32, 2), (32, 36, 1), (36, 42, 1),
       (42, 48, 2), (48, 56, 1), (56, 64, 1), (64, 72, 1), (72, 80, 1),
       (80, 88, 1))
_B2 = ((88, 96, 2), (96, 96, 1), (96, 96, 1), (96, 96, 1), (96, 96, 1))


class BlazeFaceNet(nn.Module):
    """Backbone + anchor heads (`blazeface.py:82-146`). NCHW in; returns raw
    (B, 896, 16) box regressions and (B, 896, 1) logits."""

    def __init__(self):
        super().__init__()
        self.backbone1 = nn.Sequential(
            nn.Conv2d(3, 24, 5, 2), nn.ReLU(),
            *(BlazeBlock(ci, co, stride=s) for ci, co, s in _B1))
        self.backbone2 = nn.Sequential(*(BlazeBlock(ci, co, stride=s) for ci, co, s in _B2))
        self.classifier_8 = nn.Conv2d(88, 2, 1)
        self.classifier_16 = nn.Conv2d(96, 6, 1)
        self.regressor_8 = nn.Conv2d(88, 32, 1)
        self.regressor_16 = nn.Conv2d(96, 96, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        # TFLite first-conv padding: (1, 2) on H and W (`blazeface.py:117`)
        x = self.backbone1(F.pad(x, (1, 2, 1, 2)))
        h = self.backbone2(x)

        def flat(t, k):  # NCHW head → (b, anchors, k) in (h, w, anchor) order
            return t.permute(0, 2, 3, 1).reshape(b, -1, k)

        c = torch.cat([flat(self.classifier_8(x), 1), flat(self.classifier_16(h), 1)], dim=1)
        r = torch.cat([flat(self.regressor_8(x), 16), flat(self.regressor_16(h), 16)], dim=1)
        return r, c


def decode_detections(raw_boxes: torch.Tensor, raw_scores: torch.Tensor,
                      anchors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor decode + score squash (`blazeface.py:254-273,275-299`).
    Returns dets (B, 896, 17) = [ymin,xmin,ymax,xmax, 6×(kp_x,kp_y), score]
    and the validity mask (B, 896) of score ≥ 0.75."""
    ax, ay, aw, ah = anchors[:, 0], anchors[:, 1], anchors[:, 2], anchors[:, 3]
    xc = raw_boxes[..., 0] / SCALE * aw + ax
    yc = raw_boxes[..., 1] / SCALE * ah + ay
    w = raw_boxes[..., 2] / SCALE * aw
    h = raw_boxes[..., 3] / SCALE * ah
    box = torch.stack([yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2], dim=-1)

    kp = raw_boxes[..., 4:16].reshape(*raw_boxes.shape[:-1], 6, 2)
    kpx = kp[..., 0] / SCALE * aw[:, None] + ax[:, None]
    kpy = kp[..., 1] / SCALE * ah[:, None] + ay[:, None]
    kps = torch.stack([kpx, kpy], dim=-1).reshape(*raw_boxes.shape[:-1], 12)

    scores = torch.sigmoid(torch.clamp(raw_scores[..., 0], -SCORE_CLIP, SCORE_CLIP))
    dets = torch.cat([box, kps, scores[..., None]], dim=-1)
    return dets, scores >= MIN_SCORE


def weighted_nms_plain(coords: torch.Tensor, score: torch.Tensor, valid: torch.Tensor,
                       max_out: int = 8, iou_thresh: float = IOU_THRESH
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted-blend NMS (`blazeface.py:301-356`), batched over frames.

    coords (F, N, 16) [ymin,xmin,ymax,xmax, keypoints], score (F, N),
    valid (F, N). Per step: seed = highest remaining score (ties to the
    lowest index); cluster = IoU > thresh among remaining (incl. the seed);
    if the cluster has > 1 member, coords become the score-weighted mean and
    the score the cluster mean, else the seed row is kept verbatim; the
    cluster is suppressed. Weighted sums accumulate in fp64 and round to
    fp32 once (the CUDA kernel does the same). Returns faces (F, max_out, 17)
    and mask (F, max_out)."""
    f = coords.shape[0]
    ar = torch.arange(f, device=coords.device)
    boxes = coords[..., :4]
    area_b = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    rows = torch.cat([coords, score[..., None]], dim=-1)
    coords64 = coords.double()
    scores = torch.where(valid, score, torch.full_like(score, -1.0))
    faces, mask = [], []
    for _ in range(max_out):
        idx = torch.argmax(scores, dim=1)
        seed_score = scores[ar, idx]
        sb = boxes[ar, idx]
        inter_min = torch.maximum(sb[:, None, :2], boxes[..., :2])
        inter_max = torch.minimum(sb[:, None, 2:4], boxes[..., 2:4])
        wh = torch.clamp(inter_max - inter_min, min=0.0)
        inter = wh[..., 0] * wh[..., 1]
        area_a = (sb[:, 2] - sb[:, 0]) * (sb[:, 3] - sb[:, 1])
        iou = inter / (area_a[:, None] + area_b - inter)
        cluster = (iou > iou_thresh) & (scores > 0.0)
        n = cluster.sum(dim=1)
        w = torch.where(cluster, score, torch.zeros_like(score)).double()
        total = w.sum(dim=1).float()
        blended = (coords64 * w[..., None]).sum(dim=1).float() / torch.clamp(total, min=1e-20)[:, None]
        bscore = total / torch.clamp(n, min=1).float()
        out = torch.where((n > 1)[:, None], torch.cat([blended, bscore[:, None]], dim=-1),
                          rows[ar, idx])
        scores = torch.where(cluster, torch.full_like(scores, -1.0), scores)
        faces.append(out)
        mask.append(seed_score > 0.0)
    if not faces:                                 # max_out = 0
        return rows[:, :0], valid[:, :0]
    return torch.stack(faces, dim=1), torch.stack(mask, dim=1)


def weighted_nms(dets: torch.Tensor, valid: torch.Tensor, max_out: int = 8,
                 iou_thresh: float = IOU_THRESH) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image's (A, 17) dets and (A,) validity → (max_out, 17) faces and
    (max_out,) mask, as the JAX `weighted_nms`. Runs through K1's wrapper
    (no affine, no margin): the kernel on a CUDA tensor, the plain version
    on a CPU one."""
    from fac_fake_torch.detect.extractor import frame_detections
    faces, mask = frame_detections(dets[None], valid[None], max_out=max_out,
                                   iou_thresh=iou_thresh, margin=None)
    return faces[0], mask[0]


class BlazeFace:
    """User-facing detector: batched forward + decode (+ optional per-image
    NMS). Mirrors `predict_on_batch` (`blazeface.py:182-219`). The
    JAX package's batch buckets only bounded XLA compiles; the port runs
    each batch at its own size."""

    input_size = (128, 128)

    def __init__(self, net: BlazeFaceNet, anchors: np.ndarray, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.net = net.to(self.device).to(memory_format=torch.channels_last).eval()
        self.net.requires_grad_(False)
        self.anchors = torch.as_tensor(np.asarray(anchors, np.float32), device=self.device)

    @classmethod
    def from_packaged_assets(cls, device: DeviceLike = None) -> "BlazeFace":
        from fac_fake_torch.compat.weights import blazeface_state_dict_from_flax
        net = BlazeFaceNet()
        with np.load(os.path.join(ASSETS, "blazeface_flax.npz")) as raw:
            net.load_state_dict(blazeface_state_dict_from_flax(dict(raw)), strict=True)
        return cls(net, np.load(os.path.join(ASSETS, "anchors.npy")), device)

    @torch.inference_mode()
    def predict_on_batch(self, x, apply_nms: bool = True):
        """x: (B, 128, 128, 3) uint8/float NHWC, numpy or tensor. Returns
        (dets, mask) on the detector's device: with NMS (B, 8, 17)/(B, 8);
        raw (B, 896, 17)/(B, 896)."""
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        x = x.to(self.device, non_blocking=True).to(torch.float32) / 127.5 - 1.0
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        r, c = self.net(x)
        dets, valid = decode_detections(r, c, self.anchors)
        if not apply_nms:
            return dets, valid
        from fac_fake_torch.detect.extractor import MAX_FACES, frame_detections
        return frame_detections(dets.contiguous(), valid.contiguous(),
                                max_out=MAX_FACES, margin=None)
