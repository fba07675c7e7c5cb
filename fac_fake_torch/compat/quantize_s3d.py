"""Post-training int8 quantization of an S3D model (inference only) — the
port of `fac_fake_tpu/compat/quantize_s3d.py`.

A spec-walking engine, as in the JAX package: `S3DInt8` re-executes
`S3DNet`'s op walk with every BatchNorm folded into its (bias-free) conv,
``w' = w·γ/√(σ²+ε)``, ``b' = β − μ·γ/√(σ²+ε)``. One folded fp32 walk over a
calibration batch records, per conv:

  * ``s_x = max(max|x|, 1e-8) / 127``, the input's per-tensor scale;
  * ``w_q``, ``s_w``: symmetric per-output-channel int8 weights,
    ``s_w = max(max|w'| / 127, 1e-12)``;
  * ``s = s_x·s_w`` (formed once, here) and the folded bias ``b'``,

keyed as the JAX engine keys them (``l0/s``, ``l0/t``, ``l2``,
``l4/b1b/s`` …). The int8 walk then runs each conv through K5
(`ops/quant3d.py`): quantize, exact int32 conv, ``acc·s + b``, the conv's
activation (ReLU; ReLU6, ``clip(·, 0, 6)``, in the msca family; none on a
V2 mix's spatial convs) in K5's epilogue. Where
a conv's output is read by the next conv alone (a sep's spatial conv by its
temporal one, a ``basic`` conv by the sep after it, a mix's ``b1a``/``b2a``
by their seps: 39 edges in ca_s3d), the first conv's epilogue quantizes
it with the next conv's ``s_x`` (K5's ``q_scale``), so no fp tensor and no
quantize pass lies between them; the values are those of the separate
quantize. An Inception mix quantizes its input once with the shared
scale, and its fourth branch max-pools the int8 tensor (K6): max-pool
commutes with the monotone quantizer, so that is exact. Each branch writes
its slice of the mix's output. What stays fp, as in JAX: the SRM bank
(``concat30``, and the msca family's residual ``x + srm_filter(x)``), the
GCNet context blocks, the msca MSCAN-half and iFormer blocks (each run
through a deep copy of the model's own module, JAX's ``module_step``), the
spec's own max-pools and the head. The 3-channel stem input is quantized
to 4 channels (K5's stem layout); given as uint8 clips (what
`S3DEvaluator` passes) and with no SRM bank, by K2's raw entry
(`ops/preprocess.py quantize_clips`) straight from the bytes, the same
int8 values as the fp32 cast and the quantize pass, so a ca_s3d forward
runs 10 quantize passes, not 11 (`walk_counts` gives each spec's).

The walk is NDHWC inside (the kernels' layout); `S3DInt8.forward` takes
what `S3DNet.forward` takes, (B, 3, T, H, W) in ``channels_last_3d``
memory, fp or uint8, and returns (B, num_class) fp32 logits. The int8
walk's activations are in the model's dtype (JAX :110, :138): for a bf16
model K5 writes bf16 (its bf16 out mode), and the fp blocks, pools and head
run in bf16; calibration is fp32, as JAX's.

    engine = quantize_s3d(model, calib_clips)   # one folded fp32 walk
    logits = engine(clips)                      # the int8 walk
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fac_fake_torch.compat.quantize import _act_scale, _weight_q
from fac_fake_torch.models.s3d.blocks import INCEPTION_PLANS
from fac_fake_torch.models.s3d.layers import act_fn, avg_pool3d, max_pool3d, srm_filter
from fac_fake_torch.ops import preprocess as pp
from fac_fake_torch.ops import quant3d as q3
from fac_fake_torch.ops.quant3d import pad16

Geom = Tuple[Tuple[int, int, int], Tuple[int, int, int]]   # stride, padding
_G111: Geom = ((1, 1, 1), (0, 0, 0))
_FIRST = {"sep": "l0/s", "basic": "l0"}       # the first conv's key, by the spec's first op
_FP_MODULES = ("ctx", "mscan_half", "iformer")  # run in fp through the model's own modules


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    """No copy for a ``channels_last_3d`` tensor."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


def _fold(conv: nn.Conv3d, bn: Optional[nn.BatchNorm3d]) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN folded into the bias-free conv → (w fp32 (O, I, kt, kh, kw), b (O,))."""
    w = conv.weight.float()
    if bn is None:
        return w, torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)
    g = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    b = bn.bias.float() - bn.running_mean.float() * g
    return w * g.reshape(-1, 1, 1, 1, 1), b


def folded_convs(model) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Every conv of the walk, folded, keyed as the JAX engine keys them."""
    out = {}

    def sep(key, m):
        out[key + "/s"] = _fold(m.conv_s, m.bn_s)
        out[key + "/t"] = _fold(m.conv_t, m.bn_t)

    for i, op in enumerate(model.spec):
        m, key = model.base[i], f"l{i}"
        if op[0] == "sep":
            sep(key, m)
        elif op[0] == "basic":
            out[key] = _fold(m.conv, m.bn)
        elif op[0] == "mix":
            for name, basic in (("b0", m.branch0[0]), ("b1a", m.branch1[0]),
                                ("b2a", m.branch2[0]), ("b3", m.branch3[1])):
                out[f"{key}/{name}"] = _fold(basic.conv, basic.bn)
            sep(key + "/b1b", m.branch1[1])
            sep(key + "/b2b", m.branch2[1])
    return out


class QConv3d(nn.Module):
    """One quantized conv of the walk: ``w_q`` int8 (N, kt, kh, kw, Cp) with
    the input channels padded to Cp (K5's layout), ``s = s_x·s_w`` and the
    folded bias ``b`` (N,), the input scale ``s_x`` (0-d). A conv whose
    input has at most 4 channels (the stem's RGB, quantized to 4) also
    keeps ``w_rows``, ``w_q`` in K5's 32-byte row layout (`q3.stem_rows`);
    it is made from ``w_q`` here, so whoever replaces ``w_q`` makes it
    again."""

    def __init__(self, w_q, s, b, s_x, geom: Geom, act: int, cin: int):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("s", s)
        self.register_buffer("b", b)
        self.register_buffer("s_x", s_x)
        self.register_buffer("w_rows", q3.stem_rows(w_q) if q3.quant_channels(cin) == 4
                             else None, persistent=False)
        self.stride, self.padding = geom
        self.act = act          # K5's epilogue activation, `q3.act_mode`

    @classmethod
    def calibrate(cls, w, b, x, s_x, geom: Geom, act: Optional[str]) -> "QConv3d":
        """From the folded fp32 conv ``w`` (O, I, kt, kh, kw), ``b`` and its
        calibration input ``x`` (unless ``s_x`` is given, a mix's shared one);
        ``act``: the spec's activation after the conv (None, relu, relu6)."""
        if s_x is None:
            s_x = _act_scale(x.abs().amax())
        w_q, s_w = _weight_q(w, (1, 2, 3, 4))
        w_q = F.pad(w_q.permute(0, 2, 3, 4, 1), (0, pad16(w.shape[1]) - w.shape[1]))
        return cls(w_q.contiguous(), s_x * s_w, b.float(), s_x, geom, q3.act_mode(act),
                   w.shape[1])

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        return q3.quantize_pad(x, self.s_x)

    def forward(self, xq, dtype, out=None, c0: int = 0, q_scale=None):
        return q3.int8_conv3d(xq, self.w_q, self.s, self.b, self.stride, self.padding,
                              self.act, dtype, out, c0, q_scale, self.w_rows)


def _fused_into(spec, i: int) -> Optional[str]:
    """The key of the conv that alone reads conv op ``i``'s output (the next
    op's first conv, when that op is a sep or a basic), else None."""
    if spec[i][0] not in _FIRST or i + 1 >= len(spec):
        return None
    nxt = spec[i + 1][0]
    return {"sep": f"l{i + 1}/s", "basic": f"l{i + 1}"}.get(nxt)


def walk_counts(spec, srm: str = "none", uint8: bool = True) -> Dict[str, int]:
    """What one int8 forward of ``spec`` runs (`S3DInt8._walk`): K5 convs
    (``conv``), those that quantize their output for the next conv
    (``fused``), those with ReLU6 in the epilogue (``relu6``), quantize
    passes (``quantize``), K2 raw entries (``raw``: the first conv's input
    from uint8 clips, with no SRM bank), K6 pools (``pool``) and blocks run
    in fp through the model's own modules (``fp_modules``)."""
    c = dict(conv=0, fused=0, relu6=0, quantize=0, raw=0, pool=0, fp_modules=0)

    def conv(act, fused):
        c["conv"] += 1
        c["fused"] += fused
        c["relu6"] += act == "relu6"

    quantized = uint8 and srm == "none" and spec[0][0] in _FIRST
    c["raw"] = int(quantized)
    for i, op in enumerate(spec):
        kind, to = op[0], _fused_into(spec, i)
        if kind in _FIRST:
            c["quantize"] += not quantized
            if kind == "sep":
                conv(op[5] if op[6] else None, True)
            conv(op[5], to is not None)
        elif kind == "mix":
            act, sbn = op[2], op[3]
            c["quantize"] += 1
            c["pool"] += 1
            for fused in (False, True, True, False):      # b0, b1a, b2a, b3
                conv(act, fused)
            for _ in range(2):                             # the b1b, b2b seps
                conv(act if sbn else None, True)
                conv(act, False)
        elif kind in _FP_MODULES:
            c["fp_modules"] += 1
        quantized = to is not None
    return c


class S3DInt8(nn.Module):
    """The int8 inference engine for one `S3DNet` (every registry entry:
    ``s3d``, ``ca_s3d``, the msca family). Built by `quantize_s3d`;
    `folded_fp_forward` is the exact-algebra fp32 walk the tests pin against
    the model."""

    def __init__(self, model, calib_clips: torch.Tensor):
        super().__init__()
        self.spec = model.spec
        self.srm = model.srm
        self.num_class = model.num_class
        # the int8 walk's activations in the model's dtype (JAX :110, :138);
        # calibration and the folded walk run in fp32
        self.dtype = getattr(model, "dtype", torch.float32)
        if self.srm != "none":
            self.register_buffer("srm_weight", model.srm_weight.clone(), persistent=False)
        self.fp = nn.ModuleDict({f"l{i}": copy.deepcopy(model.base[i])
                                 for i, op in enumerate(self.spec) if op[0] in _FP_MODULES})
        self.fc = copy.deepcopy(model.fc)
        self.qconvs = nn.ModuleDict()
        with torch.no_grad():
            self._walk(calib_clips, folded_convs(model), build=True)

    @property
    def qparams(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {k: {"w_q": m.w_q, "s": m.s, "b": m.b, "s_x": m.s_x}
                for k, m in self.qconvs.items()}

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        return self._walk(clips)

    def walk_counts(self, uint8: bool = True) -> Dict[str, int]:
        """What one forward runs (`walk_counts`), from uint8 clips or not."""
        return walk_counts(self.spec, self.srm, uint8)

    @torch.no_grad()
    def folded_fp_forward(self, model, clips: torch.Tensor) -> torch.Tensor:
        """The folded-BN fp32 walk of ``model``, no quantization."""
        return self._walk(clips, folded_convs(model))

    def _walk(self, clips, folded=None, build: bool = False):
        """``folded`` given: the fp32 walk with those convs (``build``: record
        each conv's qparams); else the int8 walk."""
        int8 = folded is None
        dt = self.dtype if int8 else torch.float32

        def conv(x, key, geom: Geom, act, xq=None, s_x=None, out=None, c0=0, to=None):
            """``to``: the conv that alone reads this one's output; the int8
            walk then returns that output quantized for it."""
            if int8:
                qc = self.qconvs[key]
                q_scale = None if to is None else self.qconvs[to].s_x
                return qc(qc.quantize(x) if xq is None else xq, dt, out, c0, q_scale)
            w, b = folded[key]
            if build:
                self.qconvs[key] = QConv3d.calibrate(w, b, x, s_x, geom, act)
            return _ndhwc(act_fn(act)(F.conv3d(_ncdhw(x), w, b, *geom)))

        def sep(x, key, strd, pad, act, sbn, out=None, c0=0, xq=None, to=None):
            y = conv(x, key + "/s", ((1, strd, strd), (0, pad, pad)), act if sbn else None,
                     xq=xq, to=key + "/t")
            return conv(None if int8 else y, key + "/t", ((strd, 1, 1), (pad, 0, 0)), act,
                        xq=y if int8 else None, out=out, c0=c0, to=to)

        def mix(x, key, plan, act, sbn):
            b0, _, o1, _, o2, b3 = plan
            if int8:
                out = torch.empty((*x.shape[:-1], b0 + o1 + o2 + b3), dtype=dt, device=x.device)
                xq = self.qconvs[key + "/b0"].quantize(x)
                conv(None, key + "/b0", _G111, act, xq=xq, out=out, c0=0)
                y1 = conv(None, key + "/b1a", _G111, act, xq=xq, to=key + "/b1b/s")
                y2 = conv(None, key + "/b2a", _G111, act, xq=xq, to=key + "/b2b/s")
                conv(None, key + "/b3", _G111, act, xq=q3.max_pool3d_i8(xq), out=out,
                     c0=b0 + o1 + o2)
                sep(None, key + "/b1b", 1, 1, act, sbn, out=out, c0=b0, xq=y1)
                sep(None, key + "/b2b", 1, 1, act, sbn, out=out, c0=b0 + o1, xq=y2)
                return out
            s_x = _act_scale(x.abs().amax()) if build else None
            y0 = conv(x, key + "/b0", _G111, act, s_x=s_x)
            y1 = conv(x, key + "/b1a", _G111, act, s_x=s_x)
            y2 = conv(x, key + "/b2a", _G111, act, s_x=s_x)
            pooled = _ndhwc(max_pool3d(_ncdhw(x), (3, 3, 3), (1, 1, 1), (1, 1, 1)))
            y3 = conv(pooled, key + "/b3", _G111, act, s_x=s_x)
            y1 = sep(y1, key + "/b1b", 1, 1, act, sbn)
            y2 = sep(y2, key + "/b2b", 1, 1, act, sbn)
            return torch.cat([y0, y1, y2, y3], dim=-1)

        xq = None   # int8 walk: the input of conv op i, quantized by conv op i - 1
        first = _FIRST.get(self.spec[0][0])
        if int8 and clips.dtype == torch.uint8 and self.srm == "none" and first:
            # the first conv's input straight from the uint8 clips (K2's raw entry)
            xq, x = pp.quantize_clips(_ndhwc(clips), self.qconvs[first].s_x), None
        else:
            x = clips.to(dt)
            if self.srm == "concat30":
                x = srm_filter(x.float(), self.srm_weight).to(dt)
            elif self.srm == "residual3":
                x = (x.float() + srm_filter(x.float(), self.srm_weight)).to(dt)
            x = _ndhwc(x)
        for i, op in enumerate(self.spec):
            kind, key = op[0], f"l{i}"
            to = _fused_into(self.spec, i) if int8 else None
            if kind == "sep":
                _, _, _, strd, pad, act, sbn = op
                x = sep(x, key, strd, pad, act, sbn, xq=xq, to=to)
            elif kind == "basic":
                _, _, _, strd, pad, act = op
                x = conv(x, key, ((strd,) * 3, (pad,) * 3), act, xq=xq, to=to)
            elif kind == "pool":
                x = _ndhwc(max_pool3d(_ncdhw(x), op[1], op[2], op[3]))
            elif kind == "mix":
                x = mix(x, key, INCEPTION_PLANS[op[1]], op[2], op[3])
            elif kind in _FP_MODULES:
                x = _ndhwc(self.fp[key](_ncdhw(x)))
            else:
                raise ValueError(f"spec op {kind!r}")
            xq, x = (x, None) if to is not None else (None, x)
        # head (fp, `models/s3d/model.py`): avg over (2, H, W), 1×1×1 conv, temporal mean
        x = _ncdhw(x)
        x = self.fc(avg_pool3d(x, (2, x.shape[3], x.shape[4])))
        return x.flatten(2).mean(2).float()


@torch.no_grad()
def quantize_s3d(model, calib_clips: torch.Tensor) -> S3DInt8:
    """The int8 engine of an `S3DNet` (on the model's device, eval mode).
    ``calib_clips``: a representative (B, 3, T, H, W) batch in model input
    space (raw 0–255 floats for the reference S3D pipeline,
    `S3D-train.py:318`), on the model's device. The model is not changed."""
    return S3DInt8(model, calib_clips.float()).eval()
