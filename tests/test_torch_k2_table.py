"""K2's int8 entries (`ops/preprocess.py` `quantize_crops`, `quantize_clips`)
and the routes through them, on the CPU: every (channel, byte) entry of the
kernel's table against the two-step chains it replaces and against the JAX
package's normalize and quantize; a model of the kernel (a 3 × 256 table,
one read a value) against the chain on ragged images; the CViT's
`forward_crops` and the S3D int8 engine on uint8 clips against the old
routes, bit for bit, with the passes they run counted. Inputs are made from
numpy seeds; JAX runs on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# scales: about the calibrated 2.64 / 127, so the largest values clip to ±127;
# 2⁻⁶, on which bf16 values fall on exact .5 quotients; one found by search
# on which 10 fp32 normalized values do (and 278 clip)
CROP_SCALES = [0.019, 2.0 ** -6, 0.011131090112030506]
# raw bytes: 2 (every odd byte an exact .5 quotient, 255 clips), the
# calibrated 255 / 127, and 1 (half the bytes clip)
CLIP_SCALES = [2.0, 255.0 / 127.0, 1.0]
DTYPES = [torch.float32, torch.bfloat16]


def _all_bytes() -> torch.Tensor:
    """(1, 16, 16, 3) uint8: every byte value once in each channel."""
    b = np.arange(256)
    img = np.stack([b, (b + 85) % 256, (b + 170) % 256], -1).astype(np.uint8)
    return torch.from_numpy(img.reshape(1, 16, 16, 3))


def _chain(u8, s, dtype):
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops.quant3d import quantize_pad_plain
    return quantize_pad_plain(pp.normalize_imagenet_plain(u8, dtype).permute(0, 2, 3, 1), s)


def _table(entry, u8_all):
    """K2's table from an entry's output on the all-bytes image: (3, 256),
    row c the channel-c output of each byte."""
    out = entry(u8_all).reshape(256, -1)[:, :3]
    tab = torch.empty((3, 256), dtype=out.dtype)
    for c in range(3):
        tab[c, u8_all.reshape(256, 3)[:, c].long()] = out[:, c]
    return tab


def _lookup(tab, u8):
    """What the kernel computes: each value one table read, channel 3 zero."""
    out = torch.stack([tab[c][u8[..., c].long()] for c in range(3)], -1)
    return torch.nn.functional.pad(out, (0, 1))


@pytest.mark.parametrize("scale", CROP_SCALES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_crops_entry_every_table_entry_equals_the_chain(dtype, scale):
    from fac_fake_torch.ops import preprocess as pp

    u8, s = _all_bytes(), torch.tensor(scale)
    got = pp.quantize_crops(u8, s, dtype)
    assert got.dtype == torch.int8 and got.shape == (1, 16, 16, 4) and got.is_contiguous()
    assert not got[..., 3].any()
    assert torch.equal(got, _chain(u8, s, dtype))


def test_the_scales_make_the_clip_and_exact_ties_happen():
    """What the equality tests above cover: on the all-bytes image every
    scale clips some values to ±127, and exact .5 quotients (rounded half
    to even) occur in bf16 at 2⁻⁶, in fp32 at the searched scale, and on
    raw bytes at 2."""
    from fac_fake_torch.ops import preprocess as pp

    def quotients(dtype, scale):
        return pp.normalize_imagenet_plain(_all_bytes(), dtype).float() / torch.tensor(scale)

    ties = lambda q: int(((q - q.floor()) == 0.5).sum())
    for dtype in DTYPES:
        for scale in CROP_SCALES:
            assert int((quotients(dtype, scale).abs() > 127.5).sum()) > 0
    assert ties(quotients(torch.bfloat16, 2.0 ** -6)) > 100
    assert ties(quotients(torch.float32, CROP_SCALES[2])) == 10
    raw = _all_bytes().float()
    assert ties(raw / torch.tensor(2.0)) == 384 and int((raw / 1.0 > 127.5).sum()) == 384


@pytest.mark.parametrize("scale", CROP_SCALES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_crops_entry_matches_jax_normalize_and_quantize(dtype, scale):
    """JAX `normalize_imagenet` (`fac_fake_tpu/ops/preprocess.py:25-29`),
    the input in the layer's dtype, then `QuantConv3x3`'s quantize
    (`fac_fake_tpu/models/layers.py:132-133`). Bar: int8 equal; a difference
    is reported with its (channel, byte)."""
    from fac_fake_tpu.ops.preprocess import normalize_imagenet as jax_norm
    from fac_fake_torch.ops import preprocess as pp

    u8 = _all_bytes()
    x = jax_norm(jnp.asarray(u8.numpy())).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                 else jnp.float32)
    x_scale = jnp.float32(scale)
    ref = np.asarray(jnp.clip(jnp.round(x.astype(jnp.float32) / x_scale),
                              -127, 127).astype(jnp.int8))
    got = pp.quantize_crops(u8, torch.tensor(scale), dtype)[..., :3].numpy()
    bad = [(c, int(u8.numpy()[0, i // 16, i % 16, c]), int(got.reshape(-1, 3)[i, c]),
            int(ref.reshape(-1, 3)[i, c]))
           for i, c in zip(*np.nonzero(got.reshape(-1, 3) != ref.reshape(-1, 3)))]
    assert not bad, f"(channel, byte, port, JAX) differ: {bad}"


@pytest.mark.parametrize("scale", CLIP_SCALES)
def test_clips_entry_every_byte_equals_the_cast_chain(scale):
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops.quant3d import quantize_pad_plain

    u8 = _all_bytes().reshape(1, 1, 16, 16, 3)
    s = torch.tensor(scale)
    got = pp.quantize_clips(u8, s)
    assert got.shape == (1, 1, 16, 16, 4) and not got[..., 3].any()
    assert torch.equal(got, quantize_pad_plain(u8.float(), s))
    # one row for all three channels: the value depends on the byte alone
    tab = _table(lambda t: pp.quantize_clips(t, s), _all_bytes())
    assert torch.equal(tab[0], tab[1]) and torch.equal(tab[0], tab[2])


@pytest.mark.parametrize("scale", CLIP_SCALES)
def test_clips_entry_matches_jax_quantize_in(scale):
    """JAX's S3D engine quantizes the raw clip with `_quantize_in`
    (`fac_fake_tpu/compat/quantize_s3d.py:93`). Bar: int8 equal."""
    from fac_fake_tpu.compat.quantize_s3d import _quantize_in
    from fac_fake_torch.ops import preprocess as pp

    u8 = _all_bytes()
    ref = np.asarray(_quantize_in(jnp.asarray(u8.numpy(), jnp.float32), jnp.float32(scale)))
    got = pp.quantize_clips(u8, torch.tensor(scale))[..., :3].numpy()
    bad = np.nonzero(got != ref)
    assert not bad[0].size, f"bytes {u8.numpy()[bad]}: port {got[bad]}, JAX {ref[bad]}"


@pytest.mark.parametrize("shape", [(1, 5, 7, 3), (3, 11, 13, 3), (1, 1, 513, 3),
                                   (2, 16, 16, 3)])
@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8_fp32", "int8_bf16", "raw"])
def test_table_model_of_the_kernel_equals_the_entries(shape, mode):
    """The kernel's design, modelled: a 3 × 256 table made once, then one
    read a value, gives each entry's output on ragged images (pixel counts
    35, 429, 513 and 512)."""
    from fac_fake_torch.ops import preprocess as pp

    dt = torch.bfloat16 if "bf16" in mode else torch.float32
    s = torch.tensor(2.0 if mode == "raw" else 0.019)
    entry = {"fp32": lambda t: pp.normalize_imagenet(t, dt).permute(0, 2, 3, 1),
             "bf16": lambda t: pp.normalize_imagenet(t, dt).permute(0, 2, 3, 1),
             "raw": lambda t: pp.quantize_clips(t, s)}.get(
                 mode, lambda t: pp.quantize_crops(t, s, dt))
    u8 = torch.from_numpy(np.random.default_rng(sum(shape)).integers(
        0, 256, shape, dtype=np.uint8))
    model = _lookup(_table(entry, _all_bytes()), u8)
    got = entry(u8)
    assert torch.equal(model[..., :got.shape[-1]], got)


# ---- the CViT: forward_crops ---------------------------------------------------

def _tiny_cvit(seed):
    """Base `cvit` at small width: `vgg_stem`'s 17 convs in 5 stages with 4,
    4, 8, 8 and 8 channels, on 32² crops, one transformer layer of width
    32. Quantized, its walk has the real stem's shape: 16 fused edges, 4
    int8 pools, 1 fp pool."""
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.cvit import CViT
    from fac_fake_torch.models.stems import vgg_stem
    narrow = {32: 4, 64: 4, 128: 8, 256: 8, 512: 8}
    spec = tuple((op[0], narrow[op[1]]) if len(op) > 1 else op for op in vgg_stem())
    return init_weights(CViT(spec, image_size=32, pos_mode="legacy", patch_size=1, dim=32,
                             depth=1, heads=2, mlp_dim=32), seed).eval()


def _scorer(quantize, dtype, crops):
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    cfg = Config()
    cfg.data.image_size = 32
    cfg.infer.batch_crops = 32
    cfg.infer.quantize = quantize
    cfg.model.dtype = "bfloat16" if dtype == torch.bfloat16 else "float32"
    scorer = VideoScorer(_tiny_cvit(1), cfg, device="cpu")
    if quantize != "none":
        scorer.quantize_int8(crops)
    return scorer


@pytest.mark.parametrize("quantize", ["int8", "int8_full", "none"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cvit_forward_crops_equals_the_old_chain(quantize, dtype):
    """`VideoScorer` scores through `CViT.forward_crops`: under int8 the
    stem's walk starts from K2's int8 entry and runs no quantize pass;
    the logits equal those of the old route (K2's normalize, then the
    model, whose walk quantizes its fp input) bit for bit."""
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant3d as q3

    crops = np.random.default_rng(7).integers(0, 256, (12, 32, 32, 3), dtype=np.uint8)
    scorer = _scorer(quantize, dtype, crops)
    u8 = torch.from_numpy(crops)
    pos = torch.arange(12) % 32
    ran = {"quantize_pad": 0, "quantize_crops": 0, "normalize_imagenet": 0}
    orig = {k: getattr(q3 if k == "quantize_pad" else pp, k) for k in ran}

    def counted(name):
        def run(*args, **kw):
            ran[name] += 1
            return orig[name](*args, **kw)
        return run

    q3.quantize_pad = counted("quantize_pad")
    pp.quantize_crops = counted("quantize_crops")
    pp.normalize_imagenet = counted("normalize_imagenet")
    try:
        with torch.inference_mode(), scorer._autocast():
            got = scorer.model.forward_crops(u8, dtype, pos)
    finally:
        q3.quantize_pad, pp.quantize_crops = orig["quantize_pad"], orig["quantize_crops"]
        pp.normalize_imagenet = orig["normalize_imagenet"]
    walk = quantize != "none"
    assert ran == {"quantize_pad": 0, "quantize_crops": int(walk),
                   "normalize_imagenet": int(not walk)}
    with torch.inference_mode(), scorer._autocast():
        want = scorer.model(pp.normalize_imagenet(u8, dtype), pos)
    assert torch.equal(got, want)
    assert torch.equal(scorer._forward(crops, pos), got)


@pytest.mark.parametrize("spec", [
    (("conv", 8), ("relu",), ("pool",)),
    (("qconv", 8), ("qconv", 8), ("relu",), ("pool",), ("pool",), ("qconv", 8)),
    (("qconv", 8), ("bn", 8), ("qconv", 8), ("relu",)),
    (("relu",), ("qconv", 8), ("qconv", 8)),
    (("qconv", 8), ("relu",), ("qconv", 16), ("relu",), ("pool",), ("qconv", 16), ("relu",)),
])
def test_walk_counts_from_crops_match_a_run(spec):
    """``walk_counts(spec, crops=True)`` is what `Stem.forward_crops` runs:
    the walk's quantize pass becomes K2's int8 entry; a stem without a walk
    runs K2's normalize. The output equals `forward` on the normalized
    crops."""
    from fac_fake_torch.models.stems import Stem, walk_counts
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3

    stem = Stem(spec).eval()
    for m in stem.modules():   # scales of about the calibrated size
        if hasattr(m, "x_scale"):
            m.x_scale.fill_(0.02)
    counts = walk_counts(spec, crops=True)
    assert walk_counts(spec)["quantize"] == counts["quantize"] + counts["k2_int8"]
    names = {"convs": (q, "int8_conv3x3"), "quantize": (q3, "quantize_pad"),
             "k2_int8": (pp, "quantize_crops"), "k2_fp": (pp, "normalize_imagenet")}
    ran = dict.fromkeys(names, 0)
    orig = {k: getattr(mod, name) for k, (mod, name) in names.items()}

    def counted(kind):
        def run(*args, **kw):
            ran[kind] += 1
            return orig[kind](*args, **kw)
        return run

    u8 = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (2, 8, 8, 3),
                                                             dtype=np.uint8))
    for kind, (mod, name) in names.items():
        setattr(mod, name, counted(kind))
    try:
        with torch.no_grad():
            got = stem.forward_crops(u8, torch.float32)
    finally:
        for kind, (mod, name) in names.items():
            setattr(mod, name, orig[kind])
    assert ran == {k: counts[k] for k in ran}
    with torch.no_grad():
        assert torch.equal(got, stem(pp.normalize_imagenet(u8)))


# ---- S3D: the int8 engine on uint8 clips ---------------------------------------

P133 = ("pool", (1, 3, 3), (1, 2, 2), (0, 1, 1))
S3D_SPEC = (("sep", 16, 7, 2, 3, "relu", True), P133, ("basic", 16, 1, 1, 0, "relu"),
            ("mix", "3b", "relu", True), ("pool", (2, 2, 2), (2, 2, 2), (0, 0, 0)))


@pytest.fixture(scope="module")
def s3d():
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.s3d.model import S3DNet
    m = init_weights(S3DNet(S3D_SPEC, 1), 0).eval().to(memory_format=torch.channels_last_3d)
    clips = np.random.default_rng(12).integers(0, 256, (3, 8, 24, 24, 3), dtype=np.uint8)
    return m, clips


def test_s3d_engine_gives_the_same_logits_from_uint8_clips(s3d):
    """uint8 clips: K2's raw entry quantizes them for the stem conv, one
    quantize pass fewer; the logits equal those from the fp32 clips."""
    from fac_fake_torch.compat.quantize_s3d import quantize_s3d
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant3d as q3

    m, clips = s3d
    u8 = torch.from_numpy(clips).permute(0, 4, 1, 2, 3)   # channels_last_3d
    eng = quantize_s3d(m, u8[:2].float())
    ran = {"quantize_pad": 0, "quantize_clips": 0}
    orig = (q3.quantize_pad, pp.quantize_clips)

    def quantize_pad(x, s):
        ran["quantize_pad"] += 1
        return orig[0](x, s)

    def quantize_clips(x, s):
        ran["quantize_clips"] += 1
        return orig[1](x, s)

    q3.quantize_pad, pp.quantize_clips = quantize_pad, quantize_clips
    try:
        with torch.no_grad():
            fp = eng(u8.float())       # the stem's, the basic conv's and the mix's
            assert ran == {"quantize_pad": 3, "quantize_clips": 0}
            got = eng(u8)
            assert ran == {"quantize_pad": 5, "quantize_clips": 1}
    finally:
        q3.quantize_pad, pp.quantize_clips = orig
    assert torch.equal(got, fp)


def test_s3d_evaluator_scores_uint8_clips_as_the_fp32_route(s3d):
    """`S3DEvaluator(quantize="int8")` hands the engine the uint8 clips; its
    scores equal the engine's on the fp32 clips, and the fp32 evaluator
    still casts."""
    from fac_fake_torch.evaluate.s3d_eval import S3DEvaluator

    m, clips = s3d
    ev = S3DEvaluator(m, degrade=False, quantize="int8", device="cpu")
    seen = []
    probs = ev.predict_batch(clips)                  # calibrates on clips[:2]
    hook = ev.engine.register_forward_pre_hook(lambda _, args: seen.append(args[0].dtype))
    try:
        assert np.array_equal(ev.predict_batch(clips), probs)
    finally:
        hook.remove()
    assert seen == [torch.uint8]
    x = torch.from_numpy(clips).float().permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        want = torch.sigmoid(ev.engine(x)).numpy().reshape(3, -1).mean(-1)
    assert np.array_equal(probs, want)
    fp = S3DEvaluator(m, degrade=False, device="cpu")
    with torch.no_grad():
        ref = torch.sigmoid(m(x)).numpy().reshape(3, -1).mean(-1)
    assert np.array_equal(fp.predict_batch(clips), ref)


def test_s3d_engine_with_the_srm_bank_casts_uint8_clips():
    """``srm="concat30"`` (the SRM bank's filtered channels beside the RGB
    before the stem) keeps the fp route for the stem input: uint8 clips are
    cast, no raw entry runs, and the logits are those of the fp32 clips."""
    from fac_fake_torch.compat.quantize_s3d import quantize_s3d
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.s3d.model import S3DNet
    from fac_fake_torch.ops import preprocess as pp

    m = init_weights(S3DNet(S3D_SPEC, 1, srm="concat30"), 1).eval()
    m = m.to(memory_format=torch.channels_last_3d)
    clips = np.random.default_rng(13).integers(0, 256, (2, 8, 24, 24, 3), dtype=np.uint8)
    u8 = torch.from_numpy(clips).permute(0, 4, 1, 2, 3)
    eng = quantize_s3d(m, u8.float())
    raw, calls = pp.quantize_clips, []
    pp.quantize_clips = lambda *a: calls.append(a) or raw(*a)
    try:
        with torch.no_grad():
            got, fp = eng(u8), eng(u8.float())
    finally:
        pp.quantize_clips = raw
    assert not calls and torch.equal(got, fp)
