"""The port's ResNet/KAN family (`fac_fake_torch/models/resnet.py`: ``reskan``,
``resvitkan``, ``resvit``) against the JAX package's on the CPU: feature maps
of ResNet-18/34/50 and the vendored variant, logits with JAX's variables
carried across (randomized BatchNorm statistics), the carrier against JAX's
own converters, `VideoScorer` against JAX's, the refusals and
`cli/predict.py --model resvitkan`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

torch.set_num_threads(2)

HW = 64
# the reduced transformer of the family's parity tests
SMALL = dict(patch_size=2, dim=64, depth=1, heads=2, mlp_dim=128)
TOL = 2e-4                       # tests/test_cvit_parity.py's bar
BN_MODULES = ("bn1", "bn2", "bn3", "ds_bn")


def _flat(variables):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(variables).items()}


def _randomize_bn(variables, seed):
    """Non-trivial BatchNorm statistics and affine parameters."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(variables)
    for k in list(flat):
        shape = np.shape(flat[k])
        if k[0] == "batch_stats":
            flat[k] = jnp.asarray(rng.normal(0, 0.1, shape) if k[-1] == "mean"
                                  else rng.uniform(0.5, 2.0, shape), jnp.float32)
        elif k[0] == "params" and k[-2] in BN_MODULES:
            flat[k] = flat[k] + jnp.asarray(rng.normal(0, 0.1, shape), jnp.float32)
    return traverse_util.unflatten_dict(flat)


def _images(seed, b=2, hw=HW):
    return np.random.default_rng(seed).standard_normal((b, hw, hw, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("depth,vendored", [(18, False), (34, False), (50, False), (50, True)])
def test_resnet_feature_maps_match_jax(depth, vendored):
    """The final feature map (vendored: ReLU before the add and the 512
    squeeze) at 64², batch 2: rtol/atol 2e-4."""
    from fac_fake_tpu.models.resnet import ResNet as JaxResNet
    from fac_fake_torch.compat.weights import resnet_torch_key
    from fac_fake_torch.models.resnet import ResNet

    jm = JaxResNet(depth, relu_before_add=vendored, squeeze_512=vendored)
    v = _randomize_bn(jm.init(jax.random.key(depth), jnp.zeros((1, HW, HW, 3))), depth)
    sd = {}
    for k, a in _flat(v).items():
        col, *rest = k.split("/")
        key, tf = resnet_torch_key(rest, col)
        sd[key] = torch.from_numpy(np.array(tf(a), order="C"))
    tm = ResNet(depth, relu_before_add=vendored, squeeze_512=vendored).eval()
    tm.load_state_dict(sd, strict=True)
    x = _images(depth)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 2, 2, 512 if vendored or depth < 50 else 2048)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def _family(name, seed, hw=HW, **over):
    """JAX's model and variables (randomized BN) and the port's model with
    them loaded through the carrier, ``strict=True``."""
    from fac_fake_tpu.core.config import ModelConfig as JaxModelConfig
    from fac_fake_tpu.models import build_model as jax_build
    from fac_fake_torch.compat import weights
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model

    jm = jax_build(JaxModelConfig(name=name, **over))
    v = _randomize_bn(jm.init(jax.random.key(seed), jnp.zeros((1, hw, hw, 3))), seed)
    tm = build_model(ModelConfig(name=name, image_size=hw, **over), device="cpu")
    sd = (weights.reskan_state_dict_from_flax(_flat(v)) if name == "reskan" else
          weights.resvitkan_state_dict_from_flax(_flat(v), "mlp" if name == "resvit" else "kan"))
    tm.load_state_dict(sd, strict=True)
    return jm, v, tm.eval()


def test_reskan_logits_match_jax():
    """``reskan`` (ResNet-34, mean pool, KAN((512, 64, 2))) at 64², batch 2."""
    jm, v, tm = _family("reskan", 0)
    x = _images(0)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_nchw(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["resvitkan", "resvit"])
@pytest.mark.parametrize("batch", [2, 40])
def test_resvit_family_logits_match_jax(name, batch):
    """``resvitkan`` (ResNet-50 vendored, KAN head) and ``resvit``
    (ResNet-18, MLP head) at a reduced transformer, 64²: batch 2 with pos
    rows 0..1, and batch 40 with legacy ``pos_indices`` ``arange % 32``
    (refused without them, as in JAX)."""
    jm, v, tm = _family(name, batch, **SMALL)
    x = _images(batch, batch)
    pos = np.arange(batch) % 32
    ref = np.asarray(jm.apply(v, jnp.asarray(x), pos_indices=jnp.asarray(pos)))
    with torch.no_grad():
        got = tm(_nchw(x), torch.from_numpy(pos)).numpy()
        if batch > 32:
            with pytest.raises(ValueError, match="caps batch at 32"):
                tm(_nchw(x))
        else:
            np.testing.assert_allclose(tm(_nchw(x)).numpy(), got, rtol=0, atol=0)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_resvitkan_patch_pos_mode_matches_jax():
    """``pos_embedding_mode="patch"``: the per-position embedding, sized from
    the image (64² → a 2×2 map → 1 patch + cls), no batch cap."""
    jm, v, tm = _family("resvitkan", 5, pos_embedding_mode="patch", **SMALL)
    assert tuple(tm.pos_embedding.shape) == (1, 2, 64)
    x = _images(5, 40)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_nchw(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_full_width_resvitkan_logits_match_jax():
    """``resvitkan`` at its published widths (224², patch 7, dim 1024, depth
    6, heads 8, mlp 2048, KAN (2048, 64, 2)), batch 2, pos rows [0, 31]."""
    jm, v, tm = _family("resvitkan", 7, hw=224)
    x = _images(7, 2, 224)
    pos = np.array([0, 31])
    ref = np.asarray(jm.apply(v, jnp.asarray(x), pos_indices=jnp.asarray(pos)))
    with torch.no_grad():
        got = tm(_nchw(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["reskan", "resvitkan", "resvit"])
def test_carrier_round_trips_through_jax_converters(name):
    """The port's state_dict (from JAX's variables through the carrier),
    fed to JAX's `convert_reskan` / `convert_resvitkan(head=…)`, gives back
    JAX's variables exactly; its keys are the reference's."""
    from fac_fake_tpu.compat.torch_weights import convert_reskan, convert_resvitkan

    over = {} if name == "reskan" else SMALL
    _, v, tm = _family(name, 3, **over)
    sd = {k: t.numpy() for k, t in tm.state_dict().items()}
    back = (convert_reskan(sd, v) if name == "reskan" else
            convert_resvitkan(sd, v, head="mlp" if name == "resvit" else "kan"))
    want, got = _flat(v), _flat(back)
    assert sorted(want) == sorted(got)
    for k in want:
        assert np.array_equal(want[k], got[k]), k
    head = {"reskan": "kan.layers.1.grid", "resvitkan": "kan_head.3.layers.1.grid",
            "resvit": "mlp_head.3.weight"}[name]
    assert head in sd and (name == "reskan") == ("layer4.2.conv2.weight" in sd)


@pytest.mark.parametrize("name", ["reskan", "resvitkan", "resvit"])
def test_seeded_family_builds_with_every_parameter_set(name):
    """`build_model` initialises every parameter (`init_weights` raises on
    one left unset) and the seeded logits are finite and of order 1."""
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model

    over = {} if name == "reskan" else dict(SMALL, image_size=HW)
    m = build_model(ModelConfig(name=name, **over), device="cpu", seed=2)
    u8 = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, HW, HW, 3),
                                                            dtype=np.uint8))
    with torch.no_grad():
        if name == "reskan":
            from fac_fake_torch.ops.preprocess import normalize_imagenet
            logits = m(normalize_imagenet(u8))
        else:
            logits = m.forward_crops(u8, torch.float32, torch.arange(2))
    assert logits.shape == (2, 2) and torch.isfinite(logits).all()
    assert 1e-3 < float(logits.abs().max()) < 50


def _scorers():
    from fac_fake_tpu.core.config import Config as JaxConfig
    from fac_fake_tpu.infer.predictor import VideoScorer as JaxScorer
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    from test_torch_predictor import JaxStub, Reader, TorchStub

    jm, v, tm = _family("resvitkan", 4, **SMALL)
    jcfg, tcfg = JaxConfig(), Config()
    for c in (jcfg, tcfg):
        c.infer.batch_crops = 32
        c.data.image_size = HW
    js = JaxScorer(jm, v, jcfg, detector=JaxStub(), reader=Reader())
    ts = VideoScorer(tm, tcfg, detector=TorchStub(), reader=Reader(), device="cpu")
    return js, ts


def test_video_scorer_with_resvitkan_matches_jax():
    """Per-video scores equal JAX's `VideoScorer` on the same crops within
    1e-4 (BASELINE.md's bar); `score_videos_batched` (`score_crop_stacks`)
    equals per-video scoring (`score_crops`) within 1e-6; each forward runs
    K9's entry twice."""
    from fac_fake_torch.ops import kan

    js, ts = _scorers()
    paths = ["vid_a.mp4", "vid_b.mp4", "empty.mp4"]
    ref = [js.score_video(p) for p in paths]
    calls = []
    real = kan.kan_bases

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    kan.kan_bases = counted
    try:
        got = [ts.score_video(p) for p in paths]
        batched = ts.score_videos_batched(paths, num_workers=1)
    finally:
        kan.kan_bases = real
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert got[-1] == 0.5 and ts.crop_counts["vid_a.mp4"] == 29
    np.testing.assert_allclose(batched, got, rtol=0, atol=1e-6)
    # two forwards of 32 rows, one of 2 x 32: (rows, 128) then (rows, 64)
    assert calls == [(32, 128), (32, 64)] * 2 + [(64, 128), (64, 64)]


def test_resvitkan_bf16_scores_near_fp32():
    """``model.dtype="bfloat16"``: K2 writes bf16, every layer follows its
    input's dtype, and the KAN head's bases are computed in bf16 (JAX casts x
    and the grid to the model dtype); the score stays within 2e-2 of fp32."""
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.ops import kan

    _, ts = _scorers()
    cfg = Config()
    cfg.model.dtype = "bfloat16"
    cfg.data.image_size = HW
    bf = VideoScorer(ts.model, cfg, device="cpu")
    crops = np.random.default_rng(5).integers(0, 256, (12, HW, HW, 3), dtype=np.uint8)
    dtypes = []
    real = kan.kan_bases
    kan.kan_bases = lambda x, g, k: dtypes.append((x.dtype, g.dtype)) or real(x, g, k)
    try:
        p_bf = bf.score_crops(crops)
    finally:
        kan.kan_bases = real
    assert dtypes == [(torch.bfloat16, torch.bfloat16)] * 2
    assert abs(p_bf - ts.score_crops(crops)) <= 2e-2


def test_scorer_refuses_reskan_and_int8_on_the_family():
    """``reskan``'s forward takes no pos rows: the scorer refuses it (JAX's
    raises a TypeError there). int8 serving quantizes CViT stems: the
    ResVitKan family has none, and `quantize_cvit` refuses it too."""
    from fac_fake_torch.compat.quantize import quantize_cvit
    from fac_fake_torch.core.config import Config, ModelConfig
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import build_model

    with pytest.raises(ValueError, match="pos rows"):
        VideoScorer(build_model(ModelConfig(name="reskan"), device="cpu"), Config(),
                    device="cpu")
    m = build_model(ModelConfig(name="resvit", image_size=HW, **SMALL), device="cpu")
    for mode in ("int8", "int8_full"):
        cfg = Config()
        cfg.infer.quantize = mode
        with pytest.raises(ValueError, match="no foldable stem"):
            VideoScorer(m, cfg, device="cpu")
    with pytest.raises(ValueError, match="no foldable stem"):
        quantize_cvit(m, torch.zeros(2, 3, HW, HW))


@pytest.mark.parametrize("name", ["reskan", "resvitkan", "resvit"])
def test_trainer_refuses_the_kan_models(name):
    """K9 has no backward, and JAX's `Trainer` cannot train the KAN family:
    the port's `Trainer` refuses a model that holds a `KANLinear` (``reskan``,
    ``resvitkan``) and takes ``resvit``, whose head is an MLP. On the CPU the
    plain bases stay tracked by autograd."""
    from fac_fake_torch.core.config import Config, ModelConfig
    from fac_fake_torch.models import build_model
    from fac_fake_torch.models.blocks.kan import KANLinear
    from fac_fake_torch.train.trainer import Trainer

    over = {} if name == "reskan" else dict(image_size=HW, **SMALL)
    m = build_model(ModelConfig(name=name, **over), device="cpu", seed=0)
    if name == "resvit":
        assert Trainer(m, Config(), device="cpu").model is m
        return
    with pytest.raises(ValueError, match="KANLinear.*no backward.*JAX Trainer"):
        Trainer(m, Config(), device="cpu")
    head = next(mod for mod in m.modules() if isinstance(mod, KANLinear))
    x = torch.rand((3, head.in_features), requires_grad=True)
    head(x).sum().backward()
    assert x.grad is not None and bool(x.grad.abs().sum() > 0)


def test_cli_predict_resvitkan_on_the_cpu(tmp_path):
    """`cli/predict.py --model resvitkan --device cpu` at a reduced width,
    with a reference-keyed .pth (DDP prefix, training dict) loaded
    ``strict=True``, over a noise mp4 whose crops come from the seeded MTCNN
    at thresholds (0, 0, 0): one forward, K9's entry twice."""
    import cv2
    from fac_fake_torch.cli import predict
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import kan

    src = build_model(ModelConfig(name="resvitkan", image_size=HW, **SMALL), device="cpu",
                      seed=6)
    torch.save({"epoch": 1, "state_dict": {f"module.{k}": w for k, w in
                                           src.state_dict().items()}}, tmp_path / "rvk.pth")
    vdir = tmp_path / "videos"
    vdir.mkdir()
    wr = cv2.VideoWriter(str(vdir / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (96, 64))
    rng = np.random.default_rng(6)
    for _ in range(20):
        wr.write(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    wr.release()
    sets = [f"model.{k}={x}" for k, x in SMALL.items()] + [
        f"model.image_size={HW}", f"data.image_size={HW}", "infer.batch_crops=32",
        "infer.detector=mtcnn", "infer.mtcnn_thresholds=(0.0,0.0,0.0)"]
    calls = []
    real = kan.kan_bases
    kan.kan_bases = lambda x, g, k: calls.append(x.shape) or real(x, g, k)
    try:
        rows = predict.main(["--videos", str(vdir), "--model", "resvitkan", "--weights",
                             str(tmp_path / "rvk.pth"), "--save-csv", str(tmp_path / "p.csv"),
                             "--device", "cpu", "--workers", "1", "--set"] + sets)
    finally:
        kan.kan_bases = real
    assert [r[0] for r in rows] == ["clip.mp4"]
    assert 0.0 <= rows[0][1] <= 1.0 and rows[0][1] != 0.5
    # the seeded init's spline fit at the grid's 6 inner knots, then one forward
    assert calls == [(6, 128), (6, 64), (32, 128), (32, 64)], calls
