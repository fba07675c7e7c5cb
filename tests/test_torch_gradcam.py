"""The port's Grad-CAM (`fac_fake_torch/evaluate/gradcam.py`, the
``features_override``/``embed_override`` hooks of `models/cvit.py`) and
``cli/evaluate.py gradcam`` against the JAX package on the CPU.

Models: JAX's `tiny_cvit(pos_mode="patch")` (5 pools: a 7 × 7 map, one
patch, so the token CAM is JAX's all-zero 1 × 1), the 4-pool 2 × 2-patch
model of `tests/test_s3d_workload.py`, and the small twins of
``cvit_ggca_sla`` (the embedding block after the token hook) and
``cvit_bfm_ggca_mdfa`` (a token block). The weights go across through
`export_cvit` and ``load_state_dict(strict=True)``; the images are seeded
uint8 crops, normalized by K2's plain version for the port and fed to JAX
normalized the same way. CAMs within 1e-5 of the largest value (each is
min-maxed to [0, 1]), with and without ``target_class``."""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_zoo_entries import variant
from test_torch_zoo_train import flax_variables, jax_model, moved, port_model

torch.set_num_threads(2)

CAM_TOL = 1e-5


def _spec(pools):
    spec = ()
    for _ in range(pools):
        spec += (("conv", 8), ("bn", 8), ("relu",), ("pool",))
    return spec


def _tiny(pools):
    """(JAX CViT, port CViT) of the tiny test skeleton with ``pools`` pools."""
    from fac_fake_tpu.models.cvit import CViT as JaxCViT
    from fac_fake_torch.models.cvit import CViT
    dims = dict(dim=64, mlp_dim=64) if pools == 5 else dict(dim=32, mlp_dim=32)
    return (JaxCViT(stem_spec=_spec(pools), depth=1, heads=2, pos_mode="patch", **dims),
            CViT(_spec(pools), depth=1, heads=2, pos_mode="patch", **dims))


class _Jitted:
    """A JAX model whose ``apply`` is jitted: JAX's `gradcam` (and its CLI,
    given this as the registry's model) then runs compiled, not op by op
    (~4x faster at these sizes)."""

    def __init__(self, jm):
        self.init = jm.init
        self.apply_jit = jax.jit(jm.apply, static_argnames=("train", "mutable"))

    def apply(self, variables, x, **kw):
        if "mutable" in kw:
            kw["mutable"] = tuple(kw["mutable"])
        return self.apply_jit(variables, x, **kw)


def _pair(name, dtype=jnp.float32):
    """(JAX model, its variables, the port model loaded from them, crop side)."""
    from fac_fake_tpu.compat.torch_export import export_cvit
    from fac_fake_torch.models import init_weights
    if name.startswith("tiny"):
        jm, m = _tiny(int(name[-1]))
        hw, var = 224, "cvit"
        # the port's seeded weights in JAX's tree (no jitted JAX init: ~5 s)
        v = flax_variables(jm, init_weights(m, 0), hw, name, var)
    else:
        jm, m = jax_model(name, dtype), port_model(name)
        hw, var = m.config["image_size"], variant(name)
        v = moved(flax_variables(jm, init_weights(port_model(name), 0), hw, name), 0)
        v = {k: v[k] for k in ("params", "batch_stats") if k in v}
    sd = {k: torch.from_numpy(np.array(a)) for k, a in export_cvit(v, var).items()}
    for k, t in m.state_dict().items():
        sd.setdefault(k, t)                 # num_batches_tracked: JAX has none
    m.load_state_dict(sd, strict=True)
    return jm, v, m.eval(), hw


def _crops(hw, n=2, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3),
                                                                  dtype=np.uint8))


# the modes each model is held in: both on the plain skeleton (one patch: the
# token CAM is JAX's zero); the 2 x 2 token grid on the 4-pool model; the
# token CAM through SLA's embedding block; the feature CAM through BFM, GGCA
# and the MDFA token block (its token CAM is one patch again)
MODES = {"tiny5": ("cnn", "tokens"), "tiny4": ("tokens",), "cvit_ggca_sla": ("tokens",),
         "cvit_bfm_ggca_mdfa": ("cnn",)}
MODELS = tuple(MODES)


@pytest.mark.parametrize("name", MODELS)
def test_cams_match_jax(name):
    """The tiny models in fp32 from uint8 crops; the zoo twins in float64 on
    both sides: their CAMs sum channel terms that cancel to ~1e-3 of
    themselves, so the 3e-6 by which the two fp32 stems round apart moves
    a CAM some 6e-5 of its largest value (cvit_ggca_sla's twin). Each mode
    with and without ``target_class``."""
    from fac_fake_tpu.evaluate.gradcam import gradcam as jax_gradcam
    from fac_fake_tpu.evaluate.gradcam import gradcam_tokens as jax_tokens
    from fac_fake_torch.evaluate.gradcam import gradcam, gradcam_tokens
    from fac_fake_torch.ops.preprocess import normalize_imagenet_plain
    f64 = not name.startswith("tiny")
    with jax.enable_x64(f64):
        jm, v, m, hw = _pair(name, jnp.float64 if f64 else jnp.float32)
        u8 = _crops(hw)
        x = normalize_imagenet_plain(u8)
        if f64:
            v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
            m, x, u8 = m.double(), x.double(), x.double()
        japply = _Jitted(jm)
        fns = {"cnn": (gradcam, jax_gradcam), "tokens": (gradcam_tokens, jax_tokens)}
        for port_fn, jax_fn in (fns[mode] for mode in MODES[name]):
            for target in (None, 1):
                want = np.asarray(jax_fn(japply, v, jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                                         target_class=target))
                got = port_fn(m, u8, target_class=target)
                _check_cam(name, port_fn.__name__, target, got, want)
    if not f64:
        # the fp32 NCHW input gives the CAM of the crops it normalizes
        assert np.array_equal(gradcam(m, x), gradcam(m, u8))


def _check_cam(name, fn, target, got, want):
    assert got.shape == want.shape, (fn, target)
    assert np.abs(got - want).max() <= CAM_TOL * max(np.abs(want).max(), 1.0), \
        (fn, target, np.abs(got - want).max())
    if fn == "gradcam_tokens" and name == "tiny5":
        # one patch: JAX's min-max of a 1 x 1 CAM is 0
        assert got.shape == (2, 1, 1) and not got.any()


@pytest.mark.parametrize("name", MODELS + ("cvit_ggca_add_glu",))
def test_overrides_leave_forward_bit_identical(name):
    """`forward` with no override, with ``features_override`` of its own
    `stem_features`, and with ``embed_override`` of its own `patch_tokens`:
    the same bits; `forward_crops` equals `forward` of the normalize."""
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.ops.preprocess import normalize_imagenet_plain
    m, hw = (port_model(name), None) if name.startswith("cvit") else (_tiny(int(name[-1]))[1], 224)
    m = init_weights(m, 1).eval()
    u8 = _crops(hw or m.config["image_size"], seed=5)
    x = normalize_imagenet_plain(u8)
    with torch.no_grad():
        logits = m(x)
        feats = m.stem_features(x)
        assert torch.equal(m(None, features_override=feats), logits)
        assert torch.equal(m(None, embed_override=m.patch_tokens(feats)), logits)
        assert torch.equal(m.forward_crops(u8), logits)


def test_refusals():
    from fac_fake_torch.compat.quantize import quantize_cvit
    from fac_fake_torch.evaluate.gradcam import gradcam
    _, m = _tiny(5)
    u8 = _crops(224, n=1)
    with pytest.raises(ValueError, match="fp32 images"):
        gradcam(m, u8.permute(0, 3, 1, 2).half())
    with pytest.raises(ValueError, match="unquantized"):
        gradcam(m.to(torch.bfloat16), u8)
    from fac_fake_torch.compat.fold import fold_cvit
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.ops.preprocess import normalize_imagenet_plain
    for full in (False, True):          # infer.quantize int8, int8_full
        q = quantize_cvit(fold_cvit(init_weights(_tiny(5)[1], 0).eval()),
                          normalize_imagenet_plain(u8), transformer=full)
        with pytest.raises(ValueError, match="unquantized"):
            gradcam(q, u8)
    with pytest.raises(ValueError, match="needs a CViT"):
        gradcam(torch.nn.Linear(2, 2), u8)
    # legacy positions: at most 32 images, as JAX's
    from fac_fake_torch.models.cvit import CViT
    legacy = init_weights(CViT(_spec(5), dim=64, depth=1, heads=2, mlp_dim=64), 0).eval()
    with pytest.raises(ValueError, match="caps batch at 32"):
        gradcam(legacy, _crops(224, n=33))


def test_cli_gradcam_writes_jax_overlays(tmp_path, monkeypatch):
    """Both CLIs on the same non-square image and .pth (the CNN mode; the
    token mode's CAMs are `test_cams_match_jax`'s): the overlay PNG within
    one level of JAX's."""
    from fac_fake_tpu.cli import evaluate as jax_cli
    from fac_fake_tpu.core import registry as jax_registry
    from fac_fake_torch.cli import evaluate as port_cli
    from fac_fake_torch.core import registry as port_registry
    import fac_fake_tpu.models  # noqa: F401  (registers the JAX entries)
    import fac_fake_torch.models  # noqa: F401
    from fac_fake_tpu.models.cvit import CViT as JaxCViT
    from fac_fake_torch.models.cvit import CViT
    # 112² crops, 3 pools: a 14 x 14 map, 2 x 2 patches
    dims = dict(dim=32, depth=1, heads=2, mlp_dim=32, pos_mode="patch")
    jm = JaxCViT(stem_spec=_spec(3), **dims)
    monkeypatch.setitem(jax_registry._REGISTRIES["model"], "cam_tiny", lambda cfg: _Jitted(jm))
    monkeypatch.setitem(port_registry._REGISTRIES["model"], "cam_tiny",
                        lambda cfg: CViT(_spec(3), image_size=cfg.image_size, **dims))
    from fac_fake_torch.models import init_weights
    # the port's seeded weights, which JAX's CLI converts from the .pth
    torch.save(init_weights(CViT(_spec(3), image_size=112, **dims), 2).state_dict(),
               tmp_path / "w.pth")
    rng = np.random.default_rng(0)
    img = cv2.GaussianBlur(rng.integers(0, 256, (180, 240, 3), dtype=np.uint8), (9, 9), 3)
    cv2.imwrite(str(tmp_path / "face.png"), img)
    for mode in ("cnn",):
        outs = {}
        for who, cli, extra in (("jax", jax_cli, []), ("port", port_cli, ["--device", "cpu"])):
            d = tmp_path / f"{who}_{mode}"
            cli.main(["gradcam", "--images", str(tmp_path / "face.png"), "--model", "cam_tiny",
                      "--weights", str(tmp_path / "w.pth"), "--mode", mode, "--out-dir", str(d),
                      "--target-class", "0", "--set", "model.image_size=112"] + extra)
            outs[who] = cv2.imread(str(d / "face_cam.png")).astype(np.int16)
        assert outs["port"].shape == (112, 112, 3)
        assert np.abs(outs["port"] - outs["jax"]).max() <= 1, mode
    with pytest.raises(SystemExit, match="orbax"):
        port_cli.main(["gradcam", "--images", str(tmp_path / "face.png"), "--weights",
                       str(tmp_path), "--device", "cpu", "--model", "cam_tiny", "--set",
                       "model.image_size=112"])
