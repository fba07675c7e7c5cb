"""Zoo entries through the port's serving entry points on the CPU:
`VideoScorer` against the JAX package's `VideoScorer` on the same weights
and crops (fp32, and int8 / int8_full where JAX's quantizer takes the
stem), and `cli/predict.py --model <zoo entry>` on one tiny video."""
import numpy as np
import pytest
import torch

from test_torch_flagship import flat
from test_torch_zoo_entries import ENTRIES, port_entry, variant, zoo_variables

torch.set_num_threads(2)

HW = 64


def _cfg(c, quantize):
    c.data.image_size = HW
    c.infer.batch_crops = 32
    c.infer.quantize = quantize
    return c


def _pair(name):
    from fac_fake_tpu.core.config import ModelConfig as JaxModelConfig
    from fac_fake_tpu.models import build_model as jax_build
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    narrow = dict(patch_size=2, dim=64, depth=1, heads=2, mlp_dim=64)
    jm = jax_build(JaxModelConfig(name=name, **narrow))
    v = zoo_variables(jm, HW, ENTRIES.index(name))
    return jm, v, port_entry(name, cvit_state_dict_from_flax(flat(v), variant(name)))


@pytest.mark.parametrize("name,quantize", [
    ("cvit_ggca_uffc", "none"), ("cvit_ggca_uffc", "int8"), ("cvit_ggca_uffc", "int8_full"),
    ("cvit_ggca_add_wtconv", "none"), ("cvit_ggca_add_odconv", "none")])
def test_video_scorer_matches_jax(name, quantize):
    """`score_crops` of 12 seeded crops (padded to 32 rows, the legacy pos
    rows of the reference's chunks) within 1e-3 of JAX's `VideoScorer` on
    the same weights, the int8 modes calibrating on that first batch and
    quantizing each stem's conv prefix as JAX does. (UFFC's output depends
    on the whole padded batch, through its batch-wide mean and range, in
    both packages alike.)"""
    from fac_fake_tpu.core.config import Config as JaxConfig
    from fac_fake_tpu.infer.predictor import VideoScorer as JaxScorer
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    jm, v, tm = _pair(name)
    crops = np.random.default_rng(3).integers(0, 255, (12, HW, HW, 3), dtype=np.uint8)
    js = JaxScorer(jm, v, _cfg(JaxConfig(), quantize))
    ts = VideoScorer(tm, _cfg(Config(), quantize), device="cpu")
    got = ts.score_crops(crops)
    assert abs(got - js.score_crops(crops)) <= 1e-3
    if quantize != "none":
        assert not ts._quant_pending and ts.model.quant_dense == (quantize == "int8_full")
        assert sum(op[0] == "qconv" for op in ts.model.stem_ops()) == 17


@pytest.mark.parametrize("quantize", ["int8", "int8_full"])
def test_video_scorer_int8_on_a_mixer_stem(quantize):
    """``cvit_ggca_add_wtconv`` scored in int8: its stem's int8 walk is one
    conv from K2's int8 entry, dequantized for WTConv (JAX's `VideoScorer`
    refuses to quantize this stem); the score is a probability and moves
    from the fp32 one by less than 0.05 on these crops."""
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    _, _, tm = _pair("cvit_ggca_add_wtconv")
    crops = np.random.default_rng(4).integers(0, 255, (12, HW, HW, 3), dtype=np.uint8)
    fp = VideoScorer(tm, _cfg(Config(), "none"), device="cpu").score_crops(crops)
    ts = VideoScorer(tm, _cfg(Config(), quantize), device="cpu")
    got = ts.score_crops(crops)
    assert ts.model.walk_counts()["convs"] == 1 and ts.model.stem_ops()[0] == ("qconv", 32)
    assert 0.0 <= got <= 1.0 and abs(got - fp) < 0.05, (got, fp)


def test_cli_predict_scores_a_zoo_entry(tmp_path):
    """`cli/predict.py --model cvit_ggca_uffc --device cpu` on a
    reference-keyed .pth (DDP prefix, training dict) over a directory with
    one noise mp4 (no faces: score 0.5)."""
    import cv2
    from fac_fake_torch.cli import predict
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model
    narrow = dict(dim=64, depth=1, heads=2, mlp_dim=64)
    src = build_model(ModelConfig(name="cvit_ggca_uffc", **narrow), device="cpu", seed=7)
    assert src.uffc.locMap.shape == (14, 8)
    torch.save({"epoch": 1, "state_dict": {f"module.{k}": w for k, w in src.state_dict().items()}},
               tmp_path / "uffc.pth")
    vdir = tmp_path / "videos"
    vdir.mkdir()
    wr = cv2.VideoWriter(str(vdir / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (96, 64))
    rng = np.random.default_rng(7)
    for _ in range(20):
        wr.write(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    wr.release()
    rows = predict.main(["--videos", str(vdir), "--weights", str(tmp_path / "uffc.pth"),
                         "--model", "cvit_ggca_uffc", "--save-csv", str(tmp_path / "pred.csv"),
                         "--device", "cpu", "--workers", "1", "--set"]
                        + [f"model.{k}={x}" for k, x in narrow.items()])
    assert [r[0] for r in rows] == ["clip.mp4"] and rows[0][1] == 0.5
