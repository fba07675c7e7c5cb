"""The variant zoo in bf16 against the JAX package on the CPU, the other half
of the entries (``ENTRIES[1::2]``, by the rules of
`test_torch_zoo_bf16.py`); `VideoScorer` at ``model.dtype=bfloat16`` on a
zoo entry against JAX's; and one train-then-score round trip through the
CLIs, ``cli/train.py --model cvit_ggca_uffc`` then ``cli/predict.py
--model cvit_ggca_uffc --weights best.pth``."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_checkpoint import _crop_tree
from test_torch_zoo_bf16 import bf16_pair, check_bf16_logits
from test_torch_zoo_entries import ENTRIES

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ENTRIES[1::2])
def test_zoo_bf16_logits_match_jax(name):
    check_bf16_logits(name)


@pytest.mark.parametrize("quantize", ["none", "int8_full"])
def test_video_scorer_scores_a_zoo_entry_in_bf16(quantize):
    """``cvit_ggca_uffc``'s `score_crops` of 12 seeded crops (padded to 32
    rows) at ``model.dtype=bfloat16``: K2's bf16 normalize feeds the folded model,
    whose weights stay fp32; the score within 3 × JAX bf16's distance from
    JAX's fp32 score + 0.01 of it (JAX's `VideoScorer` on the same weights,
    its model at ``dtype=bfloat16`` and at fp32, with the same
    ``infer.quantize``: JAX's scorer serves int8_full at the model's dtype,
    so the port's does too, its int8 layers writing bf16)."""
    from fac_fake_tpu.core.config import Config as JaxConfig
    from fac_fake_tpu.infer.predictor import VideoScorer as JaxScorer
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    name = "cvit_ggca_uffc"         # the FFTs stay fp32 in a bf16 model
    jm, v, m, hw = bf16_pair(name)

    def cfg(c, dtype):
        c.data.image_size = hw
        c.infer.batch_crops = 32
        c.infer.quantize = quantize
        c.model.dtype = dtype
        return c

    crops = np.random.default_rng(5).integers(0, 255, (12, hw, hw, 3), dtype=np.uint8)
    ref = JaxScorer(jm.clone(dtype=jnp.float32), v, cfg(JaxConfig(), "float32")).score_crops(crops)
    ref16 = JaxScorer(jm, v, cfg(JaxConfig(), "bfloat16")).score_crops(crops)
    ts = VideoScorer(m, cfg(Config(), "bfloat16"), device="cpu")
    got = ts.score_crops(crops)
    assert ts.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in ts.model.parameters())
    assert ts.model.quant_dense == (quantize == "int8_full")
    print(f"{name} {quantize}: bf16 score {got}, JAX bf16 {ref16}, JAX fp32 {ref}")
    assert 0.0 <= got <= 1.0 and abs(got - ref) <= 3 * abs(ref16 - ref) + 0.01, (got, ref16, ref)


def test_cli_train_then_predict_a_zoo_entry(tmp_path):
    """``cli/train.py --model cvit_ggca_uffc --device cpu`` for one epoch on
    a tiny crop tree (the entry's published stems at 64², a narrow
    transformer, the strong_aug chain on), then ``cli/predict.py --model
    cvit_ggca_uffc --weights best.pth`` over a directory with one noise
    mp4 (no faces: score 0.5); ``best.pth`` loads strict and records the
    model's dtype."""
    import cv2
    from fac_fake_torch.cli import predict, train
    root = _crop_tree(str(tmp_path / "crops"), n=(4, 4), size=64)
    sets = ["model.image_size=64", "model.patch_size=2", "model.dim=32", "model.depth=1",
            "model.heads=2", "model.mlp_dim=32", "data.num_workers=1", "train.log_every=0"]
    ck = str(tmp_path / "ck")
    train.main(["--model", "cvit_ggca_uffc", "--data-root", root, "--epochs", "1",
                "--batch-size", "4", "--device", "cpu", "--checkpoint-dir", ck,
                "--history", str(tmp_path / "hist.pkl"), "--set", *sets])
    best = torch.load(os.path.join(ck, "best.pth"), map_location="cpu", weights_only=False)
    assert best["dtype"] == "float32" and "uffc.locMap" in best["state_dict"]
    vdir = tmp_path / "videos"
    vdir.mkdir()
    wr = cv2.VideoWriter(str(vdir / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (96, 64))
    rng = np.random.default_rng(7)
    for _ in range(20):
        wr.write(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    wr.release()
    rows = predict.main(["--videos", str(vdir), "--weights", os.path.join(ck, "best.pth"),
                         "--model", "cvit_ggca_uffc", "--save-csv", str(tmp_path / "pred.csv"),
                         "--device", "cpu", "--workers", "1", "--set", *sets[:6]])
    assert [r[0] for r in rows] == ["clip.mp4"] and rows[0][1] == 0.5
