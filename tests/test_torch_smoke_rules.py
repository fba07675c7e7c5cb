"""The three check rules of `chip_smoke.py` that hold a card reading against
the CPU's own rounding, as plain functions of the numbers a run prints:
Z5's loss (`z5_loss_rule`), B4's bf16 fp head input (`b4_bf16_rule`) and
G1's CAM (`cam_rule`), each on the readings of the runs that set it (an
NVIDIA H100 80GB HBM3 at 700 W) and on readings a wrong result gives."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def test_z5_loss_rule():
    """card vs CPU ≤ 1e-4 + 3 × the CPU's distance to float64."""
    # the well-conditioned step keeps T3's bound: 1e-4 + 3 x 3.81e-6
    bound, holds = cs.z5_loss_rule(6.31e-6, 3.81e-6)
    assert bound == pytest.approx(1.1143e-4, rel=1e-4) and holds
    # cvit_ggca_add_odconv at --seed 0, the run that failed 1e-4: the CPU
    # itself 1.2e-4 from float64, so the bound is 4.6e-4
    bound, holds = cs.z5_loss_rule(3.55e-4, 1.2e-4)
    assert bound == pytest.approx(4.6e-4) and holds
    # the same card reading where the CPU sits on float64 fails, as does a
    # head weight moved by 1.28e-4 of its norm (loss 1.19e-4 apart)
    assert not cs.z5_loss_rule(3.55e-4, 1e-6)[1]
    assert not cs.z5_loss_rule(1.1869e-4, 3.81e-6)[1]
    assert cs.z5_loss_rule(8.574e-5, 3.81e-6)[1]


def test_b4_bf16_rule():
    """card vs CPU ≤ 1.5 × the CPU's bf16-vs-fp32 distance; int8 keeps 1.0."""
    assert cs.S3D_BF16_FEATURE_RATIO == 1.5 and cs.S3D_INT8_FEATURE_RATIO == 1.0
    # msca_s3d_srm at --seed 2 (1.0176, 1.02), seeds 0 and 1 (0.807, 0.977)
    for ratio in (1.0176, 1.02, 0.807, 0.977, 0.615):
        assert cs.b4_bf16_rule(ratio)
    # Z6's zoo entries read up to 1.12 by the same measure; a wrong head
    # input (ca_s3d's last branch moved by 2.56e-2 of its norm) 1.92
    assert cs.b4_bf16_rule(1.12)
    assert not cs.b4_bf16_rule(1.92) and not cs.b4_bf16_rule(1.5001)


def test_cam_rule():
    """raw ≤ 1e-4 × largest + 3 × |CPU − float64|; min-maxed ≤ 1e-3 + 3 ×
    its own."""
    # cvit_ggca_sla's feature CAM at --seed 2: card vs CPU 4.68e-7 against
    # 1e-4 x 1.78e-3; the CPU 4.48e-6 (2.5e-3 of the largest) from float64
    r = cs.cam_rule(4.68e-7, 1.78e-3, 4.48e-6, 1.11e-3, 2.5e-3)
    assert r["raw_bound"] == pytest.approx(1e-4 * 1.78e-3 + 3 * 4.48e-6)
    assert r["norm_bound"] == pytest.approx(1e-3 + 3 * 2.5e-3)
    assert r["raw_holds"] and r["norm_holds"]
    # with the CPU on float64 the old bounds stand, and that reading fails
    r = cs.cam_rule(4.68e-7, 1.78e-3, 0.0, 1.11e-3, 0.0)
    assert not r["raw_holds"] and not r["norm_holds"]
    # base cvit's feature CAM, well conditioned (the CPU 1.7e-7 from float64),
    # the last stem conv moved by 1.28e-4 of its norm: fails; moved by
    # 9.05e-5 it holds here and fails the old 1e-4 x largest
    assert not cs.cam_rule(3.844e-6, 0.02716, 1.745e-7, 2.378e-4, 1.114e-5)["raw_holds"]
    r = cs.cam_rule(2.729e-6, 0.02716, 1.745e-7, 1.721e-4, 1.114e-5)
    assert r["raw_holds"] and r["norm_holds"] and 2.729e-6 > cs.CAM_RAW_TOL * 0.02716

