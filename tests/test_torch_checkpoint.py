"""The port's checkpoints, crop-folder data and training CLI
(`fac_fake_torch/train/checkpoint.py`, `data/folder.py`,
`data/native_loader.py`, `cli/train.py`) on the CPU: a save round trip,
the best snapshot on disk, the asynchronous writer, a SIGKILLed training
process that resumes from its last finished save, the dataset on a
cv2-written JPEG tree, and ``python -m fac_fake_torch.cli.train`` whose
best checkpoint loads in `cli/predict.py`."""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(patch_size=1, dim=32, depth=1, heads=2, mlp_dim=32)


def _tiny_trainer(ckpt_dir="", every=0, epochs=3):
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.cvit import CViT
    from fac_fake_torch.train.trainer import Trainer
    spec = ()
    for _ in range(5):
        spec += (("conv", 8), ("bn", 8), ("relu",), ("pool",))
    cfg = Config()
    cfg.data.image_size = 32
    cfg.data.augment.enabled = False
    cfg.train.epochs = epochs
    cfg.train.log_every = 0
    cfg.train.checkpoint_every = every
    cfg.train.checkpoint_dir = ckpt_dir
    m = init_weights(CViT(spec, image_size=32, pos_mode="patch", **SMALL), 0)
    return Trainer(m, cfg, device="cpu")


def _state(tr):
    return ({k: v.clone() for k, v in tr.model.state_dict().items()},
            {k: tr.optimizer.state[p]["exp_avg"].clone() for k, p in tr.model.named_parameters()
             if p in tr.optimizer.state})


def _equal(a, b):
    assert a[0].keys() == b[0].keys() and a[1].keys() == b[1].keys()
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k]), k


def _trained(tr, steps=2):
    from helpers import synthetic_batches
    for b in synthetic_batches(steps, 8, image_size=32):
        tr.train_step({"image": torch.from_numpy(b["image"]),
                       "label": torch.from_numpy(b["label"]).long(),
                       "mask": torch.from_numpy(b["mask"])}, torch.Generator().manual_seed(0))
    return tr


def test_save_restore_round_trip(tmp_path):
    """Model (parameters, running stats), Adam state and step come back bit
    for bit; `latest_epoch` names the newest save; no temporary file stays."""
    from fac_fake_torch.train.checkpoint import (latest_epoch, restore_checkpoint,
                                                 save_checkpoint)
    tr = _trained(_tiny_trainer())
    d = str(tmp_path / "ck")
    assert latest_epoch(d) is None
    save_checkpoint(d, tr.model, tr.optimizer, tr.step, 0)
    _trained(tr, 1)
    save_checkpoint(d, tr.model, tr.optimizer, tr.step, 1)
    want = _state(tr)
    assert latest_epoch(d) == 1 and sorted(os.listdir(d)) == ["epoch_000000.pt",
                                                              "epoch_000001.pt"]
    fresh = _tiny_trainer()
    fresh.init_state(seed=5)
    assert restore_checkpoint(d, fresh.model, fresh.optimizer) == 3
    _equal(_state(fresh), want)


def test_async_writer_saves_and_drains(tmp_path):
    """`CheckpointWriter.save` snapshots at the call (training on after it
    does not change what is written) and `close` drains the writes."""
    from fac_fake_torch.train.checkpoint import CheckpointWriter, latest_epoch, restore_checkpoint
    tr = _trained(_tiny_trainer())
    d = str(tmp_path / "ck")
    with CheckpointWriter(d) as w:
        w.save(tr.model, tr.optimizer, tr.step, 0)
        want = _state(tr)
        _trained(tr, 1)                      # moves the live state on
        w.save(tr.model, tr.optimizer, tr.step, 1)
        w.wait()
        assert w.latest() == 1
    assert latest_epoch(d) == 1
    fresh = _tiny_trainer()
    assert restore_checkpoint(d, fresh.model, fresh.optimizer, epoch=0) == 2
    _equal(_state(fresh), want)


def test_fit_writes_periodic_and_best_checkpoints(tmp_path):
    """`fit` with checkpoint_every=1: one restorable save an epoch, drained
    before it returns; ``best.pth`` holds the best epoch's model, loads
    strict, and its state dict alone is what `cli/predict.py` reads."""
    from helpers import synthetic_batches
    from fac_fake_torch.compat.weights import load_reference_pth
    from fac_fake_torch.train.checkpoint import BEST, latest_epoch, restore_best
    d = str(tmp_path / "ck")
    tr = _tiny_trainer(d, every=1)
    batches = synthetic_batches(2, 8, image_size=32)
    out = tr.fit(lambda e: iter(batches))
    assert latest_epoch(d) == 2 and os.path.exists(os.path.join(d, BEST))
    fresh = _tiny_trainer()
    restore_best(d, fresh.model, fresh.optimizer)
    best = out["best"]["state_dict"]
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, best[k]), k
    sd = load_reference_pth(os.path.join(d, BEST))
    fresh.model.load_state_dict(sd, strict=True)


_KILL_SCRIPT = r"""
import os, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, os.path.join({repo!r}, "tests"))
import torch
torch.set_num_threads(1)
from test_torch_checkpoint import _tiny_trainer
from helpers import synthetic_batches
tr = _tiny_trainer(sys.argv[1], every=1, epochs=500)
batches = synthetic_batches(2, 8, image_size=32)
tr.fit(lambda e: iter(batches))
"""


def test_sigkill_mid_training_resumes_from_the_last_finished_save(tmp_path):
    """SIGKILL a process that checkpoints every epoch: the directory names
    only finished saves, the newest loads, and training resumes from it."""
    from helpers import synthetic_batches
    from fac_fake_torch.train.checkpoint import latest_epoch, restore_checkpoint
    d = str(tmp_path / "ck")
    script = tmp_path / "train.py"
    script.write_text(_KILL_SCRIPT.format(repo=REPO))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, str(script), d], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and (latest_epoch(d) or 0) < 3:
            if proc.poll() is not None:
                raise AssertionError(proc.stderr.read().decode()[-2000:])
            time.sleep(0.05)
        assert (latest_epoch(d) or 0) >= 3, "no checkpoints within 120 s"
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    ep = latest_epoch(d)
    tr = _tiny_trainer(d, every=1, epochs=ep + 2)
    assert restore_checkpoint(d, tr.model, tr.optimizer) == 2 * (ep + 1)
    tr.step = 2 * (ep + 1)
    batches = synthetic_batches(2, 8, image_size=32)
    out = tr.fit(lambda e: iter(batches), start_epoch=ep + 1)
    assert len(out["history"]["train_loss"]) == 1 and latest_epoch(d) == ep + 1
    # a write the kill cut short is at most a stray temporary file; every
    # file under a checkpoint's name loads
    names = [f for f in os.listdir(d) if not f.endswith(".tmp")]
    assert all(f.startswith("epoch_") or f == "best.pth" for f in names), names
    for f in names:
        torch.load(os.path.join(d, f), map_location="cpu", weights_only=True)


def _crop_tree(root, n=(3, 5), size=32):
    """{train,validation,test}/{fake,real} JPEGs written with cv2."""
    import cv2
    rng = np.random.default_rng(0)
    for split in ("train", "validation", "test"):
        for cls, count in zip(("fake", "real"), n):
            os.makedirs(os.path.join(root, split, cls))
            for i in range(count):
                img = np.full((size, size, 3), 60 if cls == "fake" else 190, np.uint8)
                img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)
                cv2.imwrite(os.path.join(root, split, cls, f"{i}.jpg"), img)
    return root


@pytest.mark.parametrize("native", [False, True])
def test_crop_folder_dataset(tmp_path, native):
    """Classes alphabetical (label 0 = fake), a shuffled train epoch of whole
    batches, the eval tail zero-padded and masked; the native decoder (where
    it builds) decodes as cv2 does."""
    import cv2
    from fac_fake_torch.data import native_loader
    from fac_fake_torch.data.folder import CropFolderDataset, build_session
    if native and not native_loader.available():
        pytest.skip("the native decoder does not build here (no g++ or libjpeg)")
    root = _crop_tree(str(tmp_path / "crops"))
    ds = CropFolderDataset(os.path.join(root, "train"), 32, use_native=native)
    assert ds.classes == ["fake", "real"] and len(ds) == 8
    assert [lbl for _, lbl in ds.samples] == [0] * 3 + [1] * 5
    train = list(ds.batches(3, shuffle=True, seed=4, epoch=0, num_workers=2))
    assert len(train) == 2 and all(b["mask"].all() for b in train)
    ev = list(ds.batches(3, shuffle=False, drop_last=False, num_workers=2))
    assert [b["image"].shape for b in ev] == [(3, 32, 32, 3)] * 3
    assert ev[-1]["mask"].tolist() == [1.0, 1.0, 0.0] and not ev[-1]["image"][2].any()
    first = cv2.cvtColor(cv2.imread(ds.samples[0][0]), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(ev[0]["image"][0], first)
    assert sorted(build_session(root, 32)) == ["test", "train", "validation"]


def test_native_loader_builds_outside_the_jax_package():
    from fac_fake_torch.data import native_loader
    assert native_loader.SRC.parent.parent.name == "fac_fake_torch"
    assert native_loader.BUILD_DIR.parts[-2:] == ("build", "fac_fake_torch_native")


def test_cli_train_then_predict_loads_the_best_checkpoint(tmp_path):
    """``python -m fac_fake_torch.cli.train`` at tiny widths on the CPU (the
    strong_aug chain on, one epoch, the test split at the end); its
    ``best.pth`` loads strict in `cli/predict.py`. Without ``--device`` and
    without CUDA, the CLI raises; ``--clips-root`` (S3D clips) with a CViT
    model is refused."""
    root = _crop_tree(str(tmp_path / "crops"), n=(4, 4))
    sets = ["model.image_size=32", "model.patch_size=1", "model.dim=32", "model.depth=1",
            "model.heads=2", "model.mlp_dim=32", "data.num_workers=1", "train.log_every=0"]
    ck = str(tmp_path / "ck")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run(
        [sys.executable, "-m", "fac_fake_torch.cli.train", "--model", "cvit", "--data-root", root,
         "--epochs", "1", "--batch-size", "4", "--device", "cpu", "--checkpoint-dir", ck,
         "--history", str(tmp_path / "hist.pkl"), "--set", *sets],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert "test split: loss" in res.stdout and "epoch 0:" in res.stdout
    assert os.path.exists(os.path.join(ck, "best.pth"))
    assert open(str(tmp_path / "hist.pkl.csv")).readline().startswith("train_loss,train_acc")
    from fac_fake_torch.cli import predict
    videos = tmp_path / "videos"
    videos.mkdir()
    rows = predict.main(["--videos", str(videos), "--weights", os.path.join(ck, "best.pth"),
                         "--device", "cpu", "--save-csv", str(tmp_path / "out.csv"),
                         "--set", *sets[:6]])
    assert rows == []
    if not torch.cuda.is_available():
        from fac_fake_torch.cli import train
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(["--data-root", root, "--set", *sets])
    with pytest.raises(SystemExit, match="S3D"):
        from fac_fake_torch.cli import train
        train.main(["--clips-root", root, "--device", "cpu"])
