"""Training CLI — the port of `fac_fake_tpu/cli/train.py`:

  python -m fac_fake_torch.cli.train --model cvit --data-root crops/ \
      --epochs 50 --set train.optim.lr=1e-4 [--device cpu]
  python -m fac_fake_torch.cli.train --plan configs/plan1_2.yaml \
      --clips-root clips/ --metadata meta.json [--device cpu]

``--data-root`` holds ``{train,validation,test}/{fake,real}`` crops (label 0
= fake); after training, the test split (if any) is evaluated once
(`cvit_train.py:214-233`). The best checkpoint, ``<checkpoint-dir>/best.pth``,
loads in `cli/predict.py --weights`.

``--plan`` (the reference's S3D plan YAML, `core/plans.py`) or an S3D model
with ``--clips-root`` trains the S3D family on per-video crop folders
(label 1 = fake): raw 0-255 inputs, ``bce_weighted`` with ``pos_weight`` =
#real/#fake × rebalancing_real / rebalancing_fake, the plan's masking and
augmentation. Validation reads ``--val-clips-root``, or holds out one
video in seven of ``--clips-root``, with masking off. Its ``best.pth``
scores through ``python -m fac_fake_torch.cli.evaluate s3d --checkpoint``.

Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default=None, help="registry model name")
    ap.add_argument("--config", default=None, help="YAML config overlay (needs PyYAML)")
    ap.add_argument("--plan", default=None, help="reference-schema S3D plan YAML")
    ap.add_argument("--data-root", default=None,
                    help="ImageFolder-style crop root ({split}/{fake,real})")
    ap.add_argument("--clips-root", default=None, help="per-video crop folders (S3D clips)")
    ap.add_argument("--metadata", default=None, help="metadata.json for the clips")
    ap.add_argument("--val-clips-root", default=None,
                    help="held-out clips root for validation (S3D); when omitted, one "
                         "video in seven of --clips-root is held out")
    ap.add_argument("--val-metadata", default=None, help="metadata.json for --val-clips-root")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--warm-start", default=None, help="reference torch .pth to warm start from")
    ap.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--history", default=None, help="history pickle path (and its .csv)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; there is no silent CPU path")
    ap.add_argument("--set", nargs="*", default=[],
                    help="dotted overrides, e.g. train.optim.lr=1e-3")
    return ap.parse_args(argv)


def clip_session(cfg, args) -> tuple:
    """The S3D train and validation batch functions and the loss kwargs
    (JAX `cli/train.py:62-124`)."""
    from fac_fake_torch.data.clips import ClipDataset, discover_video_folders

    cfg.data.normalize = "raw255"
    cfg.train.loss = "bce_weighted"
    samples = discover_video_folders(args.clips_root, args.metadata)
    if args.val_clips_root:
        val_samples = discover_video_folders(args.val_clips_root, args.val_metadata)
    elif len(samples) >= 7:         # one video in seven held out
        val_samples = samples[::7]
        held = set(id(s) for s in val_samples)
        samples = [s for s in samples if id(s) not in held]
    else:
        val_samples = []
    d = cfg.data
    ds_kw = dict(frames_per_video=d.frames_per_video, image_size=cfg.model.image_size,
                 mask_method=d.mask_method, mask_number=d.mask_number,
                 gray=d.picture_color == "gray", device=args.device)
    ds = ClipDataset(samples, **ds_kw)
    loss_kwargs = {}
    if cfg.train.rebalance_pos_weight:
        loss_kwargs["pos_weight"] = ds.pos_weight() * cfg.train.rebalance_real / max(
            cfg.train.rebalance_fake, 1e-8)
    train_fn = lambda e: ds.batches(d.batch_size, epoch=e, num_workers=d.num_workers)
    val_fn = None
    if val_samples:
        # validation keeps masking off (clean frames, `deepfakes_dataset.py:50-65`)
        val_ds = ClipDataset(val_samples, **{**ds_kw, "mask_method": "none"})
        val_fn = lambda e: val_ds.batches(d.batch_size, shuffle=False, drop_last=False,
                                          num_workers=d.num_workers)
    return train_fn, val_fn, loss_kwargs


def main(argv=None):
    args = parse_args(argv)

    from fac_fake_torch.core.config import Config, apply_dotted, load_yaml
    from fac_fake_torch.models import build_model
    from fac_fake_torch.train.trainer import Trainer

    if args.plan:
        from fac_fake_torch.core.plans import load_plan
        cfg = load_plan(args.plan)
    else:
        cfg = Config()
    if args.config:
        load_yaml(cfg, args.config)
    if args.model:
        cfg.model.name = args.model
    if args.epochs is not None:
        cfg.train.epochs = args.epochs
    if args.batch_size is not None:
        cfg.data.batch_size = args.batch_size
    cfg.train.checkpoint_dir = args.checkpoint_dir
    apply_dotted(cfg, args.set)

    is_clip = "s3d" in cfg.model.name
    if bool(args.clips_root) != is_clip:
        raise SystemExit(f"--clips-root trains the S3D family and --data-root the others; "
                         f"got model {cfg.model.name!r}"
                         + (" with --clips-root" if args.clips_root else " without --clips-root"))
    loss_kwargs, session = {}, {}
    if is_clip:
        train_fn, val_fn, loss_kwargs = clip_session(cfg, args)
    else:
        from fac_fake_torch.data.folder import build_session
        if not args.data_root:
            raise SystemExit("--data-root is required")
        session = build_session(args.data_root, cfg.model.image_size)
        if "train" not in session:
            raise SystemExit(f"--data-root {args.data_root}: no train/ split")
        d = cfg.data
        train_fn = lambda e: session["train"].batches(
            d.batch_size, epoch=e, seed=d.shuffle_seed, num_workers=d.num_workers)
        val_fn = None
        if "validation" in session and len(session["validation"]):
            val_fn = lambda e: session["validation"].batches(
                d.batch_size, shuffle=False, drop_last=False, num_workers=d.num_workers)
    model = build_model(cfg.model, device=args.device, seed=cfg.train.seed)
    trainer = Trainer(model, cfg, device=args.device, loss_kwargs=loss_kwargs)
    if args.warm_start:
        trainer.load_warm_start(args.warm_start)
    start_epoch = 0
    if args.resume:
        from fac_fake_torch.train.checkpoint import latest_epoch, restore_checkpoint
        ep = latest_epoch(args.resume)
        if ep is not None:
            trainer.step = restore_checkpoint(args.resume, trainer.model, trainer.optimizer, ep)
            start_epoch = ep + 1
            print(f"resumed from epoch {ep}")

    out = trainer.fit(train_fn, val_fn, start_epoch=start_epoch)
    if args.history:
        Trainer.save_history(out["history"], args.history)
    print(f"best val acc: {out['history'].get('best_acc')}")

    if "test" in session and len(session["test"]):      # cvit_train.py:214-233
        d = cfg.data
        te = trainer.evaluate(session["test"].batches(
            d.batch_size, shuffle=False, drop_last=False, num_workers=d.num_workers))
        print(f"test split: loss {te['loss']:.4f} acc {te['acc']:.4f}")
        out["test"] = te
    return out


if __name__ == "__main__":
    main()
