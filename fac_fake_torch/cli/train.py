"""Training CLI — the port of `fac_fake_tpu/cli/train.py` for the CViT family
on crop folders.

  python -m fac_fake_torch.cli.train --model cvit --data-root crops/ \
      --epochs 50 --set train.optim.lr=1e-4 [--device cpu]

``--data-root`` holds ``{train,validation,test}/{fake,real}`` crops (label 0
= fake); after training, the test split (if any) is evaluated once
(`cvit_train.py:214-233`). The best checkpoint, ``<checkpoint-dir>/best.pth``,
loads in `cli/predict.py --weights`. Runs on the card unless ``--device cpu``.
The S3D path (``--plan``, ``--clips-root``, S3D models) is ROADMAP queue 1
item 13.
"""
from __future__ import annotations

import argparse

_S3D = "S3D training is ROADMAP queue 1 item 13"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default=None, help="registry model name")
    ap.add_argument("--config", default=None, help="YAML config overlay (needs PyYAML)")
    ap.add_argument("--plan", default=None, help="reference-schema S3D plan YAML")
    ap.add_argument("--data-root", default=None,
                    help="ImageFolder-style crop root ({split}/{fake,real})")
    ap.add_argument("--clips-root", default=None, help="per-video crop folders (S3D clips)")
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


def main(argv=None):
    args = parse_args(argv)
    if args.plan or args.clips_root:
        raise NotImplementedError(f"--plan / --clips-root: {_S3D}")

    from fac_fake_torch.core.config import Config, apply_dotted, load_yaml
    from fac_fake_torch.data.folder import build_session
    from fac_fake_torch.models import build_model
    from fac_fake_torch.train.trainer import Trainer

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
    if cfg.model.name.endswith("s3d"):
        raise NotImplementedError(f"--model {cfg.model.name}: {_S3D}")
    if not args.data_root:
        raise SystemExit("--data-root is required")

    session = build_session(args.data_root, cfg.model.image_size)
    if "train" not in session:
        raise SystemExit(f"--data-root {args.data_root}: no train/ split")
    model = build_model(cfg.model, device=args.device, seed=cfg.train.seed)
    trainer = Trainer(model, cfg, device=args.device)
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

    d = cfg.data
    train_fn = lambda e: session["train"].batches(d.batch_size, epoch=e, seed=d.shuffle_seed,
                                                  num_workers=d.num_workers)
    val_fn = None
    if "validation" in session and len(session["validation"]):
        val_fn = lambda e: session["validation"].batches(
            d.batch_size, shuffle=False, drop_last=False, num_workers=d.num_workers)
    out = trainer.fit(train_fn, val_fn, start_epoch=start_epoch)
    if args.history:
        Trainer.save_history(out["history"], args.history)
    print(f"best val acc: {out['history'].get('best_acc')}")

    if "test" in session and len(session["test"]):      # cvit_train.py:214-233
        te = trainer.evaluate(session["test"].batches(
            d.batch_size, shuffle=False, drop_last=False, num_workers=d.num_workers))
        print(f"test split: loss {te['loss']:.4f} acc {te['acc']:.4f}")
        out["test"] = te
    return out


if __name__ == "__main__":
    main()
