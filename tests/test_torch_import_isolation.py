"""The port imports torch and numpy, never JAX, flax or the JAX package."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "fac_fake_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fac_fake_tpu")


def _modules():
    out = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                out.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(out)


def test_importing_every_port_module_loads_no_jax():
    mods = _modules()
    assert "fac_fake_torch.infer.predictor" in mods and len(mods) > 15
    # the int8 serving modules (quantize_cvit; kernels K3 and K4)
    assert {"fac_fake_torch.compat.quantize", "fac_fake_torch.ops.quant"} <= set(mods)
    # the S3D scoring slice (kernels K5 and K6)
    assert {"fac_fake_torch.utils.s3d", "fac_fake_torch.models.s3d.layers",
            "fac_fake_torch.models.s3d.blocks", "fac_fake_torch.models.s3d.model",
            "fac_fake_torch.data.clips", "fac_fake_torch.evaluate.metrics",
            "fac_fake_torch.evaluate.s3d_eval", "fac_fake_torch.ops.quant3d",
            "fac_fake_torch.compat.quantize_s3d", "fac_fake_torch.core.plans",
            "fac_fake_torch.cli.evaluate"} <= set(mods)
    # the flagship cvit_repbn8's blocks
    assert {"fac_fake_torch.models.blocks.deconv", "fac_fake_torch.models.blocks.ggca"} <= set(mods)
    # CViT training (kernel K7)
    assert {"fac_fake_torch.train.losses", "fac_fake_torch.train.schedules",
            "fac_fake_torch.train.state", "fac_fake_torch.train.checkpoint",
            "fac_fake_torch.train.trainer", "fac_fake_torch.data.augment",
            "fac_fake_torch.ops.augment", "fac_fake_torch.data.folder",
            "fac_fake_torch.data.native_loader", "fac_fake_torch.cli.train"} <= set(mods)
    # MTCNN with kernel K8, and the serving CLI
    assert {"fac_fake_torch.ops.nms", "fac_fake_torch.detect.mtcnn",
            "fac_fake_torch.cli.import_mtcnn", "fac_fake_torch.cli.serve"} <= set(mods)
    # the ResNet/KAN family with kernel K9
    assert {"fac_fake_torch.ops.kan", "fac_fake_torch.models.blocks.kan",
            "fac_fake_torch.models.resnet"} <= set(mods)
    # S3D training: the JPEG step (kernel K10), face masking
    assert {"fac_fake_torch.ops.jpeg", "fac_fake_torch.data.masking"} <= set(mods)
    # evaluation, Grad-CAM, plots and profiling (the CSV evaluation in
    # evaluate.metrics, the csv/gradcam/plots subcommands in cli.evaluate,
    # cli.predict --metadata)
    assert {"fac_fake_torch.evaluate.gradcam", "fac_fake_torch.evaluate.plots",
            "fac_fake_torch.utils.profiling", "fac_fake_torch.cli.predict"} <= set(mods)
    # export: the ONNX writer and reader (the port's own copy, not JAX's
    # numpy-only one), the torch.export program, the CLI; KAN's grid
    # functions live in models.blocks.kan
    assert {"fac_fake_torch.compat.onnx_proto", "fac_fake_torch.compat.onnx_export",
            "fac_fake_torch.compat.export", "fac_fake_torch.cli.export"} <= set(mods)
    # nor what the card's machine lacks: each is imported where it draws,
    # reads or writes (cv2, matplotlib, tensorboardX) or not at all
    lacking = ("pandas", "sklearn", "matplotlib", "tensorboardX", "cv2")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + lacking!r})\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_name_no_jax_import():
    bad = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    # chip_smoke.py drives the port only
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN], mods
