"""Program export — the port of `fac_fake_tpu/compat/export.py`.

JAX serializes its jitted eval forward as StableHLO (`jax.export`), with the
variables as an argument and a fixed input shape. The port's counterpart is
`torch.export`: the eval forward of the model at a fixed input shape, its
parameters and buffers inside the `ExportedProgram`, saved with
`torch.export.save`. The input is the ImageNet-normalized fp32 NCHW batch
the model's ``forward`` takes (K2's output on the card). An orbax weights
checkpoint has no meaning here: the port's weights file is the
reference-layout ``.pth`` (`compat/weights.py export_state_dict`).
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch
from torch import nn


def export_program(model: nn.Module, input_shape: Tuple[int, ...],
                   path: Optional[str] = None) -> torch.export.ExportedProgram:
    """`torch.export.export` of ``model``'s eval forward at ``input_shape``
    (fp32 NCHW, in ``channels_last`` memory as K2 writes it), on the model's
    device; saved to ``path`` with `torch.export.save` where one is given.
    Returns the program."""
    dev = next(model.parameters()).device
    was = model.training
    model.eval()
    try:
        x = torch.zeros(input_shape, device=dev).contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            program = torch.export.export(model, (x,))
    finally:
        model.train(was)
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.export.save(program, path)
    return program


def load_program(path: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """A saved program as a callable ``x -> logits``, its weights on the
    device it was exported on."""
    return torch.export.load(path).module()
