"""Where the port's entry points run.

Every entry point (`VideoScorer`, `BlazeFace`, `build_model`,
`cli/predict.py --device`) runs on the card unless the caller asks for the
CPU by name. There is no silent CPU path: without CUDA the default raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: fac_fake_torch runs on the card by "
            "default; pass device='cpu' to run on the CPU")
    return dev
