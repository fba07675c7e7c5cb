"""Profiling and timing — the port of `fac_fake_tpu/utils/profiling.py`
(the reference's wall-clock prints and thop FLOP counts, SURVEY.md §5.1):

  * `trace(logdir)`: `torch.profiler` over the block (the card's kernels
    too where there is a card), written as a Chrome trace,
    ``logdir/trace.json`` (chrome://tracing or Perfetto; no tensorboard
    package needed);
  * `time_fn`: steady-state seconds a call, each call waited for by
    synchronizing the device of its output's first tensor (PyTorch returns
    before the card finishes);
  * `flops_estimate`: `torch.utils.flop_counter.FlopCounterMode` over one
    call, 2 × the multiply-adds of its convolutions and matrix products
    (XLA's cost analysis, JAX's count, counts other ops too);
  * `param_count`.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

import torch
from torch.utils import _pytree


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; its Chrome trace goes to ``logdir/trace.json``.
    Yields the `torch.profiler.profile`."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _wait(out) -> None:
    """Wait for the work that made ``out``'s first tensor."""
    for leaf in _pytree.tree_leaves(out):
        if torch.is_tensor(leaf):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> Tuple[float, float]:
    """Returns (seconds_per_call, calls_per_second)."""
    for _ in range(warmup):
        out = fn(*args)
    _wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        _wait(fn(*args))
    dt = (time.perf_counter() - t0) / iters
    return dt, 1.0 / dt


def flops_estimate(fn: Callable, *args) -> float:
    """FLOPs of one call of ``fn``: 2 × the multiply-adds of its
    convolutions and matrix products."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
