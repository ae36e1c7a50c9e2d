"""Profiling hooks over ``torch.profiler``.

    from cellsegmentation_tpu_torch.utils.profiling import trace
    with trace("./output/profile"):   # a no-op unless CST_PROFILE is set
        ... steps ...

``CST_PROFILE=1`` (or ``force=True``) records the region (CPU ops, and the
card's kernels when CUDA is available) and writes it as a Chrome trace
JSON file under ``log_dir``; ``annotate`` names a span inside a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


def profiling_enabled() -> bool:
    return os.environ.get("CST_PROFILE", "") not in ("", "0")


@contextlib.contextmanager
def trace(log_dir: str, force: bool = False) -> Iterator[None]:
    """A torch.profiler trace of the region, written to
    ``<log_dir>/trace_<pid>_<ms>.json`` when it ends (gated by
    CST_PROFILE unless ``force``)."""
    if not (force or profiling_enabled()):
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        name = f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span that shows in a profiler trace."""
    with torch.profiler.record_function(name):
        yield
