"""Run logging: one CSV per named stream, TensorBoard, stdout.

TensorBoard is optional (torch's ``SummaryWriter``, imported only when
asked for) and off whenever ``CST_DISABLE_TB`` is set.
"""

from __future__ import annotations

import csv
import os
import re
import time
from typing import Optional, Sequence


def sort_files(files: Sequence[str]) -> list[str]:
    """Natural sort by the first integer in each file's name (-1 without
    one)."""
    def key(name: str):
        m = re.search(r"\d+", os.path.basename(name))
        return int(m.group()) if m else -1

    return sorted(files, key=key)


class RunLogger:
    """Per-run logging: ``<output_dir>/<run_name>-<stream>.csv`` files, TB
    scalars under ``<output_dir>/runs/<run_name>``, and stdout."""

    def __init__(self, output_dir: str, run_name: Optional[str] = None,
                 tensorboard: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self.output_dir = output_dir
        self.run_name = run_name or time.strftime("%Y%m%d-%H%M%S")
        self._csv_files: dict[str, tuple] = {}
        self._tb = None
        if os.environ.get("CST_DISABLE_TB"):
            tensorboard = False
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard is not installed
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(
                    os.path.join(output_dir, "runs", self.run_name))

    def csv_row(self, stream: str, header: Sequence[str], row: Sequence) -> None:
        if stream not in self._csv_files:
            path = os.path.join(self.output_dir, f"{self.run_name}-{stream}.csv")
            f = open(path, "a", newline="")
            w = csv.writer(f)
            if f.tell() == 0:
                w.writerow(header)
            self._csv_files[stream] = (f, w)
        f, w = self._csv_files[stream]
        w.writerow(row)
        f.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def scalars(self, values: dict[str, float], step: int) -> None:
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def info(self, msg: str) -> None:
        print(msg, flush=True)

    def close(self) -> None:
        for f, _ in self._csv_files.values():
            f.close()
        self._csv_files.clear()
        if self._tb is not None:
            self._tb.close()
            self._tb = None
