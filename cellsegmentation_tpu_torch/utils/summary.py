"""Model summary: parameter counts per partition.

    python -m cellsegmentation_tpu_torch.utils.summary resnet50
"""

from __future__ import annotations

import torch


def count_params(module: torch.nn.Module) -> int:
    """The number of parameter entries of ``module`` (BatchNorm statistics
    are buffers, not counted)."""
    return sum(p.numel() for p in module.parameters())


def summary(model_name: str = "resnet50") -> dict[str, int]:
    """{partition: parameter count, ..., "TOTAL": sum} of the named model
    (encoder, the tile and image heads, and the seg decoder where the
    encoder has one), built on the meta device: shapes only, no memory."""
    from cellsegmentation_tpu_torch.models import build_model

    model = build_model(model_name, device="meta")
    counts = {name: count_params(child) for name, child in model.named_children()
              if any(True for _ in child.parameters())}
    counts["TOTAL"] = sum(counts.values())
    return counts


if __name__ == "__main__":
    import sys

    name = sys.argv[1] if len(sys.argv) > 1 else "resnet50"
    for part, n in summary(name).items():
        print(f"{part:>16}: {n:>12,}")
