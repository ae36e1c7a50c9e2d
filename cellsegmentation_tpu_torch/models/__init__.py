"""Model registry: ``build_model(name)`` constructs a seeded MILNet."""

from __future__ import annotations

from typing import Callable, Mapping

from cellsegmentation_tpu_torch.core.device import resolve_device
from cellsegmentation_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from cellsegmentation_tpu_torch.models.efficientnet import (
    EfficientNetEncoder,
    stage_depths,
)
from cellsegmentation_tpu_torch.models.milnet import MILNet, init_milnet
from cellsegmentation_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    ResNetEncoder,
)

__all__ = ["MILNet", "ResNetEncoder", "Bottleneck", "BasicBlock",
           "EfficientNetEncoder", "build_model", "init_milnet", "MODEL_NAMES",
           "encoder_stage_depths"]


def _resnet(block, sizes, policy, groups=1, base_width=64):
    return MILNet(ResNetEncoder(block, sizes, policy=policy, groups=groups,
                                base_width=base_width), policy=policy)


def _efficientnet(width, depth, policy):
    # single-Dense image heads and no seg decoder: stages 1 and 2 only
    return MILNet(EfficientNetEncoder(width, depth, policy), policy=policy,
                  image_head_style="simple", supports_segment=False)


# (width, depth) multipliers of the EfficientNets
_EFFNETS = {"efficientnet_b0": (1.0, 1.0), "efficientnet_b2": (1.1, 1.2)}

_BUILDERS: Mapping[str, Callable[[Policy], MILNet]] = {
    "resnet18": lambda p: _resnet(BasicBlock, (2, 2, 2, 2), p),
    "resnet34": lambda p: _resnet(BasicBlock, (3, 4, 6, 3), p),
    "resnet50": lambda p: _resnet(Bottleneck, (3, 4, 6, 3), p),
    # grouped 3x3s in every Bottleneck, with the expansion-4 seg decoder
    "resnext50_32x4d": lambda p: _resnet(Bottleneck, (3, 4, 6, 3), p,
                                         groups=32, base_width=4),
    "resnext101_32x8d": lambda p: _resnet(Bottleneck, (3, 4, 23, 3), p,
                                          groups=32, base_width=8),
    **{name: (lambda p, m=m: _efficientnet(*m, p)) for name, m in _EFFNETS.items()},
}

MODEL_NAMES = tuple(_BUILDERS)


def encoder_stage_depths(name: str):
    """The ``stage_depths`` of model ``name``'s encoder, without building it:
    an EfficientNet's blocks per stage, None for the ResNets."""
    if name not in _BUILDERS:
        raise KeyError(f"unknown model {name!r}; available: {MODEL_NAMES}")
    return stage_depths(_EFFNETS[name][1]) if name in _EFFNETS else None


def build_model(name: str, policy: Policy = DEFAULT_POLICY, device=None,
                seed: int = 0) -> MILNet:
    """Construct MIL model ``name`` with seeded weights, in eval mode, on
    ``device`` (the CUDA card unless ``device="cpu"`` is given)."""
    if name not in _BUILDERS:
        raise KeyError(f"unknown model {name!r}; available: {MODEL_NAMES}")
    dev = resolve_device(device)
    return init_milnet(_BUILDERS[name](policy), seed).to(dev)
