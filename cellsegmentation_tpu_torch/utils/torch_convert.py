"""Reference and torchvision weights -> the port's checkpoints.

The reference reaches QWK 0.93 from torchvision ImageNet checkpoints, and
its trained checkpoints are torch files. No file is downloaded: the
converter runs on a locally provided ``.pth``:

    python -m cellsegmentation_tpu_torch.utils.torch_convert resnet50 \
        resnet50-19c8e357.pth out.ckpt
    python -m cellsegmentation_tpu_torch.cli.train_image -E resnet50 -r out.ckpt ...

    python -m cellsegmentation_tpu_torch.utils.torch_convert auto \
        pt2_30epochs.pth out.ckpt

Two inputs, told apart by their content:

1. A torchvision ImageNet state dict. Its key schema (names and shapes) is
   checked against ``torchvision_key_schema`` first, and every missing key,
   extra key and wrong shape is listed (with a wrong-arch hint when the file
   matches a sibling arch). ``fc.*``, the ImageNet classifier, is dropped;
   the result is an ``"image"`` checkpoint holding the encoder only, which
   ``train_image -r`` loads, its heads starting fresh.
2. A trained reference checkpoint, the dict the reference's save_model
   writes (``{mode, epoch, state_dict, encoder, ...}``): the whole MILNet,
   heads and seg decoder included; ``auto`` reads the arch from its
   ``encoder`` field.

Names: the port's modules carry the reference's and torchvision's names
under two prefixes (models/milnet.py): the flat encoder keys (``conv1``,
``bn1``, ``layer<s>.<b>.*``) go under ``encoder.``, the decoder's
``upconv<k>.*`` and ``seg_out_conv.*`` under ``seg_decoder.``, and the heads
keep theirs. The conv bias of ``upconv<k>.0`` folds into its BatchNorm's
running mean as it loads (models/common.py ``UpConv``). EfficientNet is not
in ``_ARCHS``, as in the JAX package's converter.
"""

from __future__ import annotations

import sys
from typing import Mapping

import numpy as np

_ARCHS = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnext50_32x4d": ((3, 4, 6, 3), True),
    "resnext101_32x8d": ((3, 4, 23, 3), True),
}

# (groups, width_per_group) — torchvision's Bottleneck width parameters
_GROUPS = {
    "resnet18": (1, 64),
    "resnet34": (1, 64),
    "resnet50": (1, 64),
    "resnext50_32x4d": (32, 4),
    "resnext101_32x8d": (32, 8),
}

ENCODER_TOPS = ("conv1", "bn1")
DECODER_TOPS = ("seg_out_conv",)


def torchvision_key_schema(arch: str) -> dict:
    """Expected torchvision state-dict schema for ``arch``: key -> shape.

    Derived from torchvision's ResNet/ResNeXt constructor arithmetic.
    ``num_batches_tracked`` keys are accepted but not listed (value-free);
    ``fc.*`` is the ImageNet classifier the conversion drops."""
    stage_sizes, bottleneck = _ARCHS[arch]
    groups, base_width = _GROUPS[arch]
    exp = 4 if bottleneck else 1
    schema: dict = {"conv1.weight": (64, 3, 7, 7)}

    def bn(prefix: str, c: int) -> None:
        for suffix in ("weight", "bias", "running_mean", "running_var"):
            schema[f"{prefix}.{suffix}"] = (c,)

    bn("bn1", 64)
    inplanes = 64
    for stage, blocks in enumerate(stage_sizes, start=1):
        planes = 64 * 2 ** (stage - 1)
        width = int(planes * base_width / 64) * groups
        for b in range(blocks):
            p = f"layer{stage}.{b}"
            if bottleneck:
                schema[f"{p}.conv1.weight"] = (width, inplanes, 1, 1)
                bn(f"{p}.bn1", width)
                schema[f"{p}.conv2.weight"] = (width, width // groups, 3, 3)
                bn(f"{p}.bn2", width)
                schema[f"{p}.conv3.weight"] = (planes * exp, width, 1, 1)
                bn(f"{p}.bn3", planes * exp)
            else:
                schema[f"{p}.conv1.weight"] = (planes, inplanes, 3, 3)
                bn(f"{p}.bn1", planes)
                schema[f"{p}.conv2.weight"] = (planes, planes, 3, 3)
                bn(f"{p}.bn2", planes)
            if b == 0 and (stage > 1 or inplanes != planes * exp):
                schema[f"{p}.downsample.0.weight"] = (planes * exp, inplanes, 1, 1)
                bn(f"{p}.downsample.1", planes * exp)
            inplanes = planes * exp
    schema["fc.weight"] = (1000, 512 * exp)
    schema["fc.bias"] = (1000,)
    return schema


def _shape(v) -> tuple:
    return tuple(v.shape) if hasattr(v, "shape") else tuple(np.asarray(v).shape)


def validate_torchvision_state_dict(arch: str, sd: Mapping) -> list[str]:
    """Schema check before conversion: a list of human-readable problems
    (missing keys, unexpected keys, wrong shapes), empty when clean, in the
    JAX package's words. A wrong-arch file fails loudly here instead of
    with an opaque KeyError mid-conversion."""
    schema = torchvision_key_schema(arch)
    problems = []
    missing = sorted(k for k in schema if k not in sd)
    extra = sorted(
        k for k in sd
        if k not in schema and not k.endswith("num_batches_tracked")
    )
    if missing:
        problems.append(
            f"{len(missing)} expected key(s) missing for {arch}: "
            + ", ".join(missing[:8]) + ("..." if len(missing) > 8 else "")
        )
    if extra:
        problems.append(
            f"{len(extra)} unexpected key(s): "
            + ", ".join(extra[:8]) + ("..." if len(extra) > 8 else "")
        )
    shape_mismatches = [
        (k, _shape(sd[k]), want)
        for k, want in schema.items()
        if k in sd and _shape(sd[k]) != want
    ]
    if missing or extra or shape_mismatches:
        sd_keys = {k for k in sd if not k.endswith("num_batches_tracked")}
        for other in _ARCHS:
            if other == arch:
                continue
            osch = torchvision_key_schema(other)
            if set(osch) == sd_keys and all(
                _shape(sd[k]) == want for k, want in osch.items()
            ):
                problems.append(
                    f"hint: the file matches torchvision {other!r} — "
                    f"wrong --arch?"
                )
                break
    for k, got, want in shape_mismatches:
        problems.append(f"shape mismatch {k}: got {got}, want {want}")
    return problems


def is_reference_layout(sd: Mapping) -> bool:
    """A state dict in the reference's (and torchvision's) flat layout: its
    encoder keys carry no ``encoder.`` prefix."""
    return "conv1.weight" in sd or any(k.startswith("layer1.") for k in sd)


def reference_to_port(sd: Mapping) -> dict:
    """A reference MILNet (or torchvision) ``state_dict`` on the port's
    names: the flat encoder keys under ``encoder.``, ``upconv<k>.*`` and
    ``seg_out_conv.*`` under ``seg_decoder.``, every other key (the heads;
    torchvision's ``fc``) as it is."""
    out = {}
    for k, v in sd.items():
        top = k.split(".", 1)[0]
        if top in ENCODER_TOPS or top.startswith("layer"):
            k = f"encoder.{k}"
        elif top in DECODER_TOPS or top.startswith("upconv"):
            k = f"seg_decoder.{k}"
        out[k] = v
    return out


def _tensors(sd: Mapping) -> dict:
    import torch

    return {k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            for k, v in sd.items()}


def load_torchvision_encoder(model, sd: Mapping, arch: str):
    """A torchvision ImageNet state dict into ``model``'s encoder, in place:
    checked against ``arch``'s schema first (raises listing every problem),
    ``fc.*`` dropped, only ``encoder.*`` filled. Returns the model."""
    from cellsegmentation_tpu_torch.train.checkpoint import restore_into

    problems = validate_torchvision_state_dict(arch, sd)
    if problems:
        raise ValueError(f"the state dict does not match the torchvision {arch} "
                         "schema:\n  - " + "\n  - ".join(problems))
    encoder = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    return restore_into(model, {"state_dict": _tensors(encoder)}, ("encoder",))


def convert_checkpoint(arch: str, in_path: str, out_path: str) -> str:
    """Write the port's checkpoint (train/checkpoint.py format) of a torch
    file: a reference checkpoint (``arch`` may be ``"auto"``: its
    ``encoder`` field) gives its mode's checkpoint of the whole model; a
    torchvision state dict gives an ``"image"`` checkpoint of the encoder
    alone. Loaded through a model built on the CPU, so every entry is
    checked against the port's names and shapes. Returns the path."""
    import torch

    from cellsegmentation_tpu_torch.models import build_model
    from cellsegmentation_tpu_torch.train.checkpoint import restore_into, save_checkpoint

    obj = torch.load(in_path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        arch = obj.get("encoder") if arch == "auto" else arch
        if arch not in _ARCHS:
            raise ValueError(f"unsupported or missing encoder {arch!r} "
                             f"(choices: {sorted(_ARCHS)})")
        model = restore_into(build_model(arch, device="cpu"),
                             {"state_dict": _tensors(obj["state_dict"])})
        return save_checkpoint(
            out_path, obj.get("mode", "image"), int(obj.get("epoch", 0)), arch,
            model.state_dict(),
            extra={"source": in_path, "ported": "reference-milnet"})
    if arch == "auto":
        raise ValueError("arch 'auto' only applies to reference checkpoints "
                         "(dict with a 'state_dict' key); name the torchvision arch")
    model = load_torchvision_encoder(build_model(arch, device="cpu"), obj, arch)
    encoder = {k: v for k, v in model.state_dict().items() if k.startswith("encoder.")}
    return save_checkpoint(out_path, "image", 0, arch, encoder,
                           extra={"source": in_path, "pretrained": "imagenet"})


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("arch", choices=sorted(_ARCHS) + ["auto"],
                        help="encoder architecture ('auto' reads it from a "
                             "reference checkpoint's 'encoder' field)")
    parser.add_argument("torch_path", help="input .pth")
    parser.add_argument("out_path", help="output .ckpt")
    args = parser.parse_args(argv)
    try:
        path = convert_checkpoint(args.arch, args.torch_path, args.out_path)
    except ValueError as e:
        print(f"{args.torch_path}: {e}", file=sys.stderr)
        sys.exit(2)
    print(f"converted {args.torch_path} -> {path}")


if __name__ == "__main__":
    main()
