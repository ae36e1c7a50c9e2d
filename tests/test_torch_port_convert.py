"""The port's reference-weight loader held against the JAX package's
converter (``cellsegmentation_tpu/utils/torch_convert.py``).

No weight file is needed: for each of the five ResNet-family archs the
tests build schema-shaped random state dicts with numpy (seeded), in the
reference's flat MILNet layout and in torchvision's, load them through the
port, and hold every resulting entry bit-equal to the JAX converter's
output carried through the weight bridge (``utils/jax_weights.py``). The
schema validator's messages are the JAX validator's, word for word. A load
never drops weights silently: a file that fills no entry of a requested
partition, or holds an entry that lands nowhere, raises and names it.
"""

from __future__ import annotations

import argparse

import numpy as np
import pytest
import torch

from cellsegmentation_tpu.utils import torch_convert as jtc

from cellsegmentation_tpu_torch.cli import common
from cellsegmentation_tpu_torch.models import BasicBlock, MILNet, ResNetEncoder, build_model
from cellsegmentation_tpu_torch.models.milnet import init_milnet
from cellsegmentation_tpu_torch.train import checkpoint as tckpt
from cellsegmentation_tpu_torch.utils import jax_weights
from cellsegmentation_tpu_torch.utils import torch_convert as tc

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)

ARCHS = sorted(jtc._ARCHS)


def _random(shape, key: str, rng) -> np.ndarray:
    if key.endswith("running_var"):
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    return rng.standard_normal(shape, dtype=np.float32)


def _torchvision_sd(arch: str, seed: int = 0) -> dict:
    """A torchvision ImageNet state dict of ``arch``'s schema, random, with
    its ``num_batches_tracked`` counters."""
    rng = np.random.default_rng(seed)
    sd = {k: _random(shape, k, rng) for k, shape in tc.torchvision_key_schema(arch).items()}
    for k in [k for k in sd if k.endswith("running_mean")]:
        sd[k.replace("running_mean", "num_batches_tracked")] = np.asarray(7, np.int64)
    return sd


def _reference_sd(arch: str, model, seed: int = 1) -> dict:
    """A reference MILNet state dict: torchvision's encoder keys (no ``fc``)
    plus the heads and the decoder at the reference's flat names, the
    decoder's convs with their biases (``upconv<k>.0.bias``)."""
    sd = {k: v for k, v in _torchvision_sd(arch, seed).items() if not k.startswith("fc.")}
    rng = np.random.default_rng(seed + 100)
    for k, v in model.state_dict().items():
        top, rest = k.split(".", 1)
        if top == "encoder" or k.endswith("num_batches_tracked"):
            continue
        name = rest if top == "seg_decoder" else k
        sd[name] = _random(tuple(v.shape), k, rng)
        if top == "seg_decoder" and name.endswith(".0.weight") and name.startswith("upconv"):
            sd[name.replace(".0.weight", ".0.bias")] = _random((v.shape[0],), k, rng)
    return sd


def _torch(sd: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _assert_bit_equal(model, want: dict, keys=None):
    got = model.state_dict()
    keys = want if keys is None else keys
    for k in keys:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_and_torchvision_layouts_load_bit_equal_to_jax_converter(arch):
    """Both layouts through the port equal the JAX converter's output
    through the bridge, entry for entry, bits included: the reference file
    fills every entry (the decoder's conv biases folded into the running
    means), the torchvision file the encoder alone (``fc`` dropped)."""
    stage_sizes, bottleneck = jtc._ARCHS[arch]
    model = build_model(arch, device="cpu", seed=3)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}

    ref = _reference_sd(arch, model)
    params, stats = jtc.convert_milnet(ref, stage_sizes, bottleneck)
    want, skipped = jax_weights.jax_to_state_dict({"params": params, "batch_stats": stats})
    assert skipped == []
    tckpt.restore_into(model, {"state_dict": _torch(ref)})
    n_entries = sum(not k.endswith("num_batches_tracked") for k in model.state_dict())
    assert len(want) == n_entries
    _assert_bit_equal(model, want)
    assert int(model.state_dict()["encoder.bn1.num_batches_tracked"]) == 7

    tv = _torchvision_sd(arch, seed=2)
    assert tc.validate_torchvision_state_dict(arch, tv) == []
    params, stats = jtc.convert_resnet_encoder(tv, stage_sizes, bottleneck)
    enc = jax_weights._encoder(params, stats, "encoder.")
    model.load_state_dict(fresh)
    tc.load_torchvision_encoder(model, _torch(tv), arch)
    _assert_bit_equal(model, enc)
    assert len(enc) == sum(k.startswith("encoder.") and not k.endswith("num_batches_tracked")
                           for k in model.state_dict())
    _assert_bit_equal(model, fresh, [k for k in fresh if not k.startswith("encoder.")])


def _shape_only(schema: dict) -> dict:
    return {k: np.broadcast_to(np.float32(0), shape) for k, shape in schema.items()}


def _validator_case(case: str):
    """(arch, state dict) of one schema problem."""
    if case == "clean":
        return "resnet50", _shape_only(tc.torchvision_key_schema("resnet50"))
    if case == "missing":
        sd = _shape_only(tc.torchvision_key_schema("resnet34"))
        for k in list(sd)[5:16]:  # more than 8: the list is cut
            del sd[k]
        return "resnet34", sd
    if case == "extra":
        sd = _shape_only(tc.torchvision_key_schema("resnet18"))
        sd.update({f"aux.{i}.weight": np.zeros(2, np.float32) for i in range(3)})
        sd["bn1.num_batches_tracked"] = np.asarray(1)  # accepted, never listed
        return "resnet18", sd
    if case == "shape":
        sd = _shape_only(tc.torchvision_key_schema("resnext50_32x4d"))
        sd["layer2.0.conv2.weight"] = np.zeros((256, 16, 3, 3), np.float32)
        sd["fc.weight"] = np.zeros((10, 2048), np.float32)
        return "resnext50_32x4d", sd
    if case == "wrong_arch_shapes":  # ResNet-50's file named as ResNeXt-50
        return "resnext50_32x4d", _shape_only(tc.torchvision_key_schema("resnet50"))
    if case == "wrong_arch_keys":  # ResNet-34's file named as ResNet-18
        return "resnet18", _shape_only(tc.torchvision_key_schema("resnet34"))
    raise ValueError(case)


CASES = ("clean", "missing", "extra", "shape", "wrong_arch_shapes", "wrong_arch_keys")


@pytest.mark.parametrize("case", CASES)
def test_validator_messages_are_the_jax_validators(case):
    arch, sd = _validator_case(case)
    assert tc.torchvision_key_schema(arch) == jtc.torchvision_key_schema(arch)
    got = tc.validate_torchvision_state_dict(arch, sd)
    assert got == jtc.validate_torchvision_state_dict(arch, sd)
    assert (got == []) == (case == "clean")
    if case.startswith("wrong_arch"):
        assert any(p.startswith("hint: the file matches torchvision") for p in got), got


def _tiny(seed: int):
    model = MILNet(ResNetEncoder(BasicBlock, (1, 1, 1, 1)))
    return init_milnet(model, seed)


def test_restore_raises_on_unfilled_partition_and_stray_entries():
    """A file that fills no encoder key raises when the encoder is asked
    for; an entry that lands on no model entry raises and is named, and the
    model is left as it was."""
    src, dst = _tiny(1), _tiny(2)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    heads_only = {k: v for k, v in src.state_dict().items() if k.startswith("fc_")}
    with pytest.raises(ValueError, match=r"fills no entry of partition\(s\) \['encoder'\]"):
        tckpt.restore_into(dst, {"state_dict": heads_only}, ("encoder",))
    stray = {**src.state_dict(), "encoder.layer9.0.conv1.weight": torch.zeros(1),
             "fc_tile.2.weight": torch.zeros(1)}
    with pytest.raises(ValueError, match=r"2 checkpoint entries land on no entry of the "
                                         r"MILNet: encoder\.layer9\.0\.conv1\.weight, "
                                         r"fc_tile\.2\.weight"):
        tckpt.restore_into(dst, {"state_dict": stray})
    # a torchvision file's classifier lands nowhere unless it is dropped
    flat = tc.reference_to_port({"conv1.weight": 0, "layer1.0.bn1.bias": 0, "fc.bias": 0,
                                 "upconv3.0.bias": 0, "seg_out_conv.weight": 0,
                                 "fc_tile.1.bias": 0})
    assert sorted(flat) == ["encoder.conv1.weight", "encoder.layer1.0.bn1.bias", "fc.bias",
                            "fc_tile.1.bias", "seg_decoder.seg_out_conv.weight",
                            "seg_decoder.upconv3.0.bias"]
    _assert_bit_equal(dst, before)
    # the heads alone, asked for the heads only, load
    tckpt.restore_into(dst, {"state_dict": heads_only}, ("fc_tile",))
    assert torch.equal(dst.fc_tile[1].weight, src.fc_tile[1].weight)


def test_stripped_prefixes_restore_every_entry():
    """The re-anchor's reproduction: a seed-1 ResNet-50 with its ``encoder.``
    and ``seg_decoder.`` prefixes stripped, restored into a seed-2 model,
    now equals seed 1 in every entry (before the repair only the heads
    moved)."""
    m1 = build_model("resnet50", device="cpu", seed=1)
    m2 = build_model("resnet50", device="cpu", seed=2)
    flat = {(k.split(".", 1)[1] if k.split(".", 1)[0] in ("encoder", "seg_decoder") else k): v
            for k, v in m1.state_dict().items()}
    assert "conv1.weight" in flat and "upconv1.0.weight" in flat
    assert not torch.equal(m2.encoder.conv1.weight, m1.encoder.conv1.weight)
    tckpt.restore_into(m2, {"state_dict": flat})
    _assert_bit_equal(m2, m1.state_dict())


def test_convert_cli_feeds_train_image_resume(tmp_path, monkeypatch, capsys):
    """``python -m ...utils.torch_convert``: a torchvision file gives an
    ``image`` checkpoint holding the encoder only, which the CLIs'
    ``-r`` load (``load_stage_checkpoint``) takes as the JAX recipe's does;
    a reference file with ``auto`` gives its mode's checkpoint; a file of
    another arch exits 2 and lists its problems."""
    monkeypatch.setenv("CST_PLATFORM", "cpu")
    tv = _torch(_torchvision_sd("resnet18", seed=4))
    torch.save(tv, tmp_path / "tv.pth")
    tc.main(["resnet18", str(tmp_path / "tv.pth"), str(tmp_path / "tv.ckpt")])
    ck = tckpt.load_checkpoint(str(tmp_path / "tv.ckpt"))
    assert (ck["mode"], ck["epoch"], ck["encoder"]) == ("image", 0, "resnet18")
    assert all(k.startswith("encoder.") for k in ck["state_dict"])
    args = argparse.Namespace(f32=False, device=0)
    model, _ = common.load_stage_checkpoint(str(tmp_path / "tv.ckpt"), args)
    assert torch.equal(model.encoder.layer4[1].conv2.weight, tv["layer4.1.conv2.weight"])
    assert torch.equal(model.encoder.bn1.running_var, tv["bn1.running_var"])

    ref_model = build_model("resnet18", device="cpu", seed=5)
    ref = _torch(_reference_sd("resnet18", ref_model, seed=6))
    torch.save({"mode": "tile", "epoch": 30, "encoder": "resnet18", "state_dict": ref},
               tmp_path / "pt2.pth")
    tc.main(["auto", str(tmp_path / "pt2.pth"), str(tmp_path / "pt2.ckpt")])
    ck = tckpt.load_checkpoint(str(tmp_path / "pt2.ckpt"))
    assert (ck["mode"], ck["epoch"]) == ("tile", 30)
    assert torch.equal(ck["state_dict"]["encoder.layer3.0.downsample.0.weight"],
                       ref["layer3.0.downsample.0.weight"])
    assert torch.equal(ck["state_dict"]["fc_tile.1.weight"], ref["fc_tile.1.weight"])

    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        tc.main(["resnet34", str(tmp_path / "tv.pth"), str(tmp_path / "bad.ckpt")])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "expected key(s) missing for resnet34" in err
    assert not (tmp_path / "bad.ckpt").exists()
