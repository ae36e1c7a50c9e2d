"""The port's CLIs on EfficientNet-B0 at full width, on tiny synthetic h5
files under ``CST_PLATFORM=cpu``: the chain ``train_image -E
efficientnet_b0`` -> ``test_count`` -> ``train_tile`` -> ``test_tile``,
and ``train_ensemble -E efficientnet_b0 -k 2`` -> ``test_ensemble``. Each
checkpoint carries the encoder's name and reloads exactly: a fresh model
restored from it gives the CLI's own outputs. Stage 2 leaves the encoder
bit-unchanged (no stochastic depth and no BatchNorm update outside stage
1). Stage 3 refuses as the JAX package's does: ``train_stage3`` (held
against the JAX package's on the reduced model), ``train_seg`` after
drawing the pseudo-masks (which runs on the tile and image heads),
``test_seg`` at its first seg forward; the JAX package's two CLIs refuse
alike.
"""

from __future__ import annotations

import csv
import glob
import os

import numpy as np
import pytest
import torch

from cellsegmentation_tpu.cli import common as jcommon
from cellsegmentation_tpu.cli import test_seg as jtest_seg
from cellsegmentation_tpu.cli import train_seg as jtrain_seg
from cellsegmentation_tpu.data.masks import MaskDataSource as JMaskSource
from cellsegmentation_tpu.train.trainers import train_stage3 as jtrain_stage3
from cellsegmentation_tpu.utils.logging import RunLogger as JLogger

from cellsegmentation_tpu_torch import infer
from cellsegmentation_tpu_torch.cli import (
    test_count,
    test_ensemble,
    test_seg,
    test_tile,
    train_ensemble,
    train_image,
    train_seg,
    train_tile,
)
from cellsegmentation_tpu_torch.data import LystoTestSource, MaskDataSource, make_synthetic_h5
from cellsegmentation_tpu_torch.models import build_model
from cellsegmentation_tpu_torch.train import checkpoint as tckpt
from cellsegmentation_tpu_torch.train.steps import make_image_infer_step
from cellsegmentation_tpu_torch.train.trainers import train_stage3
from cellsegmentation_tpu_torch.utils.logging import RunLogger

from test_torch_port_effnet import NO_DECODER, _jax_model, fx  # noqa: F401 (fx: a fixture)
from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)

NAME = "efficientnet_b0"


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _restored(path):
    """A fresh B0 on the CPU with every entry of the checkpoint loaded."""
    ck = tckpt.load_checkpoint(path)
    model = build_model(ck["encoder"], device="cpu", seed=99)
    tckpt.restore_into(model, ck)
    return model, ck


def _counts(model, source):
    return infer.inference_image(source, make_image_infer_step(model, device="cpu"),
                                 batch_size=4)[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """train_image (1 epoch, batch 4) -> test_count -> train_tile (1 epoch,
    validation on) -> test_tile (32/5, threshold 0.3); train_ensemble (k =
    2, 1 epoch, batch 4) -> test_ensemble; one data folder of 64^2 images."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CST_PLATFORM", "cpu")
    d = tmp_path_factory.mktemp("effnet_cli")
    make_synthetic_h5(str(d / "training.h5"), n_images=8, image_size=64,
                      max_cells=12, seed=1)
    make_synthetic_h5(str(d / "test.h5"), n_images=4, image_size=64,
                      max_cells=12, seed=2, with_labels=False)
    out = str(d / "out")
    train_image.main(["--data_path", str(d), "-E", NAME, "-e", "1", "-B", "4",
                      "-k", "4", "-o", out, "--seed", "3"])
    pt1 = os.path.join(out, "pt1_1epochs.ckpt")
    test_count.main(["-m", pt1, "--data_path", str(d), "-B", "4", "-o", str(d / "count")])
    train_tile.main(["--data_path", str(d), "-m", pt1, "-e", "1", "-B", "4", "-b", "64",
                     "--test_every", "1", "-o", out])
    pt2 = os.path.join(out, "pt2_1epochs.ckpt")
    # the count head pinned at 0.7 (every count rounds to 1), the tile head
    # raised, so the 0.3 threshold keeps tiles on every image
    model, ck = _restored(pt2)
    with torch.no_grad():
        model.fc_image_reg[2].weight.zero_()
        model.fc_image_reg[2].bias.fill_(0.7)
        model.fc_tile[1].bias.copy_(torch.tensor([0.0, 2.0]))
    serve = tckpt.save_checkpoint(str(d / "serve"), "tile", 1, NAME, model.state_dict())
    test_tile.main(["-m", serve, "--data_path", str(d), "-c", "0.3", "-B", "2",
                    "--reg_limit", "-o", str(d / "tile")])
    ens, ens_out = str(d / "ens"), str(d / "ens_out")
    train_ensemble.main(["--data_path", str(d), "-E", NAME, "-k", "2", "-e", "1",
                         "-B", "4", "-o", ens, "--seed", "3"])
    test_ensemble.main(["-m", ens, "-e", "1", "--data_path", str(d), "-B", "4",
                        "-o", ens_out])
    yield d, pt1, pt2, ens, ens_out
    mp.undo()


def test_stage1_checkpoint_reloads_and_counts(run):
    """pt1 carries the encoder's name and the stage-1 partitions; a fresh
    model restored from it gives test_count's counts."""
    d, pt1, *_ = run
    model, ck = _restored(pt1)
    assert (ck["mode"], ck["epoch"], ck["encoder"]) == ("image", 1, NAME)
    assert {k.split(".")[0] for k in ck["state_dict"]} == {
        "encoder", "fc_image_cls", "fc_image_reg"}
    for k, v in ck["state_dict"].items():
        assert torch.equal(model.state_dict()[k], v), k
    (path,) = glob.glob(str(d / "count" / "*-count-e1.csv"))
    rows = _rows(path)
    assert rows[0] == ["id", "count", "organ"] and len(rows) == 5
    want = _counts(model, LystoTestSource(str(d / "test.h5")))
    assert [int(r[1]) for r in rows[1:]] == list(want)


def test_stage2_keeps_the_encoder_and_trains_the_tile_head(run):
    """pt2 holds pt1's encoder bit for bit (weights and statistics: stage 2
    runs it frozen, on running statistics, without stochastic depth) and
    image heads, and a trained tile head."""
    _, pt1, pt2, *_ = run
    ck1, ck2 = tckpt.load_checkpoint(pt1), tckpt.load_checkpoint(pt2)
    assert (ck2["mode"], ck2["encoder"]) == ("tile", NAME)
    for k, v in ck1["state_dict"].items():
        assert torch.equal(ck2["state_dict"][k], v), k
    fresh = build_model(NAME, device="cpu", seed=3).state_dict()
    assert not torch.equal(ck2["state_dict"]["fc_tile.1.weight"], fresh["fc_tile.1.weight"])


def test_test_tile_writes_counts_predictions_and_heatmaps(run):
    d, *_ = run
    out = d / "tile"
    (count,) = glob.glob(str(out / "*-count-e1.csv"))
    counts = _rows(count)
    assert counts[0] == ["id", "count", "organ"] and [r[1] for r in counts[1:]] == ["1"] * 4
    (pred,) = glob.glob(str(out / "*-pred-e1-p32-i5-c0.3.csv"))
    rows = _rows(pred)
    assert rows[:3] == [["tile_size", "32"], ["interval", "5"], ["idx", "grid", "prob"]]
    assert rows[3:] and all(float(p) > 0.3 for _, _, p in rows[3:])
    assert sorted(f for f in os.listdir(out) if f.endswith(".png")) == [
        f"test_{i:05}.png" for i in (1, 2, 3, 4)]


def test_ensemble_checkpoints_and_mean_counts(run):
    """One reg_pt1 file per fold, each carrying the encoder's name; the
    ensemble CSV is round(mean) of the folds' own counts from models
    restored from them."""
    d, *_, ens, ens_out = run
    paths = test_ensemble.ensemble_paths(ens, 1)
    assert [os.path.basename(p) for p in paths] == [
        "reg_pt1_0_1epochs.ckpt", "reg_pt1_1_1epochs.ckpt"]
    src = LystoTestSource(str(d / "test.h5"))
    counts = []
    for p in paths:
        model, ck = _restored(p)
        assert (ck["mode"], ck["encoder"]) == ("image", NAME)
        counts.append(_counts(model, src))
    (path,) = glob.glob(os.path.join(ens_out, "*-count-e1.csv"))
    want = np.asarray(counts).mean(axis=0).round().astype(int)
    assert [int(r[1]) for r in _rows(path)[1:]] == list(want)


def test_train_stage3_refused_like_jax(fx, tmp_path):
    """train_stage3 on an EfficientNet raises NotImplementedError with the
    JAX package's message, and writes no pt3 file, on both sides (the JAX
    package at its first step's trace, the port at its train state)."""
    n, hw = 4, 64
    imgs = np.random.default_rng(0).integers(0, 256, (n, hw, hw, 3)).astype(np.uint8)
    masks = np.zeros((n, hw, hw), np.uint8)
    src = JMaskSource.__new__(JMaskSource)
    src.images, src.masks, src.augment = imgs, masks, False
    src.flip_code, src.base_idx = np.zeros(n, np.int32), np.arange(n)
    src.organs, src.labels = ["a_0"] * n, np.zeros(n, int)
    with pytest.raises(NotImplementedError, match=NO_DECODER):
        jtrain_stage3(_jax_model(), fx["variables"], src, epochs=1, batch_size=2,
                      output_dir=str(tmp_path / "jax"),
                      logger=JLogger(str(tmp_path / "jax"), tensorboard=False))
    with pytest.raises(NotImplementedError, match=NO_DECODER):
        train_stage3(fx["model"], MaskDataSource.from_arrays(imgs, masks), epochs=1,
                     batch_size=2, output_dir=str(tmp_path / "port"), device="cpu",
                     logger=RunLogger(str(tmp_path / "port"), tensorboard=False))
    assert not glob.glob(str(tmp_path / "*" / "pt3_*"))


def test_train_seg_and_test_seg_refuse(run, fx, monkeypatch):
    """train_seg on the EfficientNet pt2 draws the pseudo-masks (tile and
    image heads) and then refuses the decoder training; test_seg refuses
    at its first seg forward. The JAX package's two CLIs refuse alike on
    the reduced EfficientNet (its checkpoint loading replaced by the
    fixture's model and variables; train_seg on the port's masks with
    ``--skip_draw``)."""
    d, _, pt2, *_ = run
    with pytest.raises(NotImplementedError, match=NO_DECODER):
        train_seg.main(["--data_path", str(d), "-m", pt2, "-e", "1", "-B", "4",
                        "-b", "4", "-o", str(d / "seg")])
    assert len(os.listdir(d / "pseudomask" / "mask")) == 8
    assert not glob.glob(str(d / "seg" / "pt3_*"))
    with pytest.raises(NotImplementedError, match=NO_DECODER):
        test_seg.main(["-m", pt2, "--data_path", str(d / "test.h5"), "--draw_masks",
                       "-B", "1", "-o", str(d / "seg_draw")])
    monkeypatch.setattr(jcommon, "load_stage_checkpoint", lambda path, args, partitions=None: (
        _jax_model(), fx["variables"], {"encoder": NAME, "epoch": 1}))
    with pytest.raises(NotImplementedError, match=NO_DECODER):
        jtrain_seg.main(["--data_path", str(d), "-m", "pt2", "--skip_draw", "-e", "1",
                         "-B", "4", "-o", str(d / "jseg")])
    assert not glob.glob(str(d / "jseg" / "pt3_*"))
    with pytest.raises(NotImplementedError, match=NO_DECODER):
        jtest_seg.main(["-m", "pt2", "--data_path", str(d / "test.h5"), "--draw_masks",
                        "-B", "1", "-o", str(d / "jseg_draw")])
