"""The port's stage-3 drawing path held against the JAX package: block
painting, the V-channel refinement and ``generate_masks`` byte-equal with
the refinement on and off, through the native morphology library and
through SciPy; ``draw_pseudo_masks`` byte-equal (masks and PNG trees) from
one tile-prob stub over an augmented source with an uneven last batch;
the default draw's engine; the entry points' device rule; and the
``train_tile`` -> ``train_seg`` CLIs on a tiny synthetic h5 under
``CST_PLATFORM=cpu``.
"""

from __future__ import annotations

import csv
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellsegmentation_tpu.data.lysto import LystoDataSource as JSource
from cellsegmentation_tpu.postprocess import masks as jmasks
from cellsegmentation_tpu.postprocess import morphology as jmorph
from cellsegmentation_tpu.train import steps as jsteps
from cellsegmentation_tpu.train.trainers import draw_pseudo_masks as jdraw
from cellsegmentation_tpu.utils.logging import RunLogger as JLogger

from cellsegmentation_tpu_torch.cli import train_seg, train_tile
from cellsegmentation_tpu_torch.data import (
    LystoDataSource,
    MaskDataSource,
    make_synthetic_h5,
)
from cellsegmentation_tpu_torch.infer import iter_tiles_and_counts
from cellsegmentation_tpu_torch.models import BasicBlock, MILNet, ResNetEncoder, build_model
from cellsegmentation_tpu_torch.models.milnet import init_milnet
from cellsegmentation_tpu_torch.native.build import load_native
from cellsegmentation_tpu_torch.ops.tiles import tile_grid
from cellsegmentation_tpu_torch.postprocess import masks as tmasks
from cellsegmentation_tpu_torch.postprocess import morphology as tmorph
from cellsegmentation_tpu_torch.train import checkpoint as tckpt
from cellsegmentation_tpu_torch.train import trainers as ttrainers
from cellsegmentation_tpu_torch.train.steps import (
    make_seg_infer_step,
    make_seg_train_step,
)
from cellsegmentation_tpu_torch.utils.logging import RunLogger

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)

HW, TILE, INTERVAL = 96, 16, 5


def _images(n, seed=1):
    """Images whose V channel crosses 170 in bands, so the refinement cuts
    the painted blocks into objects and holes of every size class."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(HW), np.arange(HW), indexing="ij")
    base = 140 + 60 * np.sin(xx / 7.0)[None] * np.cos(yy / 11.0)[None]
    imgs = base[..., None] + rng.normal(0, 25, (n, HW, HW, 3))
    return imgs.clip(0, 255).astype(np.uint8)


def _kept(n, seed=2):
    """Random kept tiles on the 16/5 grid: (groups, tile corners)."""
    coords = tile_grid(HW, HW, TILE, INTERVAL)
    rng = np.random.default_rng(seed)
    keep = rng.random((n, len(coords))) > 0.8
    groups, tile_idx = np.nonzero(keep)
    return groups, coords[tile_idx]


@pytest.fixture(params=["native", "scipy"])
def morphology(request, monkeypatch):
    """Both sides through their native libraries, or both through SciPy."""
    if request.param == "native":
        assert load_native() is not None and jmorph.load_native() is not None
    else:
        monkeypatch.setattr(tmorph, "load_native", lambda: None)
        monkeypatch.setattr(jmorph, "load_native", lambda: None)
    return request.param


def _tree_bytes(root):
    return {os.path.relpath(p, root): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(root, "*", "*.png")))}


@pytest.mark.parametrize("preprocess", [False, True], ids=["plain", "refined"])
def test_generate_masks_byte_equal(morphology, preprocess, tmp_path):
    """paint_tile_blocks, preprocess_masks_batch and generate_masks (with
    its rgb/ and mask/ PNG trees) byte-equal to the JAX package's."""
    imgs = _images(4)
    groups, xy = _kept(4)
    paint = tmasks.paint_tile_blocks(4, (HW, HW), groups, xy, TILE)
    np.testing.assert_array_equal(
        paint, jmasks.paint_tile_blocks(4, (HW, HW), groups, xy, TILE))
    got = tmasks.generate_masks(imgs, groups, xy, TILE, preprocess=preprocess,
                                output_path=str(tmp_path / "port"))
    want = jmasks.generate_masks(imgs, groups, xy, TILE, preprocess=preprocess,
                                 output_path=str(tmp_path / "jax"))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got != paint).any() == preprocess
    a, b = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert len(a) == 8 and a == b


@pytest.mark.parametrize("connectivity", [1, 2])
def test_small_region_filters_match_jax(morphology, connectivity):
    """remove_small_objects / remove_small_holes / preprocess_masks on
    random masks, each connectivity, equal to the JAX package's."""
    rng = np.random.default_rng(connectivity)
    for _ in range(3):
        m = rng.random((40, 50)) > 0.45
        for size in (1, 5, 30):
            np.testing.assert_array_equal(
                tmorph.remove_small_objects(m, size, connectivity),
                jmorph.remove_small_objects(m, size, connectivity))
            np.testing.assert_array_equal(
                tmorph.remove_small_holes(m, size, connectivity),
                jmorph.remove_small_holes(m, size, connectivity))
    imgs, (groups, xy) = _images(1), _kept(1)
    mask = tmasks.paint_tile_blocks(1, (HW, HW), groups, xy, TILE)[0]
    np.testing.assert_array_equal(tmasks.preprocess_masks(imgs[0], mask),
                                  jmasks.preprocess_masks(imgs[0], mask))


# ---------------------------------------------------------------------------
# draw_pseudo_masks
# ---------------------------------------------------------------------------


def _stub_probs(images, flip, coords):
    """P(positive) of each tile from its upper-left pixel and the sample's
    flip code, in integer arithmetic, so both frameworks give the same f32."""
    px = images[:, coords[:, 0], coords[:, 1], 0].astype(np.int64)
    return ((px + 37 * np.asarray(flip)[:, None]) % 256 / 255.0).astype(np.float32)


def _stub_counts(images):
    """0, 1 or 2 per image, so artifact clearing drops some images."""
    return (images[:, 0, 0, 1].astype(np.int64) % 3).astype(np.float32)


@pytest.fixture
def stubs(monkeypatch):
    """Tile and count steps on both sides that compute the stub values, and
    the image-count step factories patched to return the count stub."""
    coords = tile_grid(HW, HW, TILE, INTERVAL)

    def jtile(variables, images, flip):
        return jnp.asarray(_stub_probs(np.asarray(images), flip, coords))

    def jimage(variables, images, flip):
        return None, jnp.asarray(_stub_counts(np.asarray(images)))

    def ttile(images, flip):
        return torch.from_numpy(_stub_probs(images.numpy(), flip, coords))

    def timage(images, flip):
        return None, torch.from_numpy(_stub_counts(images.numpy()))

    ttile.resolved_engine = "stub"
    monkeypatch.setattr(jsteps, "make_image_infer_step", lambda model: jimage)
    monkeypatch.setattr(ttrainers, "make_image_infer_step",
                        lambda model, device=None: timage)
    return jtile, ttile


def _tiny_model(seed=0):
    return init_milnet(MILNet(ResNetEncoder(BasicBlock, (1, 1, 1, 1))), seed)


@pytest.mark.parametrize("preprocess", [False, True], ids=["plain", "refined"])
def test_draw_byte_equal_from_a_stub(stubs, preprocess, tmp_path, capsys):
    """Two images x 4 flips at image batch 3 (batches of 3, 3, 2): threshold,
    artifact clearing, painting, refinement and the PNG trees byte-equal to
    the JAX package's streamed draw; the log names the stub's engine."""
    jtile, ttile = stubs
    imgs = _images(2, seed=4)
    imgs[:, 0, 0, 1] = (4, 3)  # stub counts 1 and 0
    counts = np.asarray([3, 0])
    src = LystoDataSource.from_arrays(imgs, ["colon_0", "breast_1"], counts,
                                      kfold=None, augment=True)
    jsrc = JSource.__new__(JSource)
    jsrc.images, jsrc.labels = src.images, src.labels
    jsrc.base_idx, jsrc.flip_code = src.base_idx, src.flip_code
    kw = dict(tile_size=TILE, interval=INTERVAL, threshold=0.6, image_batch=3,
              preprocess=preprocess)
    want = jdraw(None, None, jsrc, output_path=str(tmp_path / "jax"),
                 logger=JLogger(str(tmp_path), tensorboard=False),
                 infer_tiles_fn=jtile, **kw)
    got = ttrainers.draw_pseudo_masks(
        _tiny_model(), src, output_path=str(tmp_path / "port"), device="cpu",
        logger=RunLogger(str(tmp_path), tensorboard=False), infer_tiles_fn=ttile,
        **kw)
    assert got.shape == (8, HW, HW) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    drawn = got.reshape(8, -1).max(axis=1) > 0
    assert list(drawn) == [True, False] * 4  # the second image is cleared
    a, b = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert len(a) == 16 and a == b
    assert "(tile engine stub)" in capsys.readouterr().out


def test_default_draw_runs_per_tile_q8(tmp_path, capsys):
    """draw_pseudo_masks with no step given builds one with engine="auto"
    from the source's calibration pick: per-tile q8 on the 16/5 grid. With
    the count head pinned to 5 and the tile head's bias raised, tiles pass
    the CLI's 0.95 threshold; the masks are the painted kept tiles."""
    model = _tiny_model()
    with torch.no_grad():
        model.fc_image_reg[7].weight.zero_()
        model.fc_image_reg[7].bias.fill_(5.0)
        model.fc_tile[1].bias.copy_(torch.tensor([0.0, 2.95]))
    src = LystoDataSource.from_arrays(_images(3, seed=5), ["a_0"] * 3,
                                      np.asarray([1, 2, 3]), kfold=None)
    masks = ttrainers.draw_pseudo_masks(
        model, src, image_batch=2, device="cpu",
        logger=RunLogger(str(tmp_path), tensorboard=False))
    out = capsys.readouterr().out
    assert "(tile engine q8)" in out and "[engine] auto" not in out
    kept = int(out.split("pseudo-masks: ")[1].split(" tiles")[0])
    assert 0 < kept < 3 * 289
    assert masks.shape == (3, HW, HW) and masks.any() and not masks.all()


def test_stage3_entry_points_raise_without_cuda(monkeypatch):
    """The stage-3 entry points run on the card unless given device="cpu",
    and raise without one; the CLIs unless CST_PLATFORM=cpu."""
    model = _tiny_model()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = MaskDataSource.from_arrays(_images(2), np.zeros((2, HW, HW), np.uint8))
    for call in (lambda: make_seg_train_step(model),
                 lambda: make_seg_infer_step(model),
                 lambda: ttrainers.draw_pseudo_masks(model, src),
                 lambda: ttrainers.train_stage3(model, src, epochs=1),
                 lambda: next(iter_tiles_and_counts(src, None, None))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    monkeypatch.delenv("CST_PLATFORM", raising=False)
    for main in (train_tile.main, train_seg.main):
        with pytest.raises(RuntimeError, match="CST_PLATFORM=cpu"):
            main(["--data_path", "/nonexistent", "-m", "none.ckpt"])
    probs = make_seg_infer_step(model, device="cpu")(src.images, [0, 2])
    assert probs.shape == (2, HW, HW) and probs.device.type == "cpu"


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """A pt1 file of a seeded resnet18, train_tile for one epoch from it
    (per-tile q8 sweep), train_seg from the pt2 (draw with -p, one epoch,
    augmented), then train_seg resumed from the pt3 to epoch 2 on the saved
    PNG masks (--skip_draw)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CST_PLATFORM", "cpu")
    d = tmp_path_factory.mktemp("cli3")
    make_synthetic_h5(str(d / "training.h5"), n_images=6, image_size=64,
                      max_cells=8, seed=1)
    out = str(d / "out")
    pt1 = tckpt.save_checkpoint(out, "image", 1, "resnet18",
                                build_model("resnet18", device="cpu").state_dict())
    train_tile.main(["--data_path", str(d), "-m", pt1, "-e", "1", "-B", "4",
                     "-b", "64", "-t", "32", "-i", "16", "--test_every", "2",
                     "-o", out])
    pt2 = os.path.join(out, "pt2_1epochs.ckpt")
    train_seg.main(["--data_path", str(d), "-m", pt2, "-e", "1", "-B", "4",
                    "-b", "4", "-p", "-a", "-o", out])
    pt3 = os.path.join(out, "pt3_1epochs.ckpt")
    train_seg.main(["--data_path", str(d), "-r", pt3, "-e", "2", "-B", "4",
                    "--skip_draw", "-o", out])
    yield d, out, pt1
    mp.undo()


def test_train_tile_then_train_seg(cli):
    d, out, _ = cli
    names = sorted(os.listdir(out))
    for f in ("pt1_1epochs.ckpt", "pt2_1epochs.ckpt", "pt3_1epochs.ckpt",
              "pt3_2epochs.ckpt"):
        assert f in names, names
    ck2 = tckpt.load_checkpoint(os.path.join(out, "pt2_1epochs.ckpt"))
    assert ck2["mode"] == "tile" and ck2["encoder"] == "resnet18"
    ck3 = tckpt.load_checkpoint(os.path.join(out, "pt3_2epochs.ckpt"))
    assert ck3["mode"] == "segment" and ck3["epoch"] == 2 and ck3["step"] == 4
    assert any(k.startswith("seg_decoder.") for k in ck3["state_dict"])
    # the pt2's tile head came through the draw and both seg runs unchanged
    for k, v in ck2["state_dict"].items():
        if k.startswith("fc_tile."):
            assert torch.equal(ck3["state_dict"][k], v), k
    for sub in ("rgb", "mask"):
        assert sorted(os.listdir(d / "pseudomask" / sub)) == \
            [f"{i:05}.png" for i in range(1, 7)]
    (tile_csv,) = glob.glob(os.path.join(out, "*-tile-training.csv"))
    assert _rows(tile_csv)[0] == ["epoch", "tile_loss"]
    seg = sorted(glob.glob(os.path.join(out, "*-seg-training.csv")))
    rows = [r for p in seg for r in _rows(p)]
    assert rows[0] == ["epoch", "seg_loss_ce", "seg_loss_dice"]
    assert [r[0] for r in rows if r[0] != "epoch"] == ["1", "2"]


def test_train_tile_refuses_unported_engines(cli):
    """Every engine the JAX package offers is ported now: q8g runs (on this
    resnet18, as the JAX package does, through the conv trunk); a name that
    is not an engine is refused by the flag parser."""
    d, out, pt1 = cli
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CST_PLATFORM", "cpu")
        train_tile.main(["--data_path", str(d), "-m", pt1, "-e", "1", "-B", "4",
                         "-b", "64", "-t", "32", "-i", "16", "--infer_engine", "q8g",
                         "--test_every", "2", "-o", str(d / "q8g")])
        assert os.path.exists(d / "q8g" / "pt2_1epochs.ckpt")
        with pytest.raises(SystemExit):
            train_tile.main(["--data_path", str(d), "-m", pt1, "--infer_engine", "q9",
                             "-o", str(d / "refused")])
