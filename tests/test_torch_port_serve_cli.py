"""The serving CLIs of the port run end to end under ``CST_PLATFORM=cpu``
on tiny inputs, from checkpoints of a seeded resnet18:

- ``test_tile`` (stage 2) with the exact graph and with q8g, threshold and
  ``--reg_limit``: the heatmaps, the prediction CSV (its rows are the tiles
  above the threshold on images with a nonzero count) and the count CSV;
- ``test_seg`` (stage 3) in its four modes: ``--draw_masks`` over an h5
  file's patches (soft masks too), ``--detect`` over a folder of ROI
  images, the point evaluation bucketed by cancer type, and
  ``--test_qupath``.

The modules these CLIs call are held against the JAX package in
tests/test_torch_port_detect.py and tests/test_torch_port_serve.py.
"""

from __future__ import annotations

import csv
import glob
import json
import os

import numpy as np
import pytest
import torch

from cellsegmentation_tpu_torch.cli import test_seg, test_tile
from cellsegmentation_tpu_torch.data import make_synthetic_h5
from cellsegmentation_tpu_torch.models import build_model
from cellsegmentation_tpu_torch.train import checkpoint as tckpt
from cellsegmentation_tpu_torch.utils.images import read_png, write_png

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A data folder with a 2-image test.h5 (64^2), pt2 and pt3 files of a
    seeded resnet18 with its count head pinned at 0.7 (every count rounds
    to 1), and the CPU platform."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CST_PLATFORM", "cpu")
    d = tmp_path_factory.mktemp("serve")
    arrays = make_synthetic_h5(str(d / "test.h5"), n_images=2, image_size=64,
                               max_cells=6, seed=4, with_labels=False)
    model = build_model("resnet18", device="cpu", seed=1)
    with torch.no_grad():
        model.fc_image_reg[7].weight.zero_()
        model.fc_image_reg[7].bias.fill_(0.7)
    sd = model.state_dict()
    pt2 = tckpt.save_checkpoint(str(d / "ck"), "tile", 3, "resnet18", sd)
    pt3 = tckpt.save_checkpoint(str(d / "ck"), "segment", 2, "resnet18", sd)
    yield d, arrays, pt2, pt3
    mp.undo()


@pytest.mark.parametrize("engine", ["flax", "q8g"])
def test_test_tile_cli(run, engine):
    d, arrays, pt2, _ = run
    out = d / f"tile_{engine}"
    test_tile.main(["-m", pt2, "--data_path", str(d), "-t", "32", "-i", "5",
                    "-c", "0.3", "-B", "1", "--reg_limit", "--infer_engine", engine,
                    "-o", str(out)])
    assert sorted(os.listdir(out / ".")) == sorted(
        [f"test_{i:05}.png" for i in (1, 2)]
        + [os.path.basename(p) for p in glob.glob(str(out / "*.csv"))])
    (pred,) = glob.glob(str(out / "*-pred-e3-p32-i5-c0.3.csv"))
    (count,) = glob.glob(str(out / "*-count-e3.csv"))
    counts = _rows(count)
    assert counts[0] == ["id", "count", "organ"] and len(counts) == 3
    rows = _rows(pred)
    assert rows[:3] == [["tile_size", "32"], ["interval", "5"], ["idx", "grid", "prob"]]
    tiles = rows[3:]
    assert tiles and all(float(p) > 0.3 for _, _, p in tiles)
    assert {int(g) for g, _, _ in tiles} == {i for i, r in enumerate(counts[1:])
                                             if int(r[1]) != 0}
    assert read_png(str(out / "test_00001.png")).shape == (64, 64, 3)


def test_test_seg_draw_masks_cli(run):
    """--draw_masks with --soft_mask over the h5 file's patches, in batches
    of 1 (the overlays' two forms are held against the JAX package in
    tests/test_torch_port_detect.py)."""
    d, arrays, _, pt3 = run
    out = d / "draw"
    test_seg.main(["-m", pt3, "--data_path", str(d / "test.h5"), "--draw_masks",
                   "--soft_mask", "-B", "1", "-c", "0.4", "-o", str(out)])
    names = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert names == ["test_00001.png", "test_00002.png"]
    # a small h5 image is zero-padded to the CLI's 299-px patch
    assert read_png(str(out / "test_00002.png")).shape == (299, 299, 3)
    assert sorted(os.listdir(out / "soft")) == ["00001.png", "00002.png"]


def test_test_seg_detect_cli(run):
    d, arrays, _, pt3 = run
    roi = d / "roi"
    os.makedirs(roi)
    for i, name in enumerate(("b_2.png", "a_1.png")):
        write_png(str(roi / name), np.tile(arrays["images"][i], (2, 2, 1))[:100, :120])
    out = d / "detect_out"
    test_seg.main(["-m", pt3, "--data_path", str(roi), "--detect", "-o", str(out)])
    det = out / "detect"
    (loc,) = glob.glob(str(det / "*-location.csv"))
    rows = _rows(loc)
    assert rows[0] == ["image_id", "x", "y"]
    assert {r[0] for r in rows[1:]} <= {"a_1", "b_2"}
    for r in rows[1:]:
        assert 0 <= int(r[1]) < 100 and 0 <= int(r[2]) < 120
    for stem in ("a_1", "b_2"):
        assert read_png(str(det / f"mask_{stem}.png")).shape == (100, 120)
        (cells,) = glob.glob(str(det / f"{stem}_*cells.png"))
        n = int(os.path.basename(cells).split("_")[-1][: -len("cells.png")])
        assert sum(r[0] == stem for r in rows[1:]) <= n


def _point_root(d, arrays):
    root = d / "points"
    for sub in ("images", "masks", "points"):
        os.makedirs(root / sub)
    names = ["p_1.png", "p_2.png"]
    for i, n in enumerate(names):
        write_png(str(root / "images" / n), arrays["images"][i])
        write_png(str(root / "masks" / n),
                  (arrays["images"][i][..., 2] < 128).astype(np.uint8) * 255)
        np.savetxt(root / "points" / n.replace(".png", ".tsv"),
                   np.asarray([[10, 12], [40, 30]]), delimiter="\t", fmt="%d")
    (root / "image_type.csv").write_text("p_1.png,breast,regular\np_2.png,prostate,artifact\n")
    return root, names


def test_test_seg_point_eval_and_qupath_cli(run, capsys):
    d, arrays, _, pt3 = run
    root, names = _point_root(d, arrays)
    out = d / "point_out"
    test_seg.main(["-m", pt3, "--data_path", str(root), "--cancer_type", "--reg_limit",
                   "-o", str(out)])
    rows = _rows(out / "center.csv")
    assert rows[0] == ["id", "count", "tp", "fp", "fn", "p", "r", "f1", "dice"]
    assert [r[0] for r in rows[1:]] == names
    for r in rows[1:]:
        tp, fp, fn = int(r[2]), int(r[3]), int(r[4])
        assert tp + fn == 2 and 0 <= float(r[8]) <= 1
    printed = capsys.readouterr().out
    assert "breast: P=" in printed and "prostate: P=" in printed
    for n, r in zip(names, rows[1:]):
        assert read_png(str(out / "predict_mask_binary" / n)).shape == (64, 64)
        assert os.path.exists(out / "predict_mask" / n.replace(".png", f"_{r[1]}.png"))

    qp = d / "qupath"
    os.makedirs(qp)
    (qp / "p_1.geojson").write_text(json.dumps({"features": [
        {"geometry": {"type": "Point", "coordinates": [11, 12]}},
        {"geometry": {"type": "Polygon",
                      "coordinates": [[[38, 28], [42, 28], [42, 32], [38, 32]]]}}]}))
    test_seg.main(["-m", "unused", "--data_path", str(root), "--test_qupath", str(qp),
                   "-o", str(out)])
    q = _rows(out / "qupath-center.csv")
    assert q[1][:4] == ["p_1.png", "2", "0", "0"] and q[2][:4] == ["p_2.png", "0", "0", "2"]
