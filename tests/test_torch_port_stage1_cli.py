"""The port's stage-1 CLIs on a tiny synthetic h5 under ``CST_PLATFORM=cpu``:
``train_image`` then ``test_count`` in its one- and three-model forms. They
write the files the JAX package's CLIs write: ``pt1_<epoch>epochs.ckpt``
every epoch, ``<time>-image-training.csv`` and ``<time>-image-validation.csv``
with the JAX trainer's headers, and ``<time>-count-e<epoch>.csv`` (id,
count, organ) or ``<time>-count.csv`` (id, count)."""

from __future__ import annotations

import csv
import glob
import os

import pytest

import numpy as np

from cellsegmentation_tpu_torch.cli import test_count, train_image
from cellsegmentation_tpu_torch.core.config import load_data_path
from cellsegmentation_tpu_torch.data import LystoTestSource, make_synthetic_h5
from cellsegmentation_tpu_torch.train.checkpoint import load_checkpoint

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """train_image for 2 epochs (resnet18 at 64^2, 12 images, kfold 4),
    then test_count from its checkpoint, once and three times over."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CST_PLATFORM", "cpu")
    d = tmp_path_factory.mktemp("cli")
    make_synthetic_h5(str(d / "training.h5"), n_images=12, image_size=64,
                      max_cells=12, seed=1)
    make_synthetic_h5(str(d / "test.h5"), n_images=9, image_size=64,
                      max_cells=12, seed=2, with_labels=False)
    out = str(d / "out")
    train_image.main(["--data_path", str(d), "-E", "resnet18", "-e", "2", "-B", "8",
                      "-k", "4", "-a", "-o", out, "--seed", "3"])
    ck = os.path.join(out, "pt1_2epochs.ckpt")
    one, three = str(d / "one"), str(d / "three")
    test_count.main(["-m", ck, "--data_path", str(d), "-B", "4", "--cls_limit",
                     "-o", one])
    test_count.main(["-m", ck, ck, ck, "--data_path", str(d), "-B", "4", "-o", three])
    yield out, one, three, ck
    mp.undo()


def test_train_image_writes_checkpoints_and_csvs(run):
    out, *_ = run
    assert sorted(os.listdir(out)) == sorted(
        ["pt1_1epochs.ckpt", "pt1_2epochs.ckpt",
         *(os.path.basename(p) for p in glob.glob(os.path.join(out, "*.csv")))])
    (train_csv,) = glob.glob(os.path.join(out, "*-image-training.csv"))
    (val_csv,) = glob.glob(os.path.join(out, "*-image-validation.csv"))
    rows = _rows(train_csv)
    assert rows[0] == ["epoch", "image_cls_loss", "image_reg_loss", "image_loss"]
    assert [r[0] for r in rows[1:]] == ["1", "2"]
    rows = _rows(val_csv)
    assert rows[0] == ["epoch", "image_map", "mse", "qwk"] and len(rows) == 3
    ck = load_checkpoint(os.path.join(out, "pt1_2epochs.ckpt"))
    assert ck["mode"] == "image" and ck["epoch"] == 2 and ck["encoder"] == "resnet18"
    # 9 train images x 4 flips = 36 samples, batches of 8: 5 steps an epoch
    assert ck["step"] == 10 and ck["optimizer"]["state"]


def test_test_count_one_and_three_models(run):
    _, one, three, _ = run
    (path,) = glob.glob(os.path.join(one, "*-count-e2.csv"))
    rows = _rows(path)
    assert rows[0] == ["id", "count", "organ"]
    assert [r[0] for r in rows[1:]] == [str(i) for i in range(1, 10)]
    assert {r[2].split("_")[0] for r in rows[1:]} == {"colon", "breast", "prostate"}
    assert all(int(r[1]) >= 0 for r in rows[1:])
    (path,) = glob.glob(os.path.join(three, "*-count.csv"))
    rows3 = _rows(path)
    assert rows3[0] == ["id", "count"]
    assert [r[0] for r in rows3[1:]] == [str(i) for i in range(1, 10)]


def test_test_count_refuses_two_models(run, capsys):
    *_, ck = run
    with pytest.raises(SystemExit, match="1 or 3"):
        test_count.main(["-m", ck, ck])


def test_test_source_from_h5_and_arrays(tmp_path):
    """LystoTestSource keeps 1-based file ids through the organ filter, the
    same from the h5 file and from arrays."""
    arrays = make_synthetic_h5(str(tmp_path / "test.h5"), n_images=7, image_size=24,
                               max_cells=3, seed=4, with_labels=False)
    for organ in (None, "breast"):
        a = LystoTestSource(str(tmp_path / "test.h5"), organ=organ)
        b = LystoTestSource.from_arrays(arrays["images"], arrays["organs"], organ=organ)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.images, b.images)
        assert a.organs == b.organs and a.labels is b.labels is None
        assert len(a) == len(a.ids) and a.image_hw == (24, 24)
    assert list(b.ids) == [2, 5] and b.organs == ["breast_1", "breast_0"]


def test_load_data_path(tmp_path):
    ini = tmp_path / "config.ini"
    assert load_data_path(str(ini), default="d") == "d"
    ini.write_text("[data]\ndata_path = /some/where\n")
    assert load_data_path(str(ini)) == "/some/where"
