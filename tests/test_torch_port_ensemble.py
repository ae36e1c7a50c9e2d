"""The port's ensemble CLIs and their source held against the JAX package.

- ``EnsembleSource``: the fold bounds (``divmod``, contiguous validation
  blocks) and every view's rows equal the JAX package's for several (N, k),
  from h5 and from arrays, the views sharing the one image stack.
- ``train_ensemble`` (k = 2, 1 epoch, under ``CST_PLATFORM=cpu`` from an
  h5 file) on a ResNeXt at full width and stage sizes (1, 1, 1, 1), put in
  the port's registry under a name of its own for the run: the checkpoint
  names, their payloads, a fresh model per fold.
- ``test_ensemble``: its CSV holds ``round(mean)`` of the JAX package's own
  ``inference_image`` counts, model by model, on the same checkpoints'
  weights converted with the JAX package's torch converter (f32 on both
  sides).
"""

from __future__ import annotations

import csv
import glob
import os

import numpy as np
import pytest
import torch

from cellsegmentation_tpu import infer as jinfer
from cellsegmentation_tpu.core.dtypes import F32_POLICY as J_F32
from cellsegmentation_tpu.data.lysto import EnsembleSource as JEnsembleSource
from cellsegmentation_tpu.data.lysto import LystoTestSource as JTestSource
from cellsegmentation_tpu.models.milnet import MILNet as JMILNet
from cellsegmentation_tpu.models.resnet import Bottleneck as JBottleneck
from cellsegmentation_tpu.models.resnet import ResNetEncoder as JEncoder
from cellsegmentation_tpu.train import steps as jsteps
from cellsegmentation_tpu.utils.torch_convert import convert_milnet

from cellsegmentation_tpu_torch import models
from cellsegmentation_tpu_torch.cli import test_ensemble, train_ensemble
from cellsegmentation_tpu_torch.data import EnsembleSource, make_synthetic_h5
from cellsegmentation_tpu_torch.models import Bottleneck, MILNet, ResNetEncoder
from cellsegmentation_tpu_torch.train.checkpoint import (
    STAGE_SAVE_PARTITIONS,
    load_checkpoint,
)

from test_torch_port_resnext import _port_sd
from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)

SIZES = (1, 1, 1, 1)
NAME = "resnext_test_32x4d"  # the test's ResNeXt in the port's registry
K, EPOCHS = 2, 1


@pytest.mark.parametrize("n,k,augment", [(7, 3, False), (10, 10, False),
                                         (11, 4, True), (5, 2, True)])
def test_ensemble_folds_like_jax(tmp_path, n, k, augment):
    """Fold bounds and the train/validation views of every fold: the JAX
    package's, from h5 and from arrays; the views share the stack."""
    h5 = str(tmp_path / "training.h5")
    a = make_synthetic_h5(h5, n_images=n, image_size=24, max_cells=4, seed=n)
    j = JEnsembleSource(h5, k=k, augment=augment, seed=1)
    ours = (EnsembleSource(h5, k=k, augment=augment, seed=1),
            EnsembleSource.from_arrays(a["images"], a["organs"], a["counts"], k=k,
                                       augment=augment, seed=1))
    for t in ours:
        assert t._bounds == j._bounds and t._bounds[-1] == (4 if augment else 1) * n
        sizes = np.diff(t._bounds)
        assert sizes.max() - sizes.min() <= 1 and list(sizes) == sorted(sizes, reverse=True)
        for i in range(k):
            for tv, jv in zip(t.fold(i), j.fold(i)):
                assert tv.images is t.data.images
                for key in ("base_idx", "flip_code", "labels", "cls_labels"):
                    np.testing.assert_array_equal(getattr(tv, key), getattr(jv, key))
                assert tv.organs == jv.organs and tv.image_hw == jv.image_hw
                np.testing.assert_array_equal(tv.gather_images([0, len(tv) - 1]),
                                              jv.gather_images([0, len(jv) - 1]))


def _resnext(policy=None):
    kw = {} if policy is None else {"policy": policy}
    return MILNet(ResNetEncoder(Bottleneck, SIZES, groups=32, base_width=4, **kw), **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """train_ensemble (k = 2, 1 epoch, batch 4) then test_ensemble on its
    checkpoints, from h5 files, both on the CPU."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CST_PLATFORM", "cpu")
    mp.setitem(models._BUILDERS, NAME, lambda p: _resnext(p))
    d = tmp_path_factory.mktemp("ens")
    make_synthetic_h5(str(d / "training.h5"), n_images=8, image_size=64,
                      max_cells=12, seed=1)
    make_synthetic_h5(str(d / "test.h5"), n_images=6, image_size=64,
                      max_cells=12, seed=2, with_labels=False)
    out, res = str(d / "out"), str(d / "res")
    train_ensemble.main(["--data_path", str(d), "-E", NAME, "-e", str(EPOCHS),
                         "-B", "4", "-k", str(K), "-o", out, "--seed", "3", "--f32"])
    # one step leaves every count at 0: move each fold's count head so that
    # the counts differ by image and fold, and some means end in .5
    for i, path in enumerate(test_ensemble.ensemble_paths(out, EPOCHS)):
        ck = load_checkpoint(path)
        sd = ck["state_dict"]
        sd["fc_image_reg.7.weight"] = sd["fc_image_reg.7.weight"] * 40
        sd["fc_image_reg.7.bias"] = sd["fc_image_reg.7.bias"] + 3 + 2 * i
        torch.save(ck, path)
    test_ensemble.main(["-m", out, "-e", str(EPOCHS), "--data_path", str(d), "-B", "4",
                        "-o", res, "--f32"])
    yield d, out, res
    mp.undo()


def test_train_ensemble_writes_one_checkpoint_per_fold(run):
    _, out, _ = run
    names = sorted(f for f in os.listdir(out) if f.endswith(".ckpt"))
    assert names == [f"reg_pt1_{i}_{EPOCHS}epochs.ckpt" for i in range(K)]
    fresh = _resnext().state_dict()
    cks = [load_checkpoint(os.path.join(out, n)) for n in names]
    for ck in cks:
        assert (ck["mode"], ck["epoch"], ck["encoder"]) == ("image", EPOCHS, NAME)
        assert ck["step"] == 1  # 4 training images a fold at batch 4
        parts = {k.split(".", 1)[0] for k in ck["state_dict"]}
        assert parts == set(STAGE_SAVE_PARTITIONS["image"])
        assert ck["optimizer"]["state"]  # the fold's Adam moments
        # heads="reg": the count head trained, the class head not
        sd = ck["state_dict"]
        assert not torch.equal(sd["fc_image_reg.7.weight"], fresh["fc_image_reg.7.weight"])
    # a fresh model per fold, seeded seed + fold
    w = "encoder.layer2.0.conv2.weight"
    assert not torch.equal(cks[0]["state_dict"][w], cks[1]["state_dict"][w])
    assert sorted(glob.glob(os.path.join(out, f"*_{EPOCHS}epochs.ckpt"))) == \
        test_ensemble.ensemble_paths(out, EPOCHS)


def test_test_ensemble_csv_is_jax_mean_of_counts(run):
    """Each checkpoint's weights through the JAX package's inference_image,
    the counts averaged and rounded: the port CLI's CSV."""
    d, out, res = run
    jm = JMILNet(encoder=JEncoder(block_cls=JBottleneck, stage_sizes=SIZES,
                                  policy=J_F32, groups=32, base_width=4),
                 decoder_expansion=4, policy=J_F32)
    src = JTestSource(str(d / "test.h5"))
    step = jsteps.make_image_infer_step(jm)
    counts = []
    for path in test_ensemble.ensemble_paths(out, EPOCHS):
        tm = _resnext()
        tm.load_state_dict(load_checkpoint(path)["state_dict"], strict=False)
        params, stats = convert_milnet(_port_sd(tm), SIZES, True)
        counts.append(jinfer.inference_image(
            src, step, {"params": params, "batch_stats": stats}, batch_size=4)[1])
    want = np.asarray(counts).mean(axis=0).round().astype(int)
    mean = np.asarray(counts).mean(axis=0)
    assert len(set(want)) > 1 and (mean % 1 == 0.5).any()  # numpy rounds half to even
    (path,) = glob.glob(os.path.join(res, f"*-count-e{EPOCHS}.csv"))
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["id", "count", "organ"]
    assert rows[1:] == [[str(i + 1), str(c), o] for i, (c, o) in
                        enumerate(zip(want, src.organs))]
