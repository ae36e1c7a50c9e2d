"""The port's ``train_stage3`` held against the JAX package's for two epochs
on the same weights and masks, its exact resume after an interrupt, its
files, the mask flips, and ``MaskDataSource`` from arrays, an h5 file and a
PNG mask directory.

The model and the weight perturbation are ``tests/test_torch_port_stage3.py``'s
(a full-width Bottleneck MILNet, stage sizes (1, 1, 1, 1), at 64^2), in f32.
Six images at batch 4: two steps an epoch, the second with two padded rows;
augmentation on, so both sides draw the same flips from
``default_rng(seed + epoch)`` and flip the masks with their images.
"""

from __future__ import annotations

import csv
import glob
import os

import jax
import numpy as np
import pytest
import torch

from cellsegmentation_tpu.core.dtypes import F32_POLICY as J_F32
from cellsegmentation_tpu.data.masks import MaskDataSource as JMaskSource
from cellsegmentation_tpu.models import init_variables
from cellsegmentation_tpu.train.trainers import train_stage3 as jtrain_stage3
from cellsegmentation_tpu.utils.logging import RunLogger as JLogger

from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
from cellsegmentation_tpu_torch.data import MaskDataSource, make_synthetic_h5
from cellsegmentation_tpu_torch.data.batches import flip_images
from cellsegmentation_tpu_torch.postprocess.masks import save_mask_pairs
from cellsegmentation_tpu_torch.train import checkpoint as tckpt
from cellsegmentation_tpu_torch.train.trainers import flip_masks, train_stage3
from cellsegmentation_tpu_torch.utils.jax_weights import jax_to_state_dict
from cellsegmentation_tpu_torch.utils.logging import RunLogger

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_stage3 import HW, _jax_model, _port_model, _rel, perturb

N, BATCH, EPOCHS, SEED, LR = 6, 4, 2, 5, 5e-5


def _masks(n, seed=3):
    """Asymmetric 0/1 masks: a few random rectangles each."""
    rng = np.random.default_rng(seed)
    m = np.zeros((n, HW, HW), np.uint8)
    for i in range(n):
        for _ in range(3):
            x, y = rng.integers(0, HW - 12, 2)
            h, w = rng.integers(6, 24, 2)
            m[i, x:x + h, y:y + w] = 1
    return m


class _InterruptAfter(RunLogger):
    """A logger that raises KeyboardInterrupt as epoch ``n``'s CSV row is
    written, as a ^C there would."""

    def __init__(self, out, n):
        super().__init__(out, tensorboard=False)
        self.n = n

    def csv_row(self, stream, header, row):
        super().csv_row(stream, header, row)
        if row[0] == self.n:
            raise KeyboardInterrupt


def _state_dict(model):
    return {k: x.detach().clone() for k, x in model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run, the port's straight run, and the port's run interrupted
    after epoch 1 and resumed from its pt3 file in a fresh model."""
    v = perturb(init_variables(_jax_model(J_F32), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (N, HW, HW, 3)).astype(np.uint8)
    masks = _masks(N)
    d = tmp_path_factory.mktemp("stage3")
    kw = dict(epochs=EPOCHS, batch_size=BATCH, lr=LR, seed=SEED, encoder_name="resnet50")

    jsrc = JMaskSource.__new__(JMaskSource)
    jsrc.images, jsrc.masks, jsrc.augment = images, masks, True
    jres = jtrain_stage3(_jax_model(J_F32), v, jsrc, output_dir=str(d / "jax"),
                         logger=JLogger(str(d / "jax"), tensorboard=False), **kw)

    src = MaskDataSource.from_arrays(images, masks, augment=True)
    model = _port_model(F32_POLICY, v)
    res = train_stage3(model, src, output_dir=str(d / "port"), device="cpu",
                       logger=RunLogger(str(d / "port"), tensorboard=False), **kw)

    first = _port_model(F32_POLICY, v)
    with pytest.raises(KeyboardInterrupt):
        train_stage3(first, src, output_dir=str(d / "cut"), device="cpu",
                     logger=_InterruptAfter(str(d / "cut"), 1), **kw)
    ck = tckpt.load_checkpoint(str(d / "cut" / "pt3_1epochs.ckpt"))
    resumed = _port_model(F32_POLICY, v)
    tckpt.restore_into(resumed, ck)
    res2 = train_stage3(resumed, src, output_dir=str(d / "cut"), device="cpu",
                        logger=RunLogger(str(d / "cut"), tensorboard=False),
                        last_epoch=int(ck["epoch"]),
                        resume_opt_state=ck["optimizer"], **kw)
    return dict(v=v, d=d, jres=jres, model=model, res=res, ck=ck,
                resumed=resumed, res2=res2)


def _csv(out, stream):
    (path,) = glob.glob(os.path.join(out, f"*-{stream}.csv"))
    with open(path) as f:
        return list(csv.reader(f))


# Two epochs (four updates) of Adam at the CLI's lr 5e-5 (measured in
# brackets): the per-epoch losses within 5e-4 relative (<= 4.4e-5); the
# encoder's running statistics within 1e-4 of each entry's largest value
# (3.4e-6); the decoder's within 1e-2 (2.5e-3): its parameters feed them,
# and Adam's sign ties (tests/test_torch_port_stage3.py) move those by
# 2 lr an update. The decoder's parameter updates: relative L2 gap at most
# 0.1 (2.6e-2), at most 0.5% of the entries more than lr / 2 apart (0.1%),
# every entry within 2 lr per update.
def test_train_stage3_matches_jax(runs):
    d = runs["d"]
    jrows, trows = _csv(str(d / "jax"), "seg-training"), _csv(str(d / "port"), "seg-training")
    assert trows[0] == jrows[0] == ["epoch", "seg_loss_ce", "seg_loss_dice"]
    assert [r[0] for r in trows[1:]] == ["1", "2"]
    for tr, jr in zip(trows[1:], jrows[1:]):
        np.testing.assert_allclose(np.float64(tr[1:]), np.float64(jr[1:]), rtol=5e-4)
    np.testing.assert_allclose(runs["res"].last_loss, runs["jres"].last_loss, rtol=5e-4)
    assert [st["steps"] for st in runs["res"].epoch_stats] == [2, 2]
    js = runs["jres"].state
    want = {k: x.numpy() for k, x in jax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))[0].items()}
    before = {k: x.numpy() for k, x in jax_to_state_dict(runs["v"])[0].items()}
    got = {k: x.numpy() for k, x in runs["model"].state_dict().items()}
    for k in want:
        if "running_" in k:
            tol = 1e-4 if k.startswith("encoder.") else 1e-2
            assert _rel(got[k], want[k]) <= tol, (k, _rel(got[k], want[k]))
        elif not k.startswith("seg_decoder."):
            assert np.array_equal(got[k], before[k]) and np.array_equal(want[k], before[k]), k
    keys = [k for k in want if k.startswith("seg_decoder.") and "running_" not in k]
    ut = np.concatenate([(got[k] - before[k]).ravel() for k in keys])
    uj = np.concatenate([(want[k] - before[k]).ravel() for k in keys])
    assert np.linalg.norm(ut - uj) / np.linalg.norm(uj) <= 0.1
    assert float((np.abs(ut - uj) > LR / 2).mean()) <= 5e-3
    assert np.abs(ut - uj).max() <= 2 * LR * 4 * (1 + 1e-3)
    assert np.abs(ut).max() > 0


def test_train_stage3_files(runs):
    """pt3 at the last epoch only, with every partition, the step count and
    Adam's state; the JAX run writes its own pt3 there too."""
    d = runs["d"]
    assert [os.path.basename(p) for p in glob.glob(str(d / "port" / "*.ckpt"))] == \
        ["pt3_2epochs.ckpt"]
    ck = tckpt.load_checkpoint(str(d / "port" / "pt3_2epochs.ckpt"))
    assert ck["mode"] == "segment" and ck["epoch"] == 2 and ck["step"] == 4
    assert ck["encoder"] == "resnet50" and ck["optimizer"]["state"]
    parts = {k.split(".", 1)[0] for k in ck["state_dict"]}
    assert parts == {"encoder", "fc_tile", "fc_image_cls", "fc_image_reg", "seg_decoder"}
    assert os.path.exists(d / "jax" / "pt3_2epochs.ckpt")


def test_train_stage3_interrupt_and_exact_resume(runs):
    """^C after epoch 1 writes pt3_1epochs (step 2); a fresh model resumed
    from it ends bit-equal to the straight run, statistics included."""
    ck = runs["ck"]
    assert ck["epoch"] == 1 and ck["step"] == 2 and ck["mode"] == "segment"
    assert runs["res2"].state.step == runs["res"].state.step == 4
    assert [st["steps"] for st in runs["res2"].epoch_stats] == [2]
    a, b = _state_dict(runs["model"]), _state_dict(runs["resumed"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert runs["res2"].last_loss == runs["res"].last_loss


def test_flip_masks_follow_flip_images():
    """An asymmetric mask painted into an image's channel 0: after
    ``flip_images`` by each code, the painted pixels are the
    ``flip_masks`` ones (1 reverses W, 2 reverses H)."""
    m = _masks(1)[0]
    m[:5, :3] = 1  # a corner, so no flip maps the mask onto itself
    img = np.repeat((m * 255)[None, ..., None], 3, axis=-1).astype(np.uint8)
    for code in range(4):
        flipped = flip_images(torch.from_numpy(img), torch.tensor([code]))
        got = flip_masks(m[None], np.asarray([code]))[0]
        np.testing.assert_array_equal(flipped[0, ..., 0].numpy() > 0, got > 0)
        assert code == 0 or not np.array_equal(got, m)
    np.testing.assert_array_equal(flip_masks(m[None], np.asarray([1]))[0], m[:, ::-1])
    np.testing.assert_array_equal(flip_masks(m[None], np.asarray([2]))[0], m[::-1])


def test_mask_source_from_arrays_h5_and_pngs(tmp_path):
    """The same source from arrays, from an h5 file with a mask array, and
    from an h5 file with a PNG mask directory (as the JAX package reads
    it), with ``num_of_imgs``; a count mismatch raises."""
    arrays = make_synthetic_h5(str(tmp_path / "training.h5"), n_images=5,
                               image_size=32, max_cells=4, seed=1)
    masks = _masks(5)[:, :32, :32]
    save_mask_pairs(str(tmp_path / "pm"), np.arange(5), arrays["images"], masks)
    a = MaskDataSource.from_arrays(arrays["images"], masks * 3, arrays["organs"],
                                   arrays["counts"], augment=True)
    b = MaskDataSource(str(tmp_path / "training.h5"), masks)
    c = MaskDataSource(str(tmp_path / "training.h5"), str(tmp_path / "pm"))
    j = JMaskSource(str(tmp_path / "training.h5"), str(tmp_path / "pm"))
    for s in (a, b, c):
        np.testing.assert_array_equal(s.masks, masks)
        np.testing.assert_array_equal(s.masks, j.masks)
        np.testing.assert_array_equal(s.images, j.images)
        assert s.masks.dtype == np.uint8 and len(s) == 5 and s.image_hw == (32, 32)
        assert list(s.base_idx) == list(range(5)) and not s.flip_code.any()
    np.testing.assert_array_equal(b.labels, j.labels)
    assert a.augment and not b.augment
    assert len(MaskDataSource(str(tmp_path / "training.h5"), str(tmp_path / "pm"),
                              num_of_imgs=3)) == 3
    with pytest.raises(ValueError, match="4 masks for 5 images"):
        MaskDataSource.from_arrays(arrays["images"], masks[:4])
