"""The port's detection and output path held against ``cv2``, ``sklearn``
and the JAX package on numpy-seeded inputs, all of it exact:

- ``utils.images`` against ``cv2``: PNG files, filled circles, the JET
  colormap and the 50/50 blend, pixel-equal;
- the localization's smoothing against ``cv2``, bit-exact (the Gaussian
  blur over several sizes, masks and kernels; the normalized distance
  transform with and without background), DBSCAN's labels against
  sklearn's, ``meanshift_cluster`` against the JAX package (both methods,
  with and without ``cell_count``: the same kept and discarded centres);
- ``get_prf1`` and the meters, the overlays, dots and heatmaps against the
  JAX package (pixel-equal PNG files);
- ``MaskTestSource`` (ROI files and arrays, ``resume_from``, a small ROI,
  the h5 mode) and ``PointTestSource`` against the JAX package's;
- ``cell_detect`` driven on both sides by the same stub steps, which give
  fixed masks and counts: the same CSV rows (the strip's x offset, resume
  and the crash rollback included) and pixel-equal mask and dot PNGs;
- ``inference_seg``'s batching against the JAX package's.
"""

from __future__ import annotations

import csv
import functools
import glob
import os

import cv2
import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellsegmentation_tpu import infer as jinfer
from cellsegmentation_tpu.data.masks import MaskTestSource as JMaskTestSource
from cellsegmentation_tpu.data.masks import PointTestSource as JPointTestSource
from cellsegmentation_tpu.detect import cluster as jcluster
from cellsegmentation_tpu.detect import detect as jdetect
from cellsegmentation_tpu.detect import metrics as jdmetrics
from cellsegmentation_tpu.postprocess import masks as jmasks

from cellsegmentation_tpu_torch import infer as tinfer
from cellsegmentation_tpu_torch.data.masks import MaskTestSource, PointTestSource
from cellsegmentation_tpu_torch.detect import cluster as tcluster
from cellsegmentation_tpu_torch.detect import detect as tdetect
from cellsegmentation_tpu_torch.detect import metrics as tdmetrics
from cellsegmentation_tpu_torch.ops.tiles import tile_grid
from cellsegmentation_tpu_torch.postprocess import masks as tmasks
from cellsegmentation_tpu_torch.utils import images as timages

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)


@functools.lru_cache(maxsize=None)
def blob_mask(h, w, n, seed, smin=3.0, smax=8.0):
    """uint8 [h, w]: the max of n Gaussian blobs at seeded centres, each
    drawn within 5 sigma of its centre."""
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.float32)
    for _ in range(n):
        cy, cx, s = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(smin, smax)
        y0, y1 = max(int(cy - 5 * s), 0), min(int(cy + 5 * s) + 1, h)
        x0, x1 = max(int(cx - 5 * s), 0), min(int(cx + 5 * s) + 1, w)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        g = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        m[y0:y1, x0:x1] = np.maximum(m[y0:y1, x0:x1], g)
    out = (255 * m).astype(np.uint8)
    out.flags.writeable = False
    return out


MASKS = {
    "blobs_600x900": lambda: blob_mask(600, 900, 150, 1),
    "noise_37x53": lambda: np.random.default_rng(0).integers(0, 256, (37, 53)).astype(np.uint8),
    "binary_64x80": lambda: ((np.random.default_rng(1).random((64, 80)) > 0.7) * 255).astype(np.uint8),
    "blobs_20x17": lambda: blob_mask(20, 17, 3, 5),
}


# ---------------------------------------------------------------------------
# utils.images against cv2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 9), (31, 20, 3)])
def test_png_decodes_like_cv2_imwrite(shape, tmp_path):
    img = np.random.default_rng(2).integers(0, 256, shape).astype(np.uint8)
    timages.write_png(str(tmp_path / "p.png"), img)
    bgr = img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    cv2.imwrite(str(tmp_path / "c.png"), bgr)
    for name in ("p.png", "c.png"):
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED), bgr)
    np.testing.assert_array_equal(timages.read_png(str(tmp_path / "p.png")), img)


def test_filled_circles_like_cv2():
    """Radii 0-8 at centres inside, on and outside every border."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        h, w = rng.integers(5, 40, 2)
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        want = img.copy()
        cx, cy, r = int(rng.integers(-6, w + 6)), int(rng.integers(-6, h + 6)), int(rng.integers(0, 9))
        cv2.circle(want, (cx, cy), r, (255, 0, 0), cv2.FILLED)
        np.testing.assert_array_equal(timages.fill_circle(img, (cx, cy), r, (255, 0, 0)), want)


def test_jet_and_blend_like_cv2():
    a = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    np.testing.assert_array_equal(timages.apply_jet(a), cv2.applyColorMap(a, cv2.COLORMAP_JET))
    rgb = np.stack([a, a.T, 255 - a], axis=-1)
    jet = cv2.applyColorMap(a.T.copy(), cv2.COLORMAP_JET)
    np.testing.assert_array_equal(timages.add_weighted_half(rgb, jet),
                                  cv2.addWeighted(rgb, 0.5, jet, 0.5, 0))


# ---------------------------------------------------------------------------
# the localization
# ---------------------------------------------------------------------------


def test_gaussian_kernel_is_opencvs():
    np.testing.assert_array_equal(tcluster.gaussian_kernel_u8(15, 3),
                                  [2, 5, 9, 14, 21, 27, 33, 34, 33, 27, 21, 14, 9, 5, 2])


@pytest.mark.parametrize("name", sorted(MASKS))
def test_blur_bit_exact_against_cv2(name):
    mask = MASKS[name]()
    for ksize, sigma in [((15, 15), 3), ((5, 5), 1.0), ((7, 3), 2.0), ((9, 9), 0),
                         ((3, 3), 0), ((31, 31), 6.5)]:
        if min(mask.shape) <= max(ksize) // 2 or (mask.size > 1e5 and ksize != (15, 15)):
            continue
        np.testing.assert_array_equal(
            tcluster.gaussian_blur_u8(mask, ksize=ksize, sigmaX=sigma),
            cv2.GaussianBlur(mask, ksize, sigma), err_msg=f"{ksize} {sigma}")
    with pytest.raises(ValueError, match="borderType"):
        tcluster.gaussian_blur_u8(mask, ksize=(5, 5), sigmaX=1, borderType=0)


def _cv2_normalized(d):
    """cv2's min-max normalization of a raw distance map, x255, rounded."""
    d = cv2.normalize(d, d, 0, 1, cv2.NORM_MINMAX) * 255
    return np.round(d).astype(np.uint8)


def _cv2_dt(binary):
    return _cv2_normalized(cv2.distanceTransform(
        np.asarray(binary * 255, np.uint8), cv2.DIST_L2, cv2.DIST_MASK_PRECISE))


@pytest.mark.parametrize("name", sorted(MASKS) + ["all_background"])
def test_distance_transform_like_cv2(name):
    binary = (np.zeros((30, 40), bool) if name == "all_background"
              else MASKS[name]() > 10)
    np.testing.assert_array_equal(tcluster.distance_transform_u8(binary), _cv2_dt(binary))


@pytest.mark.parametrize("shape", [(30, 30), (7, 9), (64, 64), (30, 40)])
def test_distance_transform_without_background(shape):
    """No background pixel: every distance is undefined. The port gives 0
    everywhere, the normalization of a uniform value. cv2 fills in a
    sentinel that is no distance, and which one depends on the shape, its
    SIMD path, its thread count and what ran before it in the process (on
    some calls two of them across its blocks, so two calls on one mask can
    differ). Nothing is asserted of the sentinel itself: where one call's
    raw output, on a thread count pinned here, is one finite value, its
    normalization must be the port's."""
    binary = np.ones(shape, bool)
    got = tcluster.distance_transform_u8(binary)
    assert got.shape == shape and got.dtype == np.uint8 and not got.any()
    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    try:
        raw = cv2.distanceTransform(np.full(shape, 255, np.uint8), cv2.DIST_L2,
                                    cv2.DIST_MASK_PRECISE)
    finally:
        cv2.setNumThreads(threads)
    if len(np.unique(raw)) == 1 and np.isfinite(raw).all():
        np.testing.assert_array_equal(got, _cv2_normalized(raw))


def test_dbscan_labels_like_sklearn():
    from sklearn.cluster import DBSCAN

    for seed, eps in [(0, 15), (1, 15), (2, 4.0), (3, 30)]:
        pts = np.random.default_rng(seed).integers(0, 200, (300, 2))
        np.testing.assert_array_equal(tcluster.dbscan_labels(pts, eps),
                                      DBSCAN(eps=eps, min_samples=1).fit_predict(pts))


@pytest.mark.parametrize("method", ["gaussianblur", "distancetransform"])
@pytest.mark.parametrize("cell_count", [None, 0, 7, 1000])
def test_meanshift_cluster_like_jax(method, cell_count):
    """The same kept and discarded centres, in the same order."""
    for mask in (blob_mask(240, 320, 40, 7), blob_mask(60, 90, 6, 8, 2, 4),
                 np.zeros((40, 40), np.uint8), np.zeros((10, 40), np.uint8)):
        want = jcluster.meanshift_cluster(mask, method, cell_count)
        got = tcluster.meanshift_cluster(mask, method, cell_count)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(got[0]) + len(got[1]) == 0


def test_prf1_and_meters_like_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        gt = rng.integers(0, 100, (rng.integers(0, 12), 2))
        pred = rng.integers(0, 100, (rng.integers(0, 12), 2))
        assert tdmetrics.get_prf1(pred, gt) == jdmetrics.get_prf1(pred, gt)
    tm, jm = tdmetrics.MetricGroup(), jdmetrics.MetricGroup()
    for v in rng.random((5, 4)):
        tm.update(v)
        jm.update(v)
    assert tm.avg() == jm.avg() and tm.val() == jm.val()
    assert tdmetrics.AverageMeter().avg == 0.0


# ---------------------------------------------------------------------------
# the output images against the JAX package's
# ---------------------------------------------------------------------------


def _pngs(root):
    return {os.path.relpath(p, root): cv2.imread(p, cv2.IMREAD_UNCHANGED)
            for p in sorted(glob.glob(os.path.join(root, "**", "*.png"), recursive=True))}


def _same_pngs(a, b):
    pa, pb = _pngs(a), _pngs(b)
    assert sorted(pa) == sorted(pb) and pa
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def _rgb(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3)).astype(np.uint8)


def test_heatmap_like_jax(tmp_path):
    imgs = _rgb(3, 40, 50, 5)
    coords = tile_grid(40, 50, 16, 5)
    rng = np.random.default_rng(6)
    keep = rng.random((3, len(coords))) > 0.7
    groups, idx = np.nonzero(keep)
    probs = rng.random(len(groups)).astype(np.float32)
    for lib, d in ((jmasks, "jax"), (tmasks, "port")):
        lib.heatmap(imgs, groups, coords[idx], probs, 16, str(tmp_path / d),
                    csv_path=str(tmp_path / f"{d}.csv"))
    _same_pngs(tmp_path / "jax", tmp_path / "port")
    assert (tmp_path / "jax.csv").read_text() == (tmp_path / "port.csv").read_text()


@pytest.mark.parametrize("soft", [False, True])
def test_mask_overlays_like_jax(soft, tmp_path):
    imgs = _rgb(2, 30, 40, 7)
    masks = np.random.default_rng(8).random((2, 30, 40)).astype(np.float32)
    for lib, d in ((jmasks, "jax"), (tmasks, "port")):
        lib.save_images_with_masks(list(imgs), list(masks), 0.4, str(tmp_path / d),
                                   soft=soft, start_index=3)
        got = lib.overlap_mask(imgs[0], masks[0] > 0.5, postprocess=True,
                               min_object_size=5, hole_area_threshold=3,
                               save=str(tmp_path / d / "ovl.png"))
        lib.save_images(imgs, ["colon_0", "breast_1"], [3, 4], "train",
                        str(tmp_path / d / "h5"))
    _same_pngs(tmp_path / "jax", tmp_path / "port")
    np.testing.assert_array_equal(
        got, jmasks.overlap_mask(imgs[0], masks[0] > 0.5, True, 5, 3))


def test_dots_like_jax():
    img = _rgb(1, 30, 40, 9)[0]
    kept = np.asarray([[3, 4], [29, 39], [15, 0], [-2, 20]])
    gone = np.asarray([[10, 10], [0, 38]])
    np.testing.assert_array_equal(tmasks.locate_cells(img.copy(), kept, gone),
                                  jmasks.locate_cells(img.copy(), kept, gone))
    np.testing.assert_array_equal(tmasks.dotting(img.copy(), kept, 3, (1, 2, 3)),
                                  jmasks.dotting(img.copy(), kept, 3, (1, 2, 3)))


def test_crop_wsi_like_jax(tmp_path):
    big = _rgb(1, 20, 60, 10)[0]
    for d in ("jax", "port"):
        os.makedirs(tmp_path / d)
        cv2.imwrite(str(tmp_path / d / "slide.png"), big)
        cv2.imwrite(str(tmp_path / d / "small.png"), big[:2, :2])
    size = os.path.getsize(tmp_path / "jax" / "slide.png")
    jmasks.crop_wsi(str(tmp_path / "jax"), max_size=size // 3)
    tmasks.crop_wsi(str(tmp_path / "port"), max_size=size // 3)
    assert len(_pngs(tmp_path / "jax")) > 6
    _same_pngs(tmp_path / "jax", tmp_path / "port")


# ---------------------------------------------------------------------------
# the test sources
# ---------------------------------------------------------------------------

ROI_NAMES = ("small.png", "roi_1.png", "slideA-300.png", "roi_7.jpg")
PS = 64


def _roi_images(seed=11):
    """ROI images with dark blobs (the stub seg step's cells): one smaller
    than a patch, the others spanning a few patches."""
    shapes = [(40, 50), (100, 150), (130, 90), (70, 70)]
    out = []
    for i, (h, w) in enumerate(shapes):
        img = _rgb(1, h, w, seed + i)[0] // 4 + 150
        img[..., 2] = 255 - blob_mask(h, w, h * w // 700, seed + i)
        out.append(img)
    return out


@pytest.fixture(scope="module")
def roi_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("roi")
    imgs = _roi_images()
    for name, img in zip(ROI_NAMES, imgs):
        cv2.imwrite(str(d / name), cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 100])
    return str(d), imgs


def _same_source(t, j):
    assert t.mode == j.mode and t.files == j.files
    assert t.patch_index == j.patch_index
    assert [tuple(s) for s in t.image_sizes] == [tuple(s) for s in j.image_sizes]
    for i in range(len(j)):
        np.testing.assert_array_equal(t.get_patch(i), j.get_patch(i))
    for fi in range(len(j.files)):
        np.testing.assert_array_equal(t.load_file(fi), j.load_file(fi))


@pytest.mark.parametrize("resume_from", [None, "roi_1.png", "nothing.png"])
def test_mask_test_source_like_jax(roi_dir, resume_from):
    d, _ = roi_dir
    j = JMaskTestSource(d, patch_size=PS, resume_from=resume_from)
    t = MaskTestSource(d, patch_size=PS, resume_from=resume_from)
    _same_source(t, j)
    if resume_from is None:
        assert j.files[0] == "small.png" and j.patch_index[0] == (0, 0, 0)
        assert t.get_patch(0)[40:].max() == 0  # the small ROI, zero-padded
        # arrays of the files' pixels make the same source
        pix = [j.load_file(i) for i in range(len(j.files))]
        _same_source(MaskTestSource.from_arrays(pix, j.files, patch_size=PS), j)
        assert MaskTestSource(d, patch_size=PS, num_of_imgs=2).files == j.files[:2]


def test_mask_test_source_h5_mode(tmp_path):
    path = str(tmp_path / "test.h5")
    imgs = _rgb(3, 64, 64, 12)
    with h5py.File(path, "w") as f:
        f["x"] = imgs
        f["organ"] = np.asarray([b"colon_0", b"breast_1", b"colon_2"])
    j = JMaskTestSource(path, patch_size=PS, num_of_imgs=2)
    t = MaskTestSource(path, patch_size=PS, num_of_imgs=2)
    _same_source(t, j)
    assert t.files == ["00001.h5img", "00002.h5img"] and t.organs == j.organs


def test_point_test_source_like_jax(tmp_path):
    root = tmp_path / "points_root"
    for sub in ("images", "masks", "points"):
        os.makedirs(root / sub)
    imgs = _rgb(3, 32, 40, 13)
    names = ["im_10.png", "im_2.png", "im_3.png"]
    for i, n in enumerate(names):
        cv2.imwrite(str(root / "images" / n), imgs[i])
        cv2.imwrite(str(root / "masks" / n), (imgs[i, ..., 0] > 128).astype(np.uint8) * 255)
        if i != 2:
            np.savetxt(root / "points" / n.replace(".png", ".tsv"),
                       np.asarray([[3, 4], [10, 20]]) + i, delimiter="\t", fmt="%d")
    (root / "image_type.csv").write_text("im_2.png,breast,clustered\nim_10.png,colon,regular\n")
    j = JPointTestSource(str(root))
    t = PointTestSource(str(root))
    assert t.names == j.names == ["im_2.png", "im_3.png", "im_10.png"]
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.masks, j.masks)
    for a, b in zip(t.points, j.points):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert (t.cancer_types, t.area_types) == (j.cancer_types, j.area_types)
    arr = PointTestSource.from_arrays(j.names, j.images, j.points, j.masks,
                                      j.cancer_types, j.area_types)
    np.testing.assert_array_equal(arr.masks, j.masks)
    assert arr.image_hw == t.image_hw == (32, 40)


# ---------------------------------------------------------------------------
# cell_detect with stub steps
# ---------------------------------------------------------------------------


def _stub_masks(patches):
    """P(positive) per pixel: the blue channel's darkness, squared."""
    p = (255 - np.asarray(patches)[..., 2].astype(np.float32)) / 255.0
    return (p * p).astype(np.float32)


def _stub_counts(patches):
    """The patch's blob count, roughly, from its darkness: a float whose
    rounding is exact on both sides."""
    p = np.asarray(patches)[..., 2].astype(np.int64)
    return ((255 - p).sum(axis=(1, 2)) % 997 / 83.0).astype(np.float32)


class _Stubs:
    """Seg and image steps on both sides that compute the stub values; the
    seg steps raise at call ``fail_at`` (0-based) when it is set."""

    def __init__(self, fail_at=None):
        self.fail_at, self.calls = fail_at, {"jax": 0, "port": 0}

    def _seg(self, side, patches):
        if self.calls[side] == self.fail_at:
            raise RuntimeError("planted crash")
        self.calls[side] += 1
        return _stub_masks(patches)

    def jseg(self, variables, images, flip):
        return jnp.asarray(self._seg("jax", images))

    def jimage(self, variables, images, flip):
        return None, jnp.asarray(_stub_counts(images))

    def tseg(self, images, flip):
        return torch.from_numpy(self._seg("port", images.numpy()))

    def timage(self, images, flip):
        return None, torch.from_numpy(_stub_counts(images.numpy()))


def _detect_both(stubs, jsrc, tsrc, tmp_path, **kw):
    j = jdetect.cell_detect(jsrc, stubs.jseg, stubs.jimage, None,
                            output_path=str(tmp_path / "jax"), **kw)
    t = tdetect.cell_detect(tsrc, stubs.tseg, stubs.timage,
                            output_path=str(tmp_path / "port"), device="cpu", **kw)
    return j, t


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("method,output_image",
                         [("gaussianblur", True), ("distancetransform", False)])
def test_cell_detect_like_jax(roi_dir, method, output_image, tmp_path):
    d, _ = roi_dir
    j, t = _detect_both(_Stubs(), JMaskTestSource(d, patch_size=PS),
                        MaskTestSource(d, patch_size=PS), tmp_path, batch_size=3,
                        output_image=output_image, method=method)
    rows = _csv_rows(t)
    assert rows == _csv_rows(j) and rows[0] == ["image_id", "x", "y"]
    bases = {r[0] for r in rows[1:]}
    assert "slideA" in bases and "slideA-300" not in bases and len(rows) > 10
    # the strip's rows carry its x offset
    assert min(int(r[1]) for r in rows[1:] if r[0] == "slideA") >= 300
    _same_pngs(tmp_path / "jax" / "detect", tmp_path / "port" / "detect")
    n_png = 2 * len(ROI_NAMES) if output_image else len(ROI_NAMES)
    assert len(_pngs(tmp_path / "port" / "detect")) == n_png


def test_cell_detect_rollback_and_resume_like_jax(roi_dir, tmp_path, capsys):
    """A crash in the 4th patch batch (image roi_1 under way) drops its
    rows on both sides; resuming from it appends the rest to the same CSV,
    which then equals an uninterrupted run's."""
    d, _ = roi_dir
    kw = dict(batch_size=2, output_image=False)
    j, t = _detect_both(_Stubs(fail_at=3), JMaskTestSource(d, patch_size=PS),
                        MaskTestSource(d, patch_size=PS), tmp_path, **kw)
    rows = _csv_rows(t)
    assert rows == _csv_rows(j) and "planted crash" in capsys.readouterr().err
    assert {r[0] for r in rows[1:]} == {"small"}
    j2, t2 = _detect_both(_Stubs(), JMaskTestSource(d, patch_size=PS, resume_from="roi_1.png"),
                          MaskTestSource(d, patch_size=PS, resume_from="roi_1.png"),
                          tmp_path, resume=True, **kw)
    assert (t2, j2) == (t, j)
    full_j, full_t = _detect_both(_Stubs(), JMaskTestSource(d, patch_size=PS),
                                  MaskTestSource(d, patch_size=PS), tmp_path / "full", **kw)
    assert _csv_rows(t2) == _csv_rows(j2) == _csv_rows(full_t) == _csv_rows(full_j)


def test_cell_detect_from_arrays(roi_dir, tmp_path):
    """A source from arrays gives the file source's CSV and PNGs."""
    d, _ = roi_dir
    src = MaskTestSource(d, patch_size=PS)
    pix = [src.load_file(i) for i in range(len(src.files))]
    arr = MaskTestSource.from_arrays(pix, src.files, patch_size=PS)
    s = _Stubs()
    a = tdetect.cell_detect(src, s.tseg, s.timage, output_path=str(tmp_path / "a"),
                            device="cpu")
    b = tdetect.cell_detect(arr, s.tseg, s.timage, output_path=str(tmp_path / "b"),
                            device="cpu")
    assert _csv_rows(a) == _csv_rows(b)
    _same_pngs(tmp_path / "a" / "detect", tmp_path / "b" / "detect")
    assert tdetect._strip_offset("a-b-12") == ("a-b-12", 0)
    assert tdetect._strip_offset("slide-77") == ("slide", 77)


# ---------------------------------------------------------------------------
# inference_seg
# ---------------------------------------------------------------------------


def test_inference_seg_like_jax():
    """Five 32x40 images at batch 2 (an uneven last batch), two flipped,
    through seg steps on both sides that compute the same stub map of each
    image and flip code: equal [N, H, W] f32 outputs. The seg step itself
    is held against the JAX package's in test_torch_port_stage3.py."""
    def stub(images, flip):
        x = np.asarray(images)[..., 1].astype(np.float32)
        return (x / 255.0 + np.asarray(flip, np.float32)[:, None, None]) / 4

    src = PointTestSource.from_arrays(list("abcde"), _rgb(5, 32, 40, 14), [None] * 5)
    src.flip_code = np.asarray([0, 2, 0, 3, 0], np.int32)
    want = jinfer.inference_seg(
        src, lambda v, im, f: jnp.asarray(stub(im, f)), None, batch_size=2)
    got = tinfer.inference_seg(
        src, lambda im, f: torch.from_numpy(stub(im, f)), batch_size=2)
    assert got.shape == (5, 32, 40) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
