"""The port stands alone and never hides a missing card.

- No module of ``cellsegmentation_tpu_torch`` and no line of
  ``chip_smoke.py`` or ``tools/sm90_tile_shapes.py`` imports ``jax``,
  ``flax``, ``msgpack`` (the card's machine has none; the port reads and
  writes flax's msgpack itself) or the JAX package.
- Entry points run on the CUDA card by default: without one they raise,
  unless the caller passes ``device="cpu"``; the CLIs, unless
  ``CST_PLATFORM=cpu`` is set.
- ``chip_smoke.py`` without a card (or without the package beside it) exits
  non-zero and prints no result line; so does the benchmark
  (``python -m cellsegmentation_tpu_torch.bench``), which has no CPU
  fallback.
- Detection and the evaluation outputs import neither ``cv2`` nor
  ``sklearn``, which the card's machine lacks: no import of them in their
  modules, and the localization, detection from arrays and the heatmaps
  run with both unimportable.
"""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cellsegmentation_tpu_torch.cli import test_count, train_image
from cellsegmentation_tpu_torch.core.device import resolve_device
from cellsegmentation_tpu_torch.data import LystoDataSource
from cellsegmentation_tpu_torch.infer import sample_topk
from cellsegmentation_tpu_torch.models import Bottleneck, MILNet, ResNetEncoder, build_model
from cellsegmentation_tpu_torch.models.milnet import init_milnet
from cellsegmentation_tpu_torch.ops.tiles import tile_grid
from cellsegmentation_tpu_torch.train.schedules import make_schedule
from cellsegmentation_tpu_torch.train.state import create_train_state
from cellsegmentation_tpu_torch.train.steps import (
    make_image_infer_step,
    make_image_train_step,
    make_stack_tile_infer_step,
    make_tile_infer_step,
    make_tile_train_step,
)
from cellsegmentation_tpu_torch.train.trainers import train_stage1, train_stage2

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "cellsegmentation_tpu")


def _imported_roots(path: Path) -> list[tuple[int, str]]:
    """(line, top-level module) of every import statement in ``path``,
    at any depth (lazy imports inside functions included)."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module.split(".")[0]))
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.append((node.lineno, str(node.args[0].value).split(".")[0]))
    return out


def _port_files() -> list[Path]:
    files = sorted((ROOT / "cellsegmentation_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "tools" / "sm90_tile_shapes.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax(path):
    bad = [(ln, mod) for ln, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_check_covers_parallel_and_the_converter():
    rel = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"cellsegmentation_tpu_torch/parallel/multihost.py",
            "cellsegmentation_tpu_torch/parallel/mesh.py",
            "cellsegmentation_tpu_torch/parallel/sharding.py",
            "cellsegmentation_tpu_torch/utils/torch_convert.py"} <= rel


def test_import_check_covers_the_benchmark():
    rel = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {f"cellsegmentation_tpu_torch/bench/{m}.py" for m in (
        "__init__", "__main__", "common", "faults", "gates", "host", "reference", "roofline",
        "spread", "stage1", "sweep", "tracing")} <= rel


def test_import_check_covers_the_checkpoint_readers():
    rel = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {f"cellsegmentation_tpu_torch/{m}.py" for m in (
        "utils/flax_msgpack", "utils/jax_weights", "train/checkpoint")} <= rel


def test_jax_checkpoints_need_no_msgpack_flax_or_jax(tmp_path):
    """In a process where msgpack, flax, jax, optax and the JAX package
    cannot be imported, the port writes a JAX-format pt1 with its Adam
    state, reads it back into a fresh model and resumes the optimizer."""
    code = (
        "import sys, warnings\n"
        "for m in ('msgpack', 'flax', 'jax', 'jaxlib', 'optax', 'cellsegmentation_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from cellsegmentation_tpu_torch.models import build_model\n"
        "from cellsegmentation_tpu_torch.train import checkpoint as ck\n"
        "from cellsegmentation_tpu_torch.train.schedules import make_schedule\n"
        "from cellsegmentation_tpu_torch.train.state import create_train_state\n"
        "from cellsegmentation_tpu_torch.train.trainers import _restore_optimizer\n"
        "warnings.simplefilter('error')\n"
        "m = build_model('resnet18', device='cpu')\n"
        "st = create_train_state(m, 'image', make_schedule(None, 1e-3, 1, 1), device='cpu')\n"
        "for p in m.parameters():\n"
        "    p.grad = torch.ones_like(p) if p.requires_grad else None\n"
        "st.apply_gradients()\n"
        f"path = ck.save_jax_checkpoint({str(tmp_path)!r}, 'image', 1, 'resnet18', m, st.optimizer, 1)\n"
        "pt1 = ck.load_checkpoint(path)\n"
        "fresh = ck.restore_into(build_model('resnet18', device='cpu', seed=1), pt1)\n"
        "st2 = create_train_state(fresh, 'image', make_schedule(None, 1e-3, 1, 1), device='cpu')\n"
        "_restore_optimizer(st2, pt1['optimizer'])\n"
        "sd, sd2 = m.state_dict(), fresh.state_dict()\n"
        "assert all(torch.equal(sd[k], sd2[k]) for k in sd if not k.startswith(('fc_tile', 'seg')))\n"
        "assert len(st2.optimizer.state) == len(st.optimizer.state) > 0\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_import_check_sees_lazy_and_dotted_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import os\n"
        "def f():\n"
        "    import jax.numpy as jnp\n"
        "    from cellsegmentation_tpu.ops import q8_gemm\n"
    )
    assert [m for _, m in _imported_roots(probe)] == ["os", "jax", "cellsegmentation_tpu"]


def _tiny_model(device="cpu"):
    model = MILNet(ResNetEncoder(Bottleneck, (1, 1, 1, 1)))
    return init_milnet(model, seed=0).to(device)


def _quiet_logger(tmp_path):
    from cellsegmentation_tpu_torch.utils.logging import RunLogger

    return RunLogger(str(tmp_path), tensorboard=False)


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(dev)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("resnet18")
    model = _tiny_model()
    coords = tile_grid(64, 64, 32, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_tile_infer_step(model, 32, coords, engine="flax")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_tile_infer_step(model, 32, coords, engine="auto")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_stack_tile_infer_step(model, 32, coords, engine="flax")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_tile_train_step(model, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(model, "tile", make_schedule(None, 1e-3, 1, 1))
    rng = np.random.default_rng(0)
    src = LystoDataSource.from_arrays(
        rng.integers(0, 256, (2, 64, 64, 3), np.uint8), ["colon_0", "breast_1"],
        np.asarray([1, 0]), kfold=None,
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_stage2(model, src, None, epochs=1, tile_size=32, interval=16,
                     infer_engine="flax")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_topk(src, rng.random((2, len(coords)), np.float32), 32, 16,
                    tiles_per_pos=1, topk_neg=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_image_train_step(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_image_infer_step(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_stage1(model, src, None, epochs=1, batch_size=2)
    # the CLIs: the card unless CST_PLATFORM=cpu, checked before any input
    monkeypatch.delenv("CST_PLATFORM", raising=False)
    for main, argv in ((train_image.main, []),
                       (test_count.main, ["-m", str(tmp_path / "none.ckpt")])):
        with pytest.raises(RuntimeError, match="CST_PLATFORM=cpu"):
            main(argv + ["--data_path", str(tmp_path / "no_data")])
    # asked for the CPU, they run there
    assert resolve_device("cpu") == torch.device("cpu")
    step = make_tile_infer_step(model, 32, coords, engine="flax", device="cpu")
    probs = step(src.images[:1], np.zeros(1, np.int32))
    assert probs.device.type == "cpu" and probs.shape == (1, len(coords))
    sel = sample_topk(src, rng.random((2, len(coords)), np.float32), 32, 16,
                      tiles_per_pos=1, topk_neg=1, device="cpu")
    assert sel["n_pos"] == 1 and sel["n_neg"] == 1
    stack = make_stack_tile_infer_step(model, 32, coords, device="cpu")
    assert stack(torch.from_numpy(src.images), [1], [0]).device.type == "cpu"
    res = train_stage2(model, src, None, epochs=1, tile_size=32, interval=16,
                       infer_engine="flax", device="cpu",
                       logger=_quiet_logger(tmp_path))
    assert res.state.step == 1 and next(model.fc_tile.parameters()).device.type == "cpu"
    cats, counts = make_image_infer_step(model, device="cpu")(src.images, [0, 3])
    assert cats.device.type == counts.device.type == "cpu" and counts.shape == (2,)
    res = train_stage1(model, src, None, epochs=1, batch_size=2, device="cpu",
                       logger=_quiet_logger(tmp_path))
    assert res.state.step == 1 and np.isfinite(res.epoch_stats[0]["loss"])


def test_step_refuses_a_model_on_another_device():
    model = _tiny_model()
    with pytest.raises(ValueError, match="build the model on the step's device"):
        make_tile_infer_step(model, 32, tile_grid(64, 64, 32, 16), device="meta")


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine that has one
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd in (ROOT, alone):
        proc = _run_smoke(cwd)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


@pytest.mark.parametrize("cell", ["r50-sweep-b192", "r50-stage1-b48"])
def test_benchmark_fails_without_a_card(cell):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "cellsegmentation_tpu_torch.bench", "--cell", cell,
         "--seed", "0"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "CUDA card" in proc.stderr and '"correct"' not in proc.stdout


# detection and the images it writes: no cv2, no sklearn, at any depth
CV2_FREE = ("detect/__init__.py", "detect/cluster.py", "detect/detect.py",
            "detect/metrics.py", "utils/images.py")


@pytest.mark.parametrize("rel", CV2_FREE)
def test_detection_imports_no_cv2_or_sklearn(rel):
    path = ROOT / "cellsegmentation_tpu_torch" / rel
    bad = [(ln, m) for ln, m in _imported_roots(path) if m in ("cv2", "sklearn")]
    assert not bad, f"{rel} imports {bad}"


def test_detection_runs_without_cv2_or_sklearn(monkeypatch, tmp_path):
    """The localization (both methods), detection from arrays and the
    heatmaps run with every import of cv2 or sklearn failing (a None entry
    in sys.modules), and find each planted cell at its centre."""
    from cellsegmentation_tpu_torch.data.masks import MaskTestSource
    from cellsegmentation_tpu_torch.detect import cell_detect, meanshift_cluster
    from cellsegmentation_tpu_torch.postprocess.masks import heatmap

    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    yy, xx = np.mgrid[:120, :150]
    img = np.full((120, 150, 3), 200, np.uint8)
    for cy, cx in ((30, 40), (80, 100), (60, 20)):
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < 36] = 20
    mask = ((img[..., 2] < 100) * 255).astype(np.uint8)
    for method in ("gaussianblur", "distancetransform"):
        kept, _ = meanshift_cluster(mask, method)
        assert sorted(map(tuple, kept)) == [(30, 40), (60, 20), (80, 100)], method

    def seg(x, f):
        return (x[..., 2] < 100).float()

    def count(x, f):
        return None, torch.full((x.shape[0],), 1.2)

    src = MaskTestSource.from_arrays([img], ["roi-40.png"], patch_size=64)
    path = cell_detect(src, seg, count, output_path=str(tmp_path), device="cpu")
    with open(path) as f:
        rows = f.read().split()
    # each planted centre, the strip's x offset (40) added to its row
    assert rows[0] == "image_id,x,y"
    assert sorted(rows[1:]) == ["roi,100,20", "roi,120,100", "roi,70,40"], rows
    heatmap(img[None], np.asarray([0]), np.asarray([[0, 0]]), np.asarray([0.9]), 32,
            str(tmp_path / "heat"))
    assert (tmp_path / "heat" / "test_00001.png").exists()


def test_serving_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from cellsegmentation_tpu_torch.cli import test_seg, test_tile
    from cellsegmentation_tpu_torch.data.masks import MaskTestSource
    from cellsegmentation_tpu_torch.detect import cell_detect

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = MaskTestSource.from_arrays([np.zeros((20, 20, 3), np.uint8)], patch_size=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cell_detect(src, None, None, output_path=str(tmp_path))
    monkeypatch.delenv("CST_PLATFORM", raising=False)
    for main in (test_seg.main, test_tile.main):
        with pytest.raises(RuntimeError, match="CST_PLATFORM=cpu"):
            main(["-m", str(tmp_path / "none.ckpt"), "--data_path", str(tmp_path)])


def test_ensemble_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The ensemble CLIs want the card unless CST_PLATFORM=cpu, and their
    callables on built sources raise on a device that is not there."""
    from cellsegmentation_tpu_torch.cli import test_ensemble, train_ensemble
    from cellsegmentation_tpu_torch.data import EnsembleSource, LystoTestSource
    from cellsegmentation_tpu_torch.train.checkpoint import save_checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("CST_PLATFORM", raising=False)
    for main, argv in ((train_ensemble.main, []), (test_ensemble.main, ["-m", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CST_PLATFORM=cpu"):
            main(argv + ["--data_path", str(tmp_path / "no_data")])
    imgs = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), np.uint8)
    organs, counts = ["colon_0"] * 4, np.asarray([1, 0, 2, 3])
    args = train_ensemble.build_parser().parse_args(["-E", "resnet18", "-e", "1", "-k", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_ensemble.train_folds(EnsembleSource.from_arrays(imgs, organs, counts, k=2),
                                   args, _quiet_logger(tmp_path), "cuda")
    ck = save_checkpoint(str(tmp_path), "image", 1, "resnet18", _tiny_model().state_dict(),
                         prefix="reg_pt1_0")
    targs = test_ensemble.build_parser().parse_args(["-m", str(tmp_path), "-e", "1"])
    assert test_ensemble.ensemble_paths(str(tmp_path), 1) == [ck]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_ensemble.ensemble_counts([ck], LystoTestSource.from_arrays(imgs, organs),
                                      targs, "cuda")
