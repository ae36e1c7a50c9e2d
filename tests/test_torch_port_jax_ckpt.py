"""The JAX package's checkpoints read by the port, held against the JAX
package on the CPU.

- The msgpack reader and writer (utils/flax_msgpack.py) against
  ``flax.serialization``: the reader decodes flax's bytes to the tree
  ``msgpack_restore`` gives, chunked arrays and bfloat16 included; the
  writer's bytes are ``msgpack_serialize``'s.
- The weight bridge both ways (utils/jax_weights.py): ``state_dict_to_jax``
  is the exact inverse of ``jax_to_state_dict`` and gives the JAX
  package's tree layout, for ResNet-18, a reduced ResNeXt (Bottleneck
  (1, 1, 1, 1), 32 groups of width 4, without the seg decoder) and
  EfficientNet-B0's depth at width 0.25.
- pt1 / pt2 / pt3 files written by ``cellsegmentation_tpu``'s
  ``save_checkpoint`` with the optax state of its ``make_optimizer``
  (Adam, and SGD as a scheduler selects it) holding seeded moments: the
  port loads them bit-equal to ``jax_to_state_dict`` of the JAX
  variables, its optimizer resumes from them and writes the same file back
  byte for byte, one update after resuming matches the JAX package's own
  resume, the loaded model's forward matches the JAX model's, and one
  train step after resuming matches the JAX package's resumed step.
- Rejected files, one CLI end to end on a JAX-written file, and the two
  parity leftovers (``pin_constant_count_head``, the tensor
  ``categorize`` / ``de_categorize``).

The JAX variables are numpy-seeded values in the shapes of the JAX
package's own ``init`` (``jax.eval_shape``), BatchNorm statistics away
from their init values, and the count head's bias raised so counts are
positive.
"""

from __future__ import annotations

import csv
import glob
import os
import warnings
import zlib

import numpy as np
import pytest
import torch

import flax.serialization as fser
import jax
import jax.numpy as jnp

from cellsegmentation_tpu import models as jmodels
from cellsegmentation_tpu.cli import test_count as jtest_count
from cellsegmentation_tpu.core.dtypes import F32_POLICY as J_F32
from cellsegmentation_tpu.data.batches import normalize_images as jnormalize
from cellsegmentation_tpu.models.efficientnet import EfficientNetEncoder as JEffEncoder
from cellsegmentation_tpu.models.milnet import MILNet as JMILNet
from cellsegmentation_tpu.models.milnet import pin_constant_count_head as jpin
from cellsegmentation_tpu.models.resnet import Bottleneck as JBottleneck
from cellsegmentation_tpu.models.resnet import ResNetEncoder as JResNetEncoder
from cellsegmentation_tpu.ops.categorize import categorize as jcategorize
from cellsegmentation_tpu.ops.categorize import de_categorize as jde_categorize
from cellsegmentation_tpu.train import checkpoint as jckpt
from cellsegmentation_tpu.train import schedules as jsched
from cellsegmentation_tpu.train import state as jstate
from cellsegmentation_tpu.train import steps as jsteps

from cellsegmentation_tpu_torch.cli import test_count
from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
from cellsegmentation_tpu_torch.data import make_synthetic_h5, normalize_images
from cellsegmentation_tpu_torch.models import (
    Bottleneck,
    EfficientNetEncoder,
    MILNet,
    ResNetEncoder,
    build_model,
)
from cellsegmentation_tpu_torch.models.milnet import init_milnet, pin_constant_count_head
from cellsegmentation_tpu_torch.ops import categorize as tcat
from cellsegmentation_tpu_torch.train import checkpoint as tckpt
from cellsegmentation_tpu_torch.train import schedules as tsched
from cellsegmentation_tpu_torch.train import state as tstate
from cellsegmentation_tpu_torch.train import steps as tsteps
from cellsegmentation_tpu_torch.train.trainers import _restore_optimizer
from cellsegmentation_tpu_torch.utils import flax_msgpack
from cellsegmentation_tpu_torch.utils.jax_weights import (
    jax_to_state_dict,
    optax_to_torch,
    state_dict_to_jax,
)

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_stage1 import _intercept
from test_torch_port_stage1_step import ADAM_SHARE, LOSS_RTOL, SGD_L2, STAT_TOL

HW, B, LR = 64, 8, 1e-3
HEADS = ("fc_image_cls", "fc_image_reg")
# name in the file (its registry entry gives the layout's stage depths),
# the JAX model, the port model, the stages the family trains
FAMILIES = {
    "resnet18": (
        "resnet18",
        lambda: jmodels.build_model("resnet18", policy=J_F32),
        lambda: build_model("resnet18", policy=F32_POLICY, device="cpu"),
        ("image", "tile", "segment")),
    "resnext": (
        "resnext50_32x4d",
        # without its expansion-4 seg decoder (50 M parameters, 2048
        # channels in): the decoder's layout is every ResNet's, held in
        # files by ResNet-18's
        lambda: JMILNet(encoder=JResNetEncoder(block_cls=JBottleneck, stage_sizes=(1, 1, 1, 1),
                                               policy=J_F32, groups=32, base_width=4),
                        decoder_expansion=4, supports_segment=False, policy=J_F32),
        lambda: MILNet(ResNetEncoder(Bottleneck, (1, 1, 1, 1), groups=32, base_width=4,
                                     policy=F32_POLICY), policy=F32_POLICY,
                       supports_segment=False),
        ("image", "tile")),
    "effnet": (
        "efficientnet_b0",
        lambda: JMILNet(encoder=JEffEncoder(width_mult=0.25, depth_mult=1.0, policy=J_F32),
                        image_head_style="simple", supports_segment=False, policy=J_F32),
        lambda: MILNet(EfficientNetEncoder(0.25, 1.0, F32_POLICY), policy=F32_POLICY,
                       image_head_style="simple", supports_segment=False),
        ("image", "tile")),
}
CASES = [(f, s) for f, (_, _, _, stages) in FAMILIES.items() for s in stages]
# every file with Adam (no scheduler), and each family's pt1 with SGD (a
# scheduler given): SGD's momentum maps the same way in every stage
OPT_CASES = ([(f, s, False) for f, s in CASES]
             + [(f, "image", True) for f in FAMILIES])
# The forward of a loaded model against the JAX model's, f32 on both sides:
# max |diff| <= 1e-3 of the output's largest value, the bridged-forward
# limit of tests/test_torch_port_resnext.py (a grouped conv sums C/32 terms
# a tap, so the two frameworks' f32 orders part by a few ulp).
FORWARD_RTOL = 1e-3
# One optimizer update after resuming, the same gradients on both sides:
# optax adds lr x its update to the parameter, torch fuses the step into
# one addcdiv (Adam) or add (SGD), so each parameter rounds on its own on
# each side (UPDATE_ULPS f32 ulps of the parameter); beyond that, torch's
# lerp of the moments and optax's weighted sum round apart, by at most
# UPDATE_RTOL of the tensor's largest update (measured <= 3.8e-6 over
# every case).
UPDATE_ULPS = 2
UPDATE_RTOL = 1e-5


def _init_shapes(jm):
    def init_all(mdl):
        dummy = jnp.zeros((1, 32, 32, 3), mdl.policy.compute_dtype)
        mdl(dummy, mode="image", train=False)
        mdl(dummy, mode="tile", train=False)
        if mdl.supports_segment:
            mdl(dummy, mode="segment", train=False)

    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: jm.init({"params": key, "dropout": key}, method=init_all))


def _seeded(shapes, seed):
    """Numpy-seeded variables in the JAX package's init shapes: He-scaled
    kernels, small biases, BatchNorm parameters and statistics away from
    their init values, the count head's last kernel scaled by 0.2 and its
    bias at 8 (counts around 8)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            v = 1 + (0.1 * rng.standard_normal(s.shape) if name == "scale"
                     else 0.2 * rng.random(s.shape))
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    v = {c: jax.tree_util.tree_map(np.asarray, dict(t)) for c, t in v.items()}
    reg = v["params"]["fc_image_reg"]
    last = sorted(k for k in reg if k.startswith("Dense"))[-1]
    reg[last]["kernel"] = reg[last]["kernel"] * np.float32(0.2)
    reg[last]["bias"] = np.full_like(reg[last]["bias"], 8.0)
    return v


@pytest.fixture(scope="module")
def fams():
    out = {}
    for i, (fam, (name, jm_fn, tm_fn, stages)) in enumerate(FAMILIES.items()):
        jm = jm_fn()
        out[fam] = dict(name=name, jm=jm, tm_fn=tm_fn, stages=stages,
                        variables=_seeded(_init_shapes(jm), seed=20 + i))
    return out


def _images(n, seed, hw=HW):
    return np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3)).astype(np.uint8)


def _np_sd(sd):
    return {k: v.numpy().copy() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def _assert_trees_equal(got, want, path=""):
    """Same keys (in order), leaves of the same type, dtype, shape and bits."""
    if isinstance(want, dict):
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for g, w in zip(got, want):
            _assert_trees_equal(g, w, path)
    elif isinstance(want, np.ndarray) and want.dtype == jnp.bfloat16:
        assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
        assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16)), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, (path, got, want)
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# ---------------------------------------------------------------------------
# the msgpack reader and writer
# ---------------------------------------------------------------------------


def _payload():
    rng = np.random.default_rng(0)
    return {
        "state_dict": {"params": {"w": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
                                  "b": np.arange(5, dtype=np.int64)},
                       "batch_stats": {}},
        "mode": "image", "epoch": 3, "step": 70000, "neg": -5, "neg16": -300,
        "big": 2**40, "f": 1.5, "t": True, "none": None, "bytes": b"xyz",
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((2, 3)), jnp.bfloat16)),
        "f32_scalar": np.float32(2.5), "f64_scalar": np.float64(1.25),
        "i32_scalar": np.int32(-7), "complex": 1 + 2j, "count": np.asarray(3, np.int32),
        "list": [1, "a", {"q": np.zeros((0,), np.float32)}], "empty": {},
        "long": "x" * 300, "bools": np.asarray([True, False]),
        "many": {str(i): i * 1000 for i in range(20)},
    }


def _port_payload(p):
    """The payload with its bfloat16 array as the torch tensor the port
    holds (numpy has no bfloat16)."""
    bits = torch.from_numpy(p["bf16"].view(np.int16).copy())
    return {**p, "bf16": bits.view(torch.bfloat16)}


def test_reader_decodes_flax_bytes():
    """Every type flax writes: the reader's tree is msgpack_restore's, arrays
    bit-equal, bfloat16 as a torch tensor, numpy scalars as numpy scalars;
    a truncated buffer and trailing bytes raise."""
    data = fser.msgpack_serialize(_payload())
    _assert_trees_equal(flax_msgpack.unpackb(data), fser.msgpack_restore(data))
    for cut in (1, 7, len(data) // 2, len(data) - 1):
        with pytest.raises(ValueError, match="truncated"):
            flax_msgpack.unpackb(data[:cut])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.unpackb(data + b"\x00")


def test_writer_bytes_are_flax_bytes():
    assert flax_msgpack.packb(_port_payload(_payload())) == fser.msgpack_serialize(_payload())


def test_chunked_arrays_both_ways(monkeypatch):
    """Arrays over the chunk size, as flax writes them (its MAX_CHUNK_SIZE
    cut to 64 bytes): the reader joins them, the writer chunks alike."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"s": {"small": np.ones(3, np.float32), "v": np.arange(40, dtype=np.int16)},
            "w": rng.standard_normal((7, 9)).astype(np.float32)}  # in flax's key order
    data = fser.msgpack_serialize(tree)
    got = flax_msgpack.unpackb(data)
    _assert_trees_equal(got, fser.msgpack_restore(data))
    _assert_trees_equal(got, tree)
    assert flax_msgpack.packb(tree, chunk_size=64) == data


# ---------------------------------------------------------------------------
# the weight bridge both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fam", FAMILIES)
def test_state_dict_to_jax_is_the_exact_inverse(fams, fam):
    """A seeded port model -> the JAX layout -> back: bit-equal to its state
    dict; and the JAX variables -> the port -> the JAX layout: bit-equal to
    the JAX tree, so the inverse writes the JAX package's own layout."""
    f = fams[fam]
    model = init_milnet(f["tm_fn"](), seed=3)
    depths = getattr(model.encoder, "stage_depths", None)
    sd, skipped = jax_to_state_dict(state_dict_to_jax(model), depths)
    assert skipped == []
    want = _np_sd(model.state_dict())
    assert sd.keys() == want.keys()
    for k in want:
        assert sd[k].numpy().tobytes() == want[k].tobytes(), k
    v = f["variables"]
    sd, _ = jax_to_state_dict(v, depths)
    model.load_state_dict(sd, strict=False)
    back = state_dict_to_jax(model)
    for c in ("params", "batch_stats"):
        _assert_trees_equal(jax.tree_util.tree_map(lambda x: x, back[c]),
                            jax.tree_util.tree_map(lambda x: x, v[c]))


# ---------------------------------------------------------------------------
# files from the JAX package
# ---------------------------------------------------------------------------


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (0.1 * rng.standard_normal(p.shape)).astype(np.float32), params)


def _schedules(use_sgd):
    name = "OneCycleLR" if use_sgd else None
    return jsched.make_schedule(name, LR, 2, 4), tsched.make_schedule(name, LR, 2, 4)


def _jax_file(f, stage, use_sgd, path):
    """The stage's checkpoint as the JAX package writes it: the family's
    variables and the optax state of its ``make_optimizer`` (its init's
    structure, traced) holding the moments two numpy-seeded gradients g1,
    g2 leave (Adam's mu and nu, SGD's trace; each parameter's pair seeded
    by its path), count 2, at step 2."""
    v = f["variables"]
    tx = jstate.make_optimizer(stage, v["params"], use_sgd)

    def leaf(path, s):
        names = [str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", ""))))
                 for k in path]
        if "count" in names:
            return np.asarray(2, s.dtype)
        slot = next(n for n in names if n in ("mu", "nu", "trace"))
        where = "/".join(n for n in names if n != slot)
        g1, g2 = 0.01 * np.random.default_rng(zlib.crc32(where.encode())).standard_normal(
            (2, *s.shape))
        moment = {"mu": 0.09 * g1 + 0.1 * g2, "nu": 0.000999 * g1**2 + 0.001 * g2**2,
                  "trace": 0.9 * g1 + g2}[slot]
        return moment.astype(np.float32)

    opt = jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(tx.init, v["params"]))
    return jckpt.save_checkpoint(str(path), stage, 1, f["name"], v["params"],
                                 v["batch_stats"], opt_state=opt, step=2)


def _jax_resume(f, stage, use_sgd, path):
    """The JAX package's own resume from ``path``: its train state at the
    file's step with the file's parameters, statistics and optax state."""
    ck = jckpt.load_checkpoint(path)
    v = f["variables"]
    params, stats = jckpt.restore_into(v["params"], v["batch_stats"], ck)
    tx = jstate.make_optimizer(stage, params, use_sgd)
    return jstate.MILTrainState(
        step=jnp.asarray(ck["step"], jnp.int32), params=params, batch_stats=stats,
        opt_state=jckpt.restore_opt_state(jax.eval_shape(tx.init, params), ck["optimizer"]),
        tx=tx, schedule=_schedules(use_sgd)[0])


def _port_resume(f, stage, use_sgd, path):
    """The port's resume from a checkpoint: (model, train state, payload)."""
    ck = tckpt.load_checkpoint(path)
    model = tckpt.restore_into(init_milnet(f["tm_fn"](), seed=5), ck,
                               tckpt.STAGE_SAVE_PARTITIONS[stage])
    ts = tstate.create_train_state(model, stage, _schedules(use_sgd)[1],
                                   use_sgd=use_sgd, device="cpu")
    ts.step = ck["step"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _restore_optimizer(ts, ck["optimizer"])
    return model, ts, ck


@pytest.mark.parametrize("fam,stage,use_sgd", OPT_CASES,
                         ids=[f"{f}-{s}-{'sgd' if o else 'adam'}" for f, s, o in OPT_CASES])
def test_jax_file_loads_and_resumes(fams, fam, stage, use_sgd, tmp_path):
    """A JAX-written ptN: the payload's fields as written and its state
    bit-equal to jax_to_state_dict of the JAX variables; the resumed
    optimizer and model written back as a JAX file are the JAX file, byte
    for byte; one update (the same gradients) from the port's resume and
    from the JAX package's own within UPDATE_ULPS, the frozen partitions
    unchanged."""
    f = fams[fam]
    path = _jax_file(f, stage, use_sgd, tmp_path)
    model, ts, ck = _port_resume(f, stage, use_sgd, path)
    depths = getattr(model.encoder, "stage_depths", None)
    parts = tckpt.STAGE_SAVE_PARTITIONS[stage]
    assert (ck["mode"], ck["epoch"], ck["encoder"], ck["step"], ck["extra"]) == (
        stage, 1, f["name"], 2, {})
    assert isinstance(ck["optimizer"], tckpt.JaxOptimizerState)
    want, _ = jax_to_state_dict({c: {k: t[k] for k in parts if k in t}
                                 for c, t in f["variables"].items()}, depths)
    assert ck["state_dict"].keys() == want.keys()
    assert {k.split(".")[0] for k in want} == set(parts) & {n for n, _ in model.named_children()}
    for k in want:
        assert ck["state_dict"][k].numpy().tobytes() == want[k].numpy().tobytes(), k
    back = tckpt.save_jax_checkpoint(str(tmp_path / "back.ckpt"), stage, 1, f["name"], model,
                                     ts.optimizer, step=ts.step)
    assert open(back, "rb").read() == open(path, "rb").read()

    js = _jax_resume(f, stage, use_sgd, path)
    g = _grads(js.params, seed=7)
    jparams = jax.jit(lambda s, g: s.apply_gradients(g, s.batch_stats).params)(js, g)
    gsd, _ = jax_to_state_dict({"params": g, "batch_stats": js.batch_stats}, depths)
    before = _np_sd(model.state_dict())
    for name, p in model.named_parameters():
        if p.requires_grad:
            p.grad = gsd[name].clone()
    ts.apply_gradients()
    after = _np_sd(model.state_dict())
    jafter = _np_sd(jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jparams),
                                       "batch_stats": js.batch_stats}, depths)[0])
    trained = tstate.STAGE_TRAINABLE[stage]
    for name, p in model.named_parameters():
        if name.split(".")[0] not in trained:
            assert np.array_equal(after[name], before[name]), name
            continue
        assert not np.array_equal(jafter[name], before[name]), name
        gap = np.abs(after[name] - jafter[name]) - UPDATE_ULPS * np.spacing(np.abs(before[name]))
        rel = gap.max() / np.abs(jafter[name] - before[name]).max()
        assert rel <= UPDATE_RTOL, (name, rel)


@pytest.mark.parametrize("fam,stage", CASES)
def test_loaded_model_forward_matches_jax(fams, fam, stage, tmp_path):
    """The model loaded from a JAX-written ptN runs the stage's mode like the
    JAX model on the file's variables (f32, FORWARD_RTOL)."""
    f = fams[fam]
    path = _jax_file(f, stage, False, tmp_path)
    model = tckpt.restore_into(init_milnet(f["tm_fn"](), seed=5),
                               tckpt.load_checkpoint(path)).eval()
    imgs = _images(3, seed=4, hw=32 if stage == "tile" else HW)
    flip = np.asarray([0, 1, 3], np.int32)
    mode = {"image": "image", "tile": "tile", "segment": "segment"}[stage]
    jm = f["jm"]
    want = jax.jit(lambda v, x: jm.apply(v, x, mode=mode))(f["variables"], jnormalize(imgs, flip))
    with torch.no_grad():
        got = model(normalize_images(torch.from_numpy(imgs), torch.from_numpy(flip)),
                    mode=mode)
    for g, w in zip(*(o if isinstance(o, tuple) else (o,) for o in (got, want))):
        g, w = g.numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= FORWARD_RTOL * np.abs(w).max(), mode


def _batch():
    counts = np.random.default_rng(5).integers(0, 40, 6)
    rows = np.concatenate([np.arange(6), np.zeros(B - 6, int)])
    return {
        "images": _images(6, seed=2)[rows],
        "flip": (np.arange(B) % 4).astype(np.int32)[rows],
        "cls": np.digitize(counts, [1, 6, 11, 21, 51, 201]).astype(np.int32)[rows],
        "reg": counts.astype(np.float32)[rows],
        "valid": np.arange(B) < 6,
    }


@pytest.mark.parametrize("use_sgd", [False, True], ids=["adam", "sgd_onecycle"])
def test_resumed_train_step_matches_jax(fams, use_sgd, tmp_path):
    """One stage-1 train step after resuming from a JAX-written pt1
    (ResNet-18, f32, the same injected dropout masks), the JAX package
    resumed from the same file against the port: the losses within
    LOSS_RTOL, the running statistics within STAT_TOL and the updates under
    tests/test_torch_port_stage1_step.py's limits (SGD: the relative L2
    gap of each partition's update; Adam: the share of entries off by more
    than lr / 100 at most ADAM_SHARE, every entry within 2 lr)."""
    f = fams["resnet18"]
    path = _jax_file(f, "image", use_sgd, tmp_path)
    model, ts, _ = _port_resume(f, "image", use_sgd, path)
    js = _jax_resume(f, "image", use_sgd, path)
    gen = torch.Generator().manual_seed(9)
    tmasks = {h: getattr(model, h).draw_masks(B, gen) for h in HEADS}
    jmasks = {(h, f"Dropout_{i}"): m.numpy() for h in HEADS for i, m in enumerate(tmasks[h])}
    before = _np_sd(model.state_dict())
    batch = _batch()
    with _intercept(jmasks):
        js, jm = jsteps.make_image_train_step(f["jm"])(js, batch, jax.random.PRNGKey(0))
    ts, tm = tsteps.make_image_train_step(model, device="cpu")(ts, batch,
                                                               dropout_masks=tmasks)
    for k in ("loss_cls", "loss_reg", "loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    want = _np_sd(jax_to_state_dict(jax.tree_util.tree_map(np.asarray, js.variables))[0])
    got = _np_sd(model.state_dict())
    for k in (k for k in want if "running_" in k and not k.startswith("seg_decoder")):
        assert np.abs(got[k] - want[k]).max() <= STAT_TOL * np.abs(want[k]).max(), k
    for part in ("encoder", *HEADS):
        keys = [k for k in want if k.startswith(part) and "running_" not in k]
        ut = np.concatenate([(got[k] - before[k]).ravel() for k in keys])
        uj = np.concatenate([(want[k] - before[k]).ravel() for k in keys])
        if use_sgd:
            assert np.linalg.norm(ut - uj) / np.linalg.norm(uj) <= SGD_L2[part], part
        else:
            assert float((np.abs(ut - uj) > LR / 100).mean()) <= ADAM_SHARE, part
            assert np.abs(ut - uj).max() <= 2 * LR * (1 + 1e-3), part
        assert np.abs(ut).max() > 0, part


# ---------------------------------------------------------------------------
# rejected files
# ---------------------------------------------------------------------------


def _rewrite(path, edit):
    raw = fser.msgpack_restore(open(path, "rb").read())
    edit(raw)
    out = path + ".bad"
    with open(out, "wb") as fh:
        fh.write(fser.msgpack_serialize(raw))
    return out


def test_bad_files_are_rejected(fams, tmp_path):
    """A conv kernel written without the HWIO transpose, an unknown subtree
    (top-level or inside the encoder), a truncated file and a file of
    neither format raise, each with a message; an Adam nu leaf dropped, an
    SGD file resumed by Adam and a pt2's optimizer resumed in stage 1 warn
    and leave the optimizer fresh, never partly loaded."""
    f = fams["resnet18"]
    path = _jax_file(f, "image", False, tmp_path)
    model = init_milnet(f["tm_fn"](), seed=5)

    def oihw(raw):
        conv = raw["state_dict"]["params"]["encoder"]["layer1_0"]["ConvBNAct_0"]["Conv_0"]
        conv["kernel"] = np.ascontiguousarray(np.transpose(conv["kernel"], (3, 2, 0, 1)))

    with pytest.raises(RuntimeError, match="size mismatch for encoder.layer1.0.conv1.weight"):
        tckpt.restore_into(model, tckpt.load_checkpoint(_rewrite(path, oihw)))
    with pytest.raises(ValueError, match=r"\['fc_extra'\] have no counterpart"):
        tckpt.load_checkpoint(_rewrite(path, lambda r: r["state_dict"]["params"].update(
            fc_extra={"Dense_0": {"kernel": np.zeros((2, 2), np.float32)}})))
    with pytest.raises(ValueError, match="encoder/layer1_0/extra/kernel"):
        tckpt.load_checkpoint(_rewrite(path, lambda r: r["state_dict"]["params"]["encoder"][
            "layer1_0"].update(extra={"kernel": np.zeros((2,), np.float32)})))
    data = open(path, "rb").read()
    (tmp_path / "cut.ckpt").write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="truncated"):
        tckpt.load_checkpoint(str(tmp_path / "cut.ckpt"))
    (tmp_path / "text.ckpt").write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="neither a torch checkpoint"):
        tckpt.load_checkpoint(str(tmp_path / "text.ckpt"))

    def no_nu_leaf(raw):
        core = raw["optimizer"]["inner_states"]["train"]["inner_state"]["1"]["0"]
        del core["nu"]["encoder"]["layer1_0"]["ConvBNAct_0"]["Conv_0"]["kernel"]

    sgd_path = _jax_file(f, "image", True, tmp_path / "sgd")
    pt2_path = _jax_file(f, "tile", False, tmp_path / "pt2")
    for bad, what in ((_rewrite(path, no_nu_leaf), "nu holds"),
                      (sgd_path, r"holds \['trace'\]"),
                      (pt2_path, r"trains partitions \['fc_tile'\]")):
        ck = tckpt.load_checkpoint(bad)
        ts = tstate.create_train_state(init_milnet(f["tm_fn"](), seed=5), "image",
                                       _schedules(False)[1], device="cpu")
        with pytest.raises(ValueError, match=what):
            optax_to_torch(ck["optimizer"].tree, ts.optimizer, ts.model)
        with pytest.warns(UserWarning, match="continuing with fresh optimizer state"):
            _restore_optimizer(ts, ck["optimizer"])
        assert not ts.optimizer.state


# ---------------------------------------------------------------------------
# a CLI end to end, the parity leftovers
# ---------------------------------------------------------------------------


def test_test_count_cli_reads_a_jax_file(fams, tmp_path, monkeypatch):
    """test_count -m <JAX-written pt1> under CST_PLATFORM=cpu, in f32: the
    counts the JAX package's test_count writes from the same file."""
    monkeypatch.setenv("CST_PLATFORM", "cpu")
    path = _jax_file(fams["resnet18"], "image", False, tmp_path)
    make_synthetic_h5(str(tmp_path / "test.h5"), n_images=6, image_size=HW, max_cells=12,
                      seed=2, with_labels=False)
    rows = {}
    for side, main in (("port", test_count.main), ("jax", jtest_count.main)):
        out = str(tmp_path / side)
        main(["-m", path, "--data_path", str(tmp_path), "-B", "4", "--f32", "-o", out])
        (csv_path,) = glob.glob(os.path.join(out, "*-count-e1.csv"))
        with open(csv_path) as fh:
            rows[side] = list(csv.reader(fh))
    assert rows["port"] == rows["jax"]
    counts = [int(r[1]) for r in rows["port"][1:]]
    assert len(counts) == 6 and len(set(counts)) > 1, counts


@pytest.mark.parametrize("fam", ["resnet18", "effnet"])
def test_pin_constant_count_head_matches_jax(fams, fam):
    """The port's pin on a model holding the JAX variables: its state is the
    JAX package's pinned variables, bridged (the MLP head and the simple
    one)."""
    f = fams[fam]
    model = f["tm_fn"]()
    v = jax.tree_util.tree_map(np.copy, f["variables"])
    depths = getattr(model.encoder, "stage_depths", None)
    model.load_state_dict(jax_to_state_dict(v, depths)[0], strict=False)
    pin_constant_count_head(model, 4.5)
    jpin(v, 4.5)
    want = jax_to_state_dict(v, depths)[0]
    got = model.state_dict()
    for k in (k for k in want if k.startswith("fc_image_reg")):
        assert torch.equal(got[k], want[k]), k
    assert (got[f"fc_image_reg.{7 if fam == 'resnet18' else 2}.bias"] == 4.5).all()


def test_categorize_tensors_match_jax():
    """categorize / de_categorize on tensors against the JAX package's on
    the same counts, bin edges and their neighbours included."""
    x = np.asarray([-1, 0, 0.5, 1, 5, 5.5, 6, 10, 11, 20.9, 21, 50, 51, 200, 200.5, 201, 1e6],
                   np.float32)
    got = tcat.categorize(torch.from_numpy(x))
    want = np.asarray(jcategorize(jnp.asarray(x)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    ints = np.arange(0, 260, dtype=np.int32)
    assert np.array_equal(tcat.categorize(torch.from_numpy(ints)).numpy(),
                          np.asarray(jcategorize(jnp.asarray(ints))))
    labels = np.arange(7, dtype=np.int32)
    for g, w in zip(tcat.de_categorize(torch.from_numpy(labels)),
                    jde_categorize(jnp.asarray(labels))):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))
