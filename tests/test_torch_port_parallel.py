"""The port's ``parallel/`` and its multi-process branches, over
``torch.distributed`` with gloo on localhost.

One module-scoped fixture spawns a 2-rank and a 3-rank group through the
``CST_*`` variables, as ``tests/test_multihost.py`` does for the JAX
package. The workers import no JAX; each writes JSON, and the tests assert
on its parts:

- the round-robin sweeps (``inference_tiles``, ``inference_image``,
  ``inference_tiles_and_counts``) merged across ranks equal the JAX
  package's single-process results on the same stub steps, exactly, with
  disjoint and complete batch coverage (3 ranks over 4 batches: shares
  2/1/1, the merge's padding); ``merge_process_rows`` refuses a
  non-contiguous output;
- on tiny encoders, a 2-rank stage-1 step and a 2-rank seg step equal the
  1-rank step on the rank-major concatenation of the ranks' batches (loss
  rel <= 1e-5, gradient cosine >= 0.99999, gradient norm ratio within 1e-5
  of 1, running statistics rel <= 1e-5:
  the sums differ in order only, f32; both at global batch 8: at 4 and 6
  the seg decoder's f32 gradient is so ill-conditioned that the 1-rank
  step through oneDNN's BatchNorm and through the multi-rank formula on one
  rank already part by 1 - cos 1.7e-5 and 2e-11); a 2-rank ``train_stage2`` epoch
  selects what 1 rank selects on both ranks, its ``fc_tile`` bit-identical
  across ranks and within rel 1e-5 of the 1-rank epoch's (one Adam step on
  every selected tile); ``draw_pseudo_masks`` over 2 and 3 ranks paints
  the 1-rank masks; ``train_stage1`` / ``train_stage3`` epochs leave every
  rank with the same weights;
- planted faults each gate must reject: BatchNorm on local statistics, the
  loss over the local count, the gradients averaged over the ranks (right
  in direction, wrong in size), a merge that drops one rank's rows.

The mesh rule and the tensor-parallel rule are held against the JAX
package's in this process, and the backend choice over layouts of ranks
on hosts. Every spawned process gets a timeout and is
killed on expiry, and every process group one too.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from cellsegmentation_tpu import infer as jinfer
from cellsegmentation_tpu.models import build_model as jbuild_model
from cellsegmentation_tpu.models import init_variables
from cellsegmentation_tpu.parallel import mesh as jmesh
from cellsegmentation_tpu.parallel import sharding as jsharding

from cellsegmentation_tpu_torch.models import build_model
from cellsegmentation_tpu_torch.parallel import mesh as tmesh
from cellsegmentation_tpu_torch.parallel import multihost as tmultihost
from cellsegmentation_tpu_torch.parallel import sharding as tsharding
from cellsegmentation_tpu_torch.utils.jax_weights import jax_to_state_dict

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 300

# The stub steps and the data of the sweeps and the training checks, the
# same code in the workers and here. Each stub image carries its row number
# in its first byte, so the steps can tell which batches they were given.
SHARED = r'''
import numpy as np

N_IMG, HW = 7, 36


def stub_images():
    imgs = (np.arange(N_IMG * HW * HW * 3, dtype=np.int64) % 251).astype(np.uint8)
    imgs = imgs.reshape(N_IMG, HW, HW, 3)
    imgs[:, 0, 0, 0] = np.arange(N_IMG)
    return imgs


def tile_probs(images):
    x = np.asarray(images, np.float64)
    return x.mean(axis=(1, 2, 3))[:, None] / 255.0 + 0.01 * np.arange(9)[None, :]


def image_out(images):
    m = np.asarray(images, np.float64).mean(axis=(1, 2, 3))
    return np.sin(np.outer(m, np.arange(1, 8))), m * 0.9 - 100.0


def train_arrays(n, hw, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    counts = rng.integers(0, 12, n)
    counts[::3] = 0
    return imgs, [f"colon_{i}" for i in range(n)], counts


# stage 2: a reduced Bottleneck encoder (q8dg on the 32/16 grid), 8 base
# images x 4 flips, global image batch 8 (4 per rank of 2)
S2 = dict(epochs=1, tile_size=32, interval=16, tile_batch_size=4096, topk_neg=2,
          tiles_per_pos=1, infer_engine="auto", record_selection=True, device="cpu")
S2_HW, S2_IMAGES, S2_BATCH = 64, 8, 8
'''

WORKER = SHARED + r'''
import datetime, json, os, sys
import torch

torch.set_num_threads(1)
from cellsegmentation_tpu_torch.parallel import multihost

backend = multihost.maybe_initialize(timeout=datetime.timedelta(seconds=120))

import torch.distributed as dist
from cellsegmentation_tpu_torch import infer
from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
from cellsegmentation_tpu_torch.data.lysto import LystoDataSource
from cellsegmentation_tpu_torch.models import BasicBlock, Bottleneck, MILNet, ResNetEncoder
from cellsegmentation_tpu_torch.models.common import sync_batch_norm
from cellsegmentation_tpu_torch.models.milnet import init_milnet
from cellsegmentation_tpu_torch.parallel.mesh import make_mesh
from cellsegmentation_tpu_torch.train import steps as tsteps
from cellsegmentation_tpu_torch.train.schedules import make_schedule
from cellsegmentation_tpu_torch.train.state import create_train_state
from cellsegmentation_tpu_torch.train import trainers
from cellsegmentation_tpu_torch.utils.logging import RunLogger

out_dir, checks = sys.argv[1], sys.argv[2].split(",")
pi, pc = multihost.process_index(), multihost.process_count()
res = {"rank": pi, "world": pc, "backend": backend, "dist_backend": dist.get_backend()}
logger = RunLogger(os.path.join(out_dir, f"log{pi}"), tensorboard=False)


class StubSource:
    image_hw = (HW, HW)
    images = stub_images()

    def __len__(self):
        return N_IMG


seen = []


def tile_step(images, flip):
    x = np.asarray(images)
    seen.append(int(x[0, 0, 0, 0]) // 2)  # the batch's number (batch 2)
    return torch.from_numpy(tile_probs(x))


def image_step(images, flip):
    probs, counts = image_out(np.asarray(images))
    return torch.from_numpy(probs), torch.from_numpy(counts)


def sweeps(tag):
    out = {}
    seen.clear()
    out["tiles"] = infer.inference_tiles(StubSource(), tile_step, 16, 10,
                                         image_batch=2).tolist()
    out["batches"] = list(seen)
    cats, counts = infer.inference_image(StubSource(), image_step, batch_size=2)
    out["categories"], out["counts"] = cats.tolist(), counts.tolist()
    p, c = infer.inference_tiles_and_counts(StubSource(), tile_step, image_step, 16,
                                            10, image_batch=2, device="cpu")
    out["tc_probs"], out["tc_counts"] = p.tolist(), c.tolist()
    res[tag] = out


def tiny(block, sizes, seed):
    enc = ResNetEncoder(block, sizes, policy=F32_POLICY)
    return init_milnet(MILNet(enc, policy=F32_POLICY), seed)


def readings(loss, grads, stats, ref):
    g, rg = torch.cat(grads).double(), torch.cat(ref["grads"]).double()
    return {
        "loss_rel": abs(float(loss) - float(ref["loss"])) / abs(float(ref["loss"])),
        "grad_cos": float(torch.dot(g, rg) / (g.norm() * rg.norm())),
        "grad_norm_rel": abs(float(g.norm() / rg.norm()) - 1.0),
        "stats_rel": max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                         for a, b in zip(stats, ref["stats"])),
    }


def bn_stats(model):
    return [b.clone() for n, b in model.named_buffers() if "running" in n]


def step_batch(kind, n):
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    flip = rng.integers(0, 4, n).astype(np.int32)
    valid = np.ones(n, bool)
    valid[-1] = False  # a padded row: in the statistics, out of the loss
    if kind == "stage1":
        reg = rng.integers(0, 30, n)
        return {"images": imgs, "flip": flip, "cls": (reg > 0) + (reg > 5),
                "reg": reg.astype(np.float32), "valid": valid}
    mask = (rng.random((n, 64, 64)) < 0.3).astype(np.int32)
    return {"images": imgs, "flip": flip, "mask": mask, "valid": valid}


def run_step(kind, batch, mesh, fault=None):
    """(global loss, trained gradients, running statistics) of one step."""
    model = tiny(BasicBlock, (1, 1, 1, 1), seed=4)
    if kind == "stage1":
        step = tsteps.make_image_train_step(model, seed=9, device="cpu", mesh=mesh)
        stage = "image"
    else:
        step = tsteps.make_seg_train_step(model, device="cpu", mesh=mesh)
        stage = "segment"
    state = create_train_state(model, stage, make_schedule(None, 5e-4, 1, 1),
                               use_sgd=True, device="cpu")
    if fault == "bn_local":
        sync_batch_norm(model, None)
    real, real_grads = tsteps.global_count, tsteps.all_reduce_grads
    if fault == "local_count":
        tsteps.global_count = lambda mesh, valid: valid.detach().float().sum()
    if fault == "grad_mean":  # the gradients averaged over the ranks, not summed
        def averaged(mesh, params):
            real_grads(mesh, params)
            for p in params:
                if p.grad is not None:
                    p.grad.div_(mesh.size)
        tsteps.all_reduce_grads = averaged
    try:
        _, metrics = step(state, batch)
    finally:
        tsteps.global_count, tsteps.all_reduce_grads = real, real_grads
    grads = [p.grad.reshape(-1).clone() for g in state.optimizer.param_groups
             for p in g["params"]]
    return metrics["loss"], grads, bn_stats(model)


def step_checks():
    mesh = make_mesh()
    for kind, n in (("stage1", 8), ("seg", 8)):
        batch = step_batch(kind, n)
        per = n // pc
        local = {k: v[pi * per:(pi + 1) * per] for k, v in batch.items()}
        ref = None
        if pi == 0:  # the 1-rank step on the concatenated batch
            loss, grads, stats = run_step(kind, batch, None)
            ref = {"loss": loss, "grads": grads, "stats": stats}
        for fault in (None, "bn_local", "local_count", "grad_mean"):
            loss, grads, stats = run_step(kind, local, mesh, fault)
            if pi == 0:
                res[f"{kind}_{fault or 'clean'}"] = readings(loss, grads, stats, ref)


def stage2_check():
    imgs, organs, counts = train_arrays(S2_IMAGES, S2_HW, seed=3)
    src = LystoDataSource.from_arrays(imgs, organs, counts, kfold=None, augment=True)
    model = tiny(Bottleneck, (1, 1, 1, 1), seed=5)
    r = trainers.train_stage2(model, src, None, image_batch=S2_BATCH, logger=logger, **S2)
    res["selection"] = {k: v.tolist() for k, v in r.selections[0].items()}
    res["fc_tile"] = [t.tolist() for t in model.fc_tile.parameters()]


def draw_check():
    imgs, organs, counts = train_arrays(8, 48, seed=6)
    src = LystoDataSource.from_arrays(imgs, organs, counts, kfold=None)
    model = tiny(BasicBlock, (1, 1, 1, 1), seed=7)
    with torch.no_grad():
        model.fc_image_reg[7].bias.fill_(5.0)  # every count nonzero
    masks = trainers.draw_pseudo_masks(model, src, tile_size=16, interval=8,
                                       threshold=0.5, image_batch=3, engine="flax",
                                       device="cpu", logger=logger)
    res["masks"] = masks.tolist()


def epochs_check():
    from cellsegmentation_tpu_torch.data.masks import MaskDataSource

    imgs, organs, counts = train_arrays(12, 48, seed=8)
    src = LystoDataSource.from_arrays(imgs, organs, counts, kfold=None)
    model = tiny(BasicBlock, (1, 1, 1, 1), seed=pi)  # rank 0's weights win
    r1 = trainers.train_stage1(model, src, None, epochs=1, batch_size=6, device="cpu",
                               logger=logger, hard_threshold=0.5)
    masks = (imgs[..., 0] > 128).astype(np.uint8)
    mask_src = MaskDataSource.from_arrays(imgs, masks, augment=True)
    r3 = trainers.train_stage3(model, mask_src, epochs=1, batch_size=4, device="cpu",
                               logger=logger)
    res["epochs"] = {"stage1_loss": r1.epoch_stats[0]["loss"], "stage1_n": len(src),
                     "stage3_loss": r3.last_loss,
                     "weights": float(sum(p.double().sum() for p in model.parameters())),
                     "stats": float(sum(b.double().sum() for n, b in model.named_buffers()
                                        if "running" in n))}


def merge_fault():
    real = infer.merge_process_rows

    def drop_rank1(outs, idx_chunks, val_chunks):
        if pi == 1:
            idx_chunks, val_chunks = [], [[] for _ in outs]
        real(outs, idx_chunks, val_chunks)

    infer.merge_process_rows = drop_rank1
    try:
        sweeps("merge_drop")
    finally:
        infer.merge_process_rows = real


def contiguity():
    try:
        multihost.merge_process_rows([np.zeros((4, 6), np.float32)[:, ::2]], [], [[]])
    except ValueError as e:
        return str(e)
    return None


sweeps("sweeps")
res["non_contiguous"] = contiguity()
res["mesh"] = [make_mesh().size, make_mesh().rank, make_mesh(data=1, model=pc).size]
res["local_rank"] = multihost.local_rank()
try:
    make_mesh(data=pc, model=2)
    res["bad_mesh"] = None
except ValueError as e:
    res["bad_mesh"] = str(e)
if "train" in checks:
    step_checks()
    stage2_check()
    epochs_check()
    merge_fault()
draw_check()
with open(os.path.join(out_dir, f"rank{pi}.json"), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
print("WORKER_OK", pi)
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(tmp, pc: int, checks: str):
    script = tmp / "worker.py"
    script.write_text(WORKER)
    out = tmp / f"pc{pc}"
    out.mkdir()
    port = _free_port()
    procs = []
    for pid in range(pc):
        env = dict(os.environ, CST_PLATFORM="cpu", CST_DISABLE_TB="1",
                   CST_COORDINATOR_ADDRESS=f"localhost:{port}",
                   CST_NUM_PROCESSES=str(pc), CST_PROCESS_ID=str(pid),
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(out), checks], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return out, procs


def _wait(groups) -> dict:
    logs = {}
    try:
        for pc, (_, procs) in groups.items():
            logs[pc] = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for _, procs in groups.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    results = {}
    for pc, (out, procs) in groups.items():
        for p, log in zip(procs, logs[pc]):
            assert p.returncode == 0, log[-4000:]
        results[pc] = [json.loads((out / f"rank{r}.json").read_text()) for r in range(pc)]
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{2: [rank results], 3: [rank results]}: both groups run at once."""
    tmp = tmp_path_factory.mktemp("ranks")
    groups = {2: _spawn(tmp, 2, "sweep,train"), 3: _spawn(tmp, 3, "sweep")}
    return _wait(groups)


@pytest.fixture(scope="module")
def shared():
    ns: dict = {}
    exec(SHARED, ns)
    return ns


@pytest.fixture(scope="module")
def jax_sweeps(shared):
    """The JAX package's single-process results on the same stub steps."""

    class Src:
        image_hw = (shared["HW"], shared["HW"])
        images = shared["stub_images"]()

        def __len__(self):
            return shared["N_IMG"]

    def tile_step(variables, images, flip):
        return shared["tile_probs"](images)

    def image_step(variables, images, flip):
        return shared["image_out"](images)

    cats, counts = jinfer.inference_image(Src(), image_step, None, batch_size=2)
    p, c = jinfer.inference_tiles_and_counts(Src(), tile_step, image_step, None, 16, 10,
                                             image_batch=2)
    return {"tiles": jinfer.inference_tiles(Src(), tile_step, None, 16, 10, image_batch=2),
            "categories": cats, "counts": counts, "tc_probs": p, "tc_counts": c}


def _sweep_gate(ranks: list, want: dict) -> bool:
    """Every rank's merged results equal to the single-process ones, exactly."""
    return all(np.array_equal(np.asarray(got[k], dtype=np.asarray(want[k]).dtype), want[k])
               for got in ranks for k in want)


@pytest.mark.parametrize("pc", [2, 3])
@pytest.mark.parametrize("what", ["tiles", "image", "tiles_and_counts"])
def test_merged_sweeps_equal_jax_single_process(runs, jax_sweeps, pc, what):
    keys = {"tiles": ("tiles",), "image": ("categories", "counts"),
            "tiles_and_counts": ("tc_probs", "tc_counts")}[what]
    assert _sweep_gate([r["sweeps"] for r in runs[pc]], {k: jax_sweeps[k] for k in keys})


@pytest.mark.parametrize("pc", [2, 3])
def test_sweep_coverage_is_disjoint_and_complete(runs, pc):
    batches = [r["sweeps"]["batches"] for r in runs[pc]]
    assert [r["rank"] for r in runs[pc]] == list(range(pc))
    assert sorted(b for bs in batches for b in bs) == [0, 1, 2, 3]
    assert batches == [list(range(r, 4, pc)) for r in range(pc)]  # 2/2, 2/1/1


@pytest.mark.parametrize("pc", [2, 3])
def test_process_group_and_mesh(runs, pc):
    for r in runs[pc]:
        assert r["world"] == pc and r["backend"] == r["dist_backend"] == "gloo"
        assert r["mesh"] == [pc, r["rank"], pc] and r["local_rank"] == r["rank"]
        assert r["bad_mesh"] == f"mesh {pc}x2 != {pc} processes"
        assert "C-contiguous" in r["non_contiguous"]


def test_planted_merge_fault_is_rejected(runs, jax_sweeps):
    """A merge that drops rank 1's rows fails the sweep gate (rank 0 lacks
    them; rank 1 filled its own rows itself)."""
    for k in ("tiles", "counts", "tc_probs"):
        assert not _sweep_gate([r["merge_drop"] for r in runs[2]], {k: jax_sweeps[k]}), k


@pytest.mark.parametrize("n", range(1, 17))
def test_local_mesh_shape_is_the_jax_rule(n):
    assert tmesh.local_mesh_shape(n) == jmesh.local_mesh_shape(n)


def test_make_mesh_on_one_process():
    m = tmesh.make_mesh()
    assert (m.rank, m.size) == (0, 1)
    assert not tmesh.distributed(m)
    with pytest.raises(ValueError, match="mesh 2x1 != 1 processes"):
        tmesh.make_mesh(data=2, model=1)


@pytest.mark.parametrize("hosts,want", [
    ([("a", 0)] * 2, "gloo"),                     # CPU ranks
    ([("a", 1)], "nccl"),                         # one rank, one card
    ([("a", 1)] * 2, "gloo"),                     # two ranks share a card
    ([("a", 4)] * 4 + [("b", 4)] * 4, "nccl"),    # 2 hosts x 4 cards, world 8
    ([("a", 4)] * 5 + [("b", 4)] * 3, "gloo"),    # host a oversubscribed
    ([("a", 4)] * 2 + [("b", 0)] * 2, "gloo"),    # host b on the CPU
])
def test_choose_backend_per_host(hosts, want):
    assert tmultihost.choose_backend(hosts) == want


@pytest.fixture(scope="module")
def resnet50_specs():
    """The JAX rule's sharded leaves of ResNet-50's tree (from the shapes
    alone), each carried to its port name through the weight bridge: every
    leaf filled with its own index."""
    jm = jbuild_model("resnet50")
    shapes = jax.eval_shape(lambda: init_variables(jm, jax.random.PRNGKey(0)))
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [np.broadcast_to(np.float32(i), leaf.shape) for i, (_, leaf) in enumerate(paths)])
    sd, _ = jax_to_state_dict(tree)
    leaf_name = {int(v.reshape(-1)[0]): k for k, v in sd.items()}
    return paths, leaf_name


@pytest.mark.parametrize("model_size", [1, 2, 3, 4])
def test_shard_rule_picks_the_jax_leaves(resnet50_specs, model_size):
    paths, leaf_name = resnet50_specs
    want = {leaf_name[i] for i, (path, leaf) in enumerate(paths)
            if path[0].key == "params"
            and jsharding._spec_for(path, leaf, model_size) != jax.sharding.PartitionSpec()}
    model = build_model("resnet50", device="cpu")
    specs = {name: tsharding.spec_for(name, p.shape, model_size)
             for name, p in model.named_parameters()}
    got = {k for k, s in specs.items() if s}
    assert got == want
    assert (len(got) == 3) == (model_size in (2, 4)), got  # fc_tile, two image Dense_0
    assert all(specs[k] == (None, "model") for k in got)


def _step_gate(rd: dict) -> bool:
    return (rd["loss_rel"] <= 1e-5 and rd["grad_cos"] >= 0.99999
            and rd["grad_norm_rel"] <= 1e-5 and rd["stats_rel"] <= 1e-5)


@pytest.mark.parametrize("kind", ["stage1", "seg"])
def test_two_rank_step_equals_one_rank_step(runs, kind):
    rd = runs[2][0][f"{kind}_clean"]
    assert _step_gate(rd), rd


@pytest.mark.parametrize("fault", ["bn_local", "local_count", "grad_mean"])
@pytest.mark.parametrize("kind", ["stage1", "seg"])
def test_planted_step_faults_are_rejected(runs, kind, fault):
    rd = runs[2][0][f"{kind}_{fault}"]
    assert not _step_gate(rd), rd


@pytest.fixture(scope="module")
def one_rank_stage2(shared):
    from cellsegmentation_tpu_torch.data.lysto import LystoDataSource
    from cellsegmentation_tpu_torch.models import Bottleneck, MILNet, ResNetEncoder
    from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
    from cellsegmentation_tpu_torch.models.milnet import init_milnet
    from cellsegmentation_tpu_torch.train.trainers import train_stage2
    from cellsegmentation_tpu_torch.utils.logging import RunLogger
    import tempfile

    imgs, organs, counts = shared["train_arrays"](shared["S2_IMAGES"], shared["S2_HW"], 3)
    src = LystoDataSource.from_arrays(imgs, organs, counts, kfold=None, augment=True)
    model = init_milnet(MILNet(ResNetEncoder(Bottleneck, (1, 1, 1, 1), policy=F32_POLICY),
                               policy=F32_POLICY), 5)
    with tempfile.TemporaryDirectory() as d:
        # the 2-rank sweep's calls are each rank's half of the global batch
        r = train_stage2(model, src, None, image_batch=shared["S2_BATCH"] // 2,
                         logger=RunLogger(d, tensorboard=False), **shared["S2"])
    return r.selections[0], [t.detach().numpy() for t in model.fc_tile.parameters()]


def test_two_rank_stage2_epoch_equals_one_rank(runs, one_rank_stage2):
    sel, fc = one_rank_stage2
    for r in runs[2]:
        for k, v in sel.items():
            assert np.array_equal(np.asarray(r["selection"][k]), v), (r["rank"], k)
    a, b = ([np.asarray(t, np.float32) for t in r["fc_tile"]] for r in runs[2])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))  # bit-identical across ranks
    for x, want in zip(a, fc):
        assert np.abs(x - want).max() <= 1e-5 * np.abs(want).max()
    assert len(sel["label"]) > 0 and 0 < sel["label"].sum() < len(sel["label"])


@pytest.fixture(scope="module")
def one_rank_masks(shared):
    from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
    from cellsegmentation_tpu_torch.data.lysto import LystoDataSource
    from cellsegmentation_tpu_torch.models import BasicBlock, MILNet, ResNetEncoder
    from cellsegmentation_tpu_torch.models.milnet import init_milnet
    from cellsegmentation_tpu_torch.train.trainers import draw_pseudo_masks
    from cellsegmentation_tpu_torch.utils.logging import RunLogger
    import tempfile

    imgs, organs, counts = shared["train_arrays"](8, 48, 6)
    src = LystoDataSource.from_arrays(imgs, organs, counts, kfold=None)
    model = init_milnet(MILNet(ResNetEncoder(BasicBlock, (1, 1, 1, 1), policy=F32_POLICY),
                               policy=F32_POLICY), 7)
    with torch.no_grad():
        model.fc_image_reg[7].bias.fill_(5.0)
    with tempfile.TemporaryDirectory() as d:
        return draw_pseudo_masks(model, src, tile_size=16, interval=8, threshold=0.5,
                                 image_batch=3, engine="flax", device="cpu",
                                 logger=RunLogger(d, tensorboard=False))


@pytest.mark.parametrize("pc", [2, 3])
def test_multi_rank_draw_paints_the_one_rank_masks(runs, one_rank_masks, pc):
    assert 0 < one_rank_masks.mean() < 1
    for r in runs[pc]:
        assert np.array_equal(np.asarray(r["masks"], np.uint8), one_rank_masks), r["rank"]


def test_two_rank_epochs_leave_ranks_equal(runs):
    """train_stage1 (with hard-example resampling) and train_stage3 over 2
    ranks that start from different weights: rank 0's are broadcast, the
    logged losses are the global ones, and every rank ends with the same
    weights, statistics and resampled pool."""
    e0, e1 = (r["epochs"] for r in runs[2])
    assert e0 == e1
    assert np.isfinite(e0["stage1_loss"]) and np.isfinite(e0["stage3_loss"])
