"""The port's stage-1 image train step held against the JAX package's, one
update under injected dropout masks for every ``heads`` x ``reg_loss`` x
optimizer (Adam; SGD with OneCycleLR), and a 3-step loss trajectory. The
fixture, the mask injection and the step runner are
``tests/test_torch_port_stage1.py``'s; this file holds the step grid apart
so that the two files' JAX compiles can run on two test workers.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from cellsegmentation_tpu.train import schedules as jsched
from cellsegmentation_tpu.train import state as jstate
from cellsegmentation_tpu.train import steps as jsteps

from cellsegmentation_tpu_torch.core.dtypes import F32_POLICY
from cellsegmentation_tpu_torch.train import schedules as tsched
from cellsegmentation_tpu_torch.train import state as tstate
from cellsegmentation_tpu_torch.train import steps as tsteps
from cellsegmentation_tpu_torch.utils.jax_weights import jax_to_state_dict

from test_torch_port_slice import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_stage1 import (  # noqa: F401 (fx: a fixture)
    HEADS,
    _intercept,
    _port_masks,
    _port_model,
    _rel,
    _state_dict,
    fx,
)

LR = 1e-3


def _jax_state(v, heads, use_sgd, spe=4):
    stage = {"both": "image", "cls": "image_cls", "reg": "image_reg"}[heads]
    sched = jsched.make_schedule("OneCycleLR" if use_sgd else None, LR, 2, spe)
    return jstate.create_train_state(v["params"], v["batch_stats"], stage, sched,
                                     use_sgd=use_sgd)


def _port_state(model, heads, use_sgd, spe=4):
    stage = {"both": "image", "cls": "image_cls", "reg": "image_reg"}[heads]
    sched = tsched.make_schedule("OneCycleLR" if use_sgd else None, LR, 2, spe)
    return tstate.create_train_state(model, stage, sched, use_sgd=use_sgd,
                                     device="cpu")


def _run_steps(fx, n, heads="both", reg_loss="mse", use_sgd=False):
    """n steps on the same batch and masks, JAX then port:
    (JAX state, [JAX metrics], port model, port state, [port metrics])."""
    v, b = fx["variables"], fx["batch"]
    js = _jax_state(v, heads, use_sgd)
    jstep = jsteps.make_image_train_step(fx["jmodel"], heads=heads, reg_loss=reg_loss)
    jm = []
    with _intercept(fx["masks"]):
        for _ in range(n):
            js, m = jstep(js, b, jax.random.PRNGKey(0))
            jm.append({k: float(x) for k, x in m.items()})
    model = _port_model(F32_POLICY, v)
    ts = _port_state(model, heads, use_sgd)
    tstep = tsteps.make_image_train_step(model, heads=heads, reg_loss=reg_loss,
                                         device="cpu")
    tm = []
    for _ in range(n):
        ts, m = tstep(ts, b, dropout_masks=_port_masks(fx["masks"]))
        tm.append({k: float(x) for k, x in m.items()})
    return js, jm, model, ts, tm


# One step, f32 on both sides (measured on this fixture in brackets).
# Losses within LOSS_RTOL (<= 8.4e-6) and running statistics within 1e-4 of
# each entry's largest value (1.3e-5): train-mode BatchNorm on 32 values a
# channel amplifies rounding, so these sit above the eval forward's 1e-5.
# Parameters, compared as updates p1 - p0 per partition:
# - SGD: the relative L2 gap of the updates. Below layer3 both sides'
#   gradients sit 1.4e-3 to 3.2e-3 from a float64 copy of the port (the
#   backward through the layer3.0 BatchNorms loses that much in f32), so
#   the encoder is held to 2e-2 (<= 6.9e-3) and the heads to 1e-3
#   (<= 1.4e-4).
# - Adam: the first update is lr * g / (|g| + eps), about +-lr whatever |g|,
#   so a gradient that is zero up to rounding (one of every few thousand
#   here; the Dense(64) biases ahead of a train-mode BatchNorm have a zero
#   gradient by construction) takes either sign on the two sides. Held:
#   the share of entries whose updates differ by more than lr / 100 at most
#   ADAM_SHARE (<= 4.9e-4), and every entry within 2 * lr.
LOSS_RTOL = 2e-5
STAT_TOL = 1e-4
SGD_L2 = {"encoder": 2e-2, "fc_image_cls": 1e-3, "fc_image_reg": 1e-3}
ADAM_SHARE = 2e-3


@pytest.mark.parametrize("use_sgd", [False, True], ids=["adam", "sgd_onecycle"])
@pytest.mark.parametrize("reg_loss", ["mse", "weighted_mse"])
@pytest.mark.parametrize("heads", ["both", "cls", "reg"])
def test_image_train_step_matches_jax(fx, heads, reg_loss, use_sgd):
    """One make_image_train_step update under injected masks: the metrics,
    every partition's parameters and running statistics (the frozen head's
    parameters unchanged on both sides, its statistics moved), fc_tile
    untouched."""
    v = fx["variables"]
    js, (jm,), model, ts, (tm,) = _run_steps(fx, 1, heads, reg_loss, use_sgd)
    assert tm.keys() == jm.keys() == {"loss_cls", "loss_reg", "loss"}
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    assert ts.step == int(js.step) == 1
    want = {k: x.numpy() for k, x in
            jax_to_state_dict(jax.tree_util.tree_map(np.asarray, js.variables))[0].items()}
    before = {k: x.numpy() for k, x in jax_to_state_dict(v)[0].items()}
    got = _state_dict(model)
    for k in (k for k in want if "running_" in k):
        assert _rel(got[k], want[k]) <= STAT_TOL, (k, _rel(got[k], want[k]))
        # the seg decoder does not run in the image mode
        moved = not np.array_equal(got[k], before[k])
        assert moved != k.startswith("seg_decoder."), k
    frozen = {"cls": "fc_image_reg", "reg": "fc_image_cls"}.get(heads)
    for part in ("encoder", *HEADS, "fc_tile"):
        keys = [k for k in want if k.startswith(part) and "running_" not in k]
        if part in (frozen, "fc_tile"):
            for k in keys:
                assert np.array_equal(got[k], before[k]) and np.array_equal(want[k], before[k]), k
            continue
        ut = np.concatenate([(got[k] - before[k]).ravel() for k in keys])
        uj = np.concatenate([(want[k] - before[k]).ravel() for k in keys])
        if use_sgd:
            gap = np.linalg.norm(ut - uj) / np.linalg.norm(uj)
            assert gap <= SGD_L2[part], (part, gap)
        else:
            share = float((np.abs(ut - uj) > LR / 100).mean())
            assert share <= ADAM_SHARE, (part, share)
            assert np.abs(ut - uj).max() <= 2 * LR * (1 + 1e-3), part
        assert np.abs(ut).max() > 0, part  # the partition trained


def test_image_loss_trajectory_matches_jax(fx):
    """Three Adam steps on one batch (the slice's gate): the loss falls
    and the three losses agree within 5e-3 relative (measured <= 4.9e-4:
    the first step's sign ties move a few hundred parameters by 2 * lr)."""
    _, jm, _, _, tm = _run_steps(fx, 3)
    lj, lt = [m["loss"] for m in jm], [m["loss"] for m in tm]
    np.testing.assert_allclose(lt, lj, rtol=5e-3)
    assert lt[2] < lt[0]
