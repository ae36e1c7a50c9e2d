"""Weight bridge between the JAX package's ``{"params", "batch_stats"}``
tree, as nested numpy arrays, and the port's ``state_dict``, both ways, and
between the JAX package's optax state and the port's torch optimizer.

The layout maps (the inverse of the JAX package's torchvision converter):
- HWIO conv kernels become OIHW (a grouped 3x3's ``[3, 3, C/g, C']``
  becomes ``[C', C/g, 3, 3]``, the layout of a grouped ``nn.Conv2d``);
- a Dense ``[in, out]`` kernel becomes a Linear ``[out, in]`` weight;
- BatchNorm ``scale/bias`` + stats ``mean/var`` become
  ``weight/bias/running_mean/running_var``;
- encoder blocks ``layer<s>_<b>/ConvBNAct_<i>`` become ``layer<s>.<b>.conv<i+1>``
  / ``bn<i+1>``, the projection ``downsample.0/1``;
- an image head's ``BatchNorm_0`` / ``Dense_0`` / ``BatchNorm_1`` /
  ``Dense_1`` become its ``.1`` / ``.4`` / ``.5`` / ``.7``; EfficientNet's
  single-Dense head's ``Dense_0`` becomes its ``.2``;
- an EfficientNet encoder's ``_ConvNormSiLU_0`` (the stem) becomes
  ``features.0``, ``MBConv_<i>`` block j of stage s, ``features.<s>.<j>``
  (by the port encoder's ``stage_depths``: the JAX tree numbers its blocks
  through the stages), and ``_ConvNormSiLU_1`` (the widening 1x1) the last
  ``features`` entry. A block's units ``_ConvNormSiLU_0/1/2`` (expand, depthwise,
  project; ``_0/1`` without the expand, told by the key, as the JAX
  package's fold tells it) and ``SqueezeExcitation_0/Conv_0,1`` become
  ``block.<k>`` and ``block.<k>.fc1`` / ``fc2``;
- the seg decoder's ``ConvBNAct_<k>`` becomes ``seg_decoder.upconv<k+1>.0``
  / ``.1`` and its final ``Conv_0`` ``seg_decoder.seg_out_conv``.

``jax_to_state_dict`` reads the partitions a tree has (a pt1 file's has
no ``fc_tile``); top-level subtrees the port does not have are skipped and
returned by name, never dropped silently, and a leaf inside a known
partition that lands on no port entry raises. ``jax_paths`` is the map the
other way, port name -> JAX leaf path, which ``state_dict_to_jax`` and the
optimizer conversions use.

The optimizer: the JAX package runs ``optax.multi_transform({"train":
chain(add_decayed_weights(wd), adam(1.0) | sgd(1.0, momentum)), "freeze":
set_to_zero()})`` over the top-level partitions, the port ``torch.optim.Adam``
/ ``SGD`` over the stage's trainable parameters (train/state.py). Adam's
``mu`` / ``nu`` / ``count`` are ``exp_avg`` / ``exp_avg_sq`` / ``step``,
SGD's ``trace`` is ``momentum_buffer``, each leaf through the weights'
layout maps; frozen partitions carry nothing on either side.
"""

from __future__ import annotations

import numpy as np
import torch

from cellsegmentation_tpu_torch.models.milnet import PARTITIONS


def _to_port(a) -> torch.Tensor:
    """A JAX leaf in the port's layout, f32: a 4-D (HWIO) kernel becomes
    OIHW and a 2-D Dense kernel is transposed."""
    t = a.float() if torch.is_tensor(a) else torch.from_numpy(np.array(a, dtype=np.float32))
    if t.ndim == 4:
        t = t.permute(3, 2, 0, 1)
    elif t.ndim == 2:
        t = t.t()
    return t.contiguous()


def _to_jax(t: torch.Tensor) -> np.ndarray:
    """A port tensor in the JAX layout, the inverse of ``_to_port``."""
    t = t.detach().cpu()
    if t.ndim == 4:
        t = t.permute(2, 3, 1, 0)
    elif t.ndim == 2:
        t = t.t()
    return np.ascontiguousarray(t.numpy())


def _bn(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    sd[f"{prefix}.weight"] = _to_port(params["scale"])
    sd[f"{prefix}.bias"] = _to_port(params["bias"])
    sd[f"{prefix}.running_mean"] = _to_port(stats["mean"])
    sd[f"{prefix}.running_var"] = _to_port(stats["var"])


def _unit(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    """A conv + BatchNorm unit (``Conv_0``, ``BatchNorm_0``) -> ``.0`` /
    ``.1``."""
    _expect(params, {"Conv_0", "BatchNorm_0"}, prefix)
    sd[f"{prefix}.0.weight"] = _to_port(params["Conv_0"]["kernel"])
    _bn(sd, f"{prefix}.1", params["BatchNorm_0"], stats["BatchNorm_0"])


def _expect(tree: dict, keys: set, where: str) -> None:
    if set(tree) != keys:
        raise ValueError(f"{where}: JAX keys {sorted(tree)}, expected {sorted(keys)}")


def _effnet_encoder(params: dict, stats: dict, prefix: str, stage_depths) -> dict:
    n_blocks = sum(k.startswith("MBConv_") for k in params)
    _expect(params, {*(f"MBConv_{i}" for i in range(n_blocks)),
                     "_ConvNormSiLU_0", "_ConvNormSiLU_1"}, prefix)
    if stage_depths is None or sum(stage_depths) != n_blocks:
        raise ValueError(f"{n_blocks} JAX blocks for stage depths {stage_depths}")
    starts = set(np.cumsum((0, *stage_depths[:-1])).tolist())
    sd = {}
    _unit(sd, f"{prefix}features.0", params["_ConvNormSiLU_0"],
          stats["_ConvNormSiLU_0"])
    stage, j = 0, 0
    for i in range(n_blocks):
        bp, bs = params[f"MBConv_{i}"], stats[f"MBConv_{i}"]
        has_expand = "_ConvNormSiLU_2" in bp
        names = [f"_ConvNormSiLU_{k}" for k in range(3 if has_expand else 2)]
        _expect(bp, {*names, "SqueezeExcitation_0"}, f"MBConv_{i}")
        stage, j = (stage + 1, 0) if i in starts else (stage, j + 1)
        bpre = f"{prefix}features.{stage}.{j}.block"
        # [expand,] depthwise, squeeze-excite, project
        for k, name in enumerate(names[:-1] + ["SqueezeExcitation_0", names[-1]]):
            if name != "SqueezeExcitation_0":
                _unit(sd, f"{bpre}.{k}", bp[name], bs[name])
                continue
            se = bp[name]
            _expect(se, {"Conv_0", "Conv_1"}, f"MBConv_{i}/{name}")
            for c, fc in enumerate(("fc1", "fc2")):
                sd[f"{bpre}.{k}.{fc}.weight"] = _to_port(se[f"Conv_{c}"]["kernel"])
                sd[f"{bpre}.{k}.{fc}.bias"] = _to_port(se[f"Conv_{c}"]["bias"])
    _unit(sd, f"{prefix}features.{stage + 1}", params["_ConvNormSiLU_1"],
          stats["_ConvNormSiLU_1"])
    return sd


def _encoder(params: dict, stats: dict, prefix: str, stage_depths=None) -> dict:
    if "_ConvNormSiLU_0" in params:
        return _effnet_encoder(params, stats, prefix, stage_depths)
    sd = {f"{prefix}conv1.weight": _to_port(params["conv1"]["kernel"])}
    _bn(sd, f"{prefix}bn1", params["bn1"], stats["bn1"])
    blocks = sorted(
        (k for k in params if k.startswith("layer")),
        key=lambda k: tuple(int(v) for v in k[len("layer"):].split("_")),
    )
    for key in blocks:
        stage, b = key[len("layer"):].split("_")
        bp, bs = params[key], stats[key]
        # a Bottleneck's first conv is 1x1 (3 convs), a BasicBlock's 3x3 (2)
        n_convs = 3 if bp["ConvBNAct_0"]["Conv_0"]["kernel"].shape[0] == 1 else 2
        tp = f"{prefix}layer{stage}.{b}"
        for ci in range(n_convs):
            cba, cbs = bp[f"ConvBNAct_{ci}"], bs[f"ConvBNAct_{ci}"]
            sd[f"{tp}.conv{ci + 1}.weight"] = _to_port(cba["Conv_0"]["kernel"])
            _bn(sd, f"{tp}.bn{ci + 1}", cba["BatchNorm_0"], cbs["BatchNorm_0"])
        proj = f"ConvBNAct_{n_convs}"
        if proj in bp:
            sd[f"{tp}.downsample.0.weight"] = _to_port(bp[proj]["Conv_0"]["kernel"])
            _bn(sd, f"{tp}.downsample.1", bp[proj]["BatchNorm_0"],
                bs[proj]["BatchNorm_0"])
    return sd


def _dense(sd: dict, prefix: str, params: dict) -> None:
    sd[f"{prefix}.weight"] = _to_port(params["kernel"])
    sd[f"{prefix}.bias"] = _to_port(params["bias"])


_IMAGE_HEAD = (("BatchNorm_0", "1"), ("Dense_0", "4"), ("BatchNorm_1", "5"),
               ("Dense_1", "7"))


def _leaves(tree, path=()):
    """Every (path, leaf) of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield path, tree


def jax_to_state_dict(variables: dict, stage_depths=None) -> tuple[dict, list[str]]:
    """JAX MILNet variables -> (port state_dict, skipped subtree names), of
    the partitions the tree has. An EfficientNet's ``stage_depths`` (its
    encoder's) place its blocks in their stages. Raises on a leaf of a
    known partition that lands on no port entry."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {}
    if "encoder" in params:
        sd.update(_encoder(params["encoder"], stats["encoder"], "encoder.", stage_depths))
    if "fc_tile" in params:
        _expect(params["fc_tile"], {"Dense_0"}, "fc_tile")
        _dense(sd, "fc_tile.1", params["fc_tile"]["Dense_0"])
    heads = ("fc_image_cls", "fc_image_reg")
    for head in (h for h in heads if h in params):
        if "BatchNorm_0" not in params[head]:  # EfficientNet's Dense head
            _expect(params[head], {"Dense_0"}, head)
            _dense(sd, f"{head}.2", params[head]["Dense_0"])
            continue
        for name, idx in _IMAGE_HEAD:
            if name.startswith("Dense"):
                _dense(sd, f"{head}.{idx}", params[head][name])
            else:
                _bn(sd, f"{head}.{idx}", params[head][name], stats[head][name])
    if "seg_decoder" in params:
        dp, ds = params["seg_decoder"], stats["seg_decoder"]
        for k in range(8):
            cba, cbs = dp[f"ConvBNAct_{k}"], ds[f"ConvBNAct_{k}"]
            sd[f"seg_decoder.upconv{k + 1}.0.weight"] = _to_port(cba["Conv_0"]["kernel"])
            _bn(sd, f"seg_decoder.upconv{k + 1}.1", cba["BatchNorm_0"],
                cbs["BatchNorm_0"])
        sd["seg_decoder.seg_out_conv.weight"] = _to_port(dp["Conv_0"]["kernel"])
        sd["seg_decoder.seg_out_conv.bias"] = _to_port(dp["Conv_0"]["bias"])
    skipped = sorted(k for k in params if k not in PARTITIONS)
    read = set(jax_paths(sd, stage_depths).values())
    known = {c: {k: v for k, v in variables.get(c, {}).items() if k not in skipped}
             for c in ("params", "batch_stats")}
    stray = ["/".join(p) for p, _ in _leaves(known) if p not in read]
    if stray:
        raise ValueError(f"{len(stray)} JAX leaves land on no port entry: "
                         + ", ".join(stray[:8]) + ("..." if len(stray) > 8 else ""))
    return sd, skipped


def load_jax_variables(model: torch.nn.Module, variables: dict) -> list[str]:
    """Copy JAX variables into ``model`` in place; returns the skipped
    subtree names. Raises on any port parameter the tree does not cover."""
    sd, skipped = jax_to_state_dict(
        variables, getattr(model.encoder, "stage_depths", None))
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(
            f"JAX variables do not match the port's model: missing {missing[:8]}, "
            f"unexpected {unexpected[:8]}"
        )
    return skipped


# -- port name -> JAX leaf ---------------------------------------------------

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}
_UNIT = {"0": "Conv_0", "1": "BatchNorm_0"}
_HEAD = {"1": "BatchNorm_0", "2": "Dense_0", "4": "Dense_0", "5": "BatchNorm_1",
         "7": "Dense_1"}


def _encoder_module(p: list, keys: set, stage_depths) -> tuple:
    if p in (["conv1"], ["bn1"]):
        return tuple(p)
    if p[0].startswith("layer"):
        block = f"{p[0]}_{p[1]}"
        if p[2] == "downsample":
            n = 3 if f"encoder.{p[0]}.{p[1]}.conv3.weight" in keys else 2
            return block, f"ConvBNAct_{n}", _UNIT[p[3]]
        unit = "Conv_0" if p[2].startswith("conv") else "BatchNorm_0"
        return block, f"ConvBNAct_{int(p[2][-1]) - 1}", unit
    s = int(p[1])  # features.<s>...
    if s in (0, len(stage_depths) + 1):
        return f"_ConvNormSiLU_{0 if s == 0 else 1}", _UNIT[p[2]]
    j, k = int(p[2]), int(p[4])
    block = f"MBConv_{sum(stage_depths[:s - 1]) + j}"
    expand = f"encoder.features.{s}.{j}.block.3.0.weight" in keys
    names = (["_ConvNormSiLU_0", "_ConvNormSiLU_1", "SqueezeExcitation_0", "_ConvNormSiLU_2"]
             if expand else ["_ConvNormSiLU_0", "SqueezeExcitation_0", "_ConvNormSiLU_1"])
    if p[5] in ("fc1", "fc2"):
        return block, names[k], f"Conv_{int(p[5][-1]) - 1}"
    return block, names[k], _UNIT[p[5]]


def _module(mod: str, keys: set, stage_depths) -> tuple:
    p = mod.split(".")
    if p[0] == "encoder":
        return ("encoder", *_encoder_module(p[1:], keys, stage_depths))
    if p == ["fc_tile", "1"]:
        return "fc_tile", "Dense_0"
    if p[0] in ("fc_image_cls", "fc_image_reg") and len(p) == 2:
        return p[0], _HEAD[p[1]]
    if p == ["seg_decoder", "seg_out_conv"]:
        return "seg_decoder", "Conv_0"
    if p[0] == "seg_decoder" and p[1].startswith("upconv"):
        return "seg_decoder", f"ConvBNAct_{int(p[1][len('upconv'):]) - 1}", _UNIT[p[2]]
    raise KeyError(mod)


def jax_paths(keys, stage_depths=None) -> dict:
    """{port state-dict name: JAX leaf path ``("params" | "batch_stats",
    partition, ..., leaf)``} for ``keys`` (torch's ``num_batches_tracked``
    left out: the JAX tree has none). An EfficientNet's ``stage_depths``
    number its blocks. Raises on a name with no JAX leaf."""
    keys = [k for k in keys if not k.endswith("num_batches_tracked")]
    kset = set(keys)
    out = {}
    for key in keys:
        mod, leaf = key.rsplit(".", 1)
        try:
            path = _module(mod, kset, stage_depths)
            if path[-1].startswith("BatchNorm") or path[-1] == "bn1":
                coll, name = _BN_LEAVES[leaf]
            else:
                coll, name = "params", {"weight": "kernel", "bias": "bias"}[leaf]
        except (KeyError, IndexError, ValueError, TypeError):
            raise ValueError(f"the port entry {key} has no JAX leaf") from None
        out[key] = (coll, *path, name)
    return out


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get(tree: dict, path: tuple, what: str):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            raise ValueError(f"{what}: no leaf {'/'.join(path)}")
        tree = tree[k]
    return tree


def _stage_depths(model) -> tuple | None:
    return getattr(model.encoder, "stage_depths", None)


def state_dict_to_jax(model: torch.nn.Module, partitions=None) -> dict:
    """The model's ``{"params", "batch_stats"}`` tree in the JAX package's
    layout, numpy leaves, of ``partitions`` (top-level names) when given:
    the inverse of ``jax_to_state_dict``."""
    sd = model.state_dict()
    keys = [k for k in sd if partitions is None or k.split(".", 1)[0] in partitions]
    out = {"params": {}, "batch_stats": {}}
    for key, path in jax_paths(keys, _stage_depths(model)).items():
        _put(out, path, _to_jax(sd[key]))
    return out


# -- optimizer state ---------------------------------------------------------

_TORCH_SLOT = {"mu": "exp_avg", "nu": "exp_avg_sq", "trace": "momentum_buffer"}


def _core(tree) -> dict:
    """The Adam or SGD state inside the JAX package's optimizer tree:
    ``inner_states/train/inner_state/1/0``, every other node empty."""
    try:
        inner = tree["inner_states"]
        train = inner["train"]["inner_state"]
        ok = (set(inner) == {"train", "freeze"} and inner["freeze"] == {"inner_state": {}}
              and set(train) == {"0", "1"} and train["0"] == {}
              and set(train["1"]) == {"0", "1"} and train["1"]["1"] == {})
    except (KeyError, TypeError):
        ok = False
    if not ok:
        raise ValueError("the optimizer state is not the JAX package's "
                         "multi_transform(chain(add_decayed_weights, adam | sgd), set_to_zero)")
    return train["1"]["0"]


def _trainable(optimizer, model) -> list:
    """(parameter, port name) of every parameter the optimizer holds."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [(p, names[id(p)]) for g in optimizer.param_groups for p in g["params"]]


def optax_to_torch(tree: dict, optimizer: torch.optim.Optimizer,
                   model: torch.nn.Module) -> dict:
    """A torch ``optimizer.state_dict()`` for ``optimizer`` (over ``model``'s
    trainable parameters) from the JAX package's serialized optax state.
    Raises ``ValueError`` when the two do not match: another optimizer core
    (Adam against SGD), other trainable partitions (another stage), a leaf
    missing, extra or of another shape."""
    core = _core(tree)
    adam = isinstance(optimizer, torch.optim.Adam)
    want = {"count", "mu", "nu"} if adam else {"trace"}
    if set(core) != want:
        raise ValueError(f"the file's optimizer holds {sorted(core)}; this run's "
                         f"{type(optimizer).__name__} needs {sorted(want)}")
    held = _trainable(optimizer, model)
    paths = jax_paths([n for _, n in held], _stage_depths(model))
    parts = sorted({n.split(".", 1)[0] for _, n in held})
    slots = sorted(want - {"count"})
    for slot in slots:
        got = sorted(k for k, v in core[slot].items() if v != {})
        if got != parts:
            raise ValueError(f"the file's {slot} trains partitions {got}; this run's "
                             f"optimizer {parts}")
        n_leaves = sum(1 for _ in _leaves(core[slot]))
        if n_leaves != len(held):
            raise ValueError(f"the file's {slot} holds {n_leaves} leaves; this run's "
                             f"optimizer {len(held)} parameters")
    if adam:
        count = np.asarray(core["count"])
        if count.shape != () or count.dtype.kind not in "iu":
            raise ValueError(f"Adam's count is {count.dtype} {count.shape}, not a scalar int")
    state = {}
    for i, (p, name) in enumerate(held):
        entry = {}
        for slot in slots:
            v = _to_port(_get(core[slot], paths[name][1:], slot))
            if v.shape != p.shape:
                raise ValueError(f"{slot} of {name}: shape {tuple(v.shape)}, the "
                                 f"parameter's {tuple(p.shape)}")
            entry[_TORCH_SLOT[slot]] = v
        if adam:
            entry["step"] = torch.tensor(float(count))
        state[i] = entry
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def torch_to_optax(optimizer: torch.optim.Optimizer, model: torch.nn.Module) -> dict:
    """The JAX package's serialized optax state (``to_state_dict`` of its
    ``make_optimizer`` state) from a torch Adam or SGD over ``model``'s
    trainable parameters: the inverse of ``optax_to_torch``. A slot torch
    has not made yet (before the first step) is zeros, optax's init."""
    adam = isinstance(optimizer, torch.optim.Adam)
    if not (adam or isinstance(optimizer, torch.optim.SGD)):
        raise TypeError(f"no optax form for {type(optimizer).__name__}")
    parts = [n for n, _ in model.named_children()]
    slots = ("mu", "nu") if adam else ("trace",)
    trees = {s: {p: {} for p in parts} for s in slots}
    held = _trainable(optimizer, model)
    paths = jax_paths([n for _, n in held], _stage_depths(model))
    step = 0
    for p, name in held:
        st = optimizer.state.get(p, {})
        for s in slots:
            v = st.get(_TORCH_SLOT[s])
            _put(trees[s], paths[name][1:], _to_jax(torch.zeros_like(p) if v is None else v))
        if "step" in st:
            step = int(st["step"])
    core = {"count": np.asarray(step, np.int32), **trees} if adam else trees
    return {"inner_states": {"freeze": {"inner_state": {}},
                             "train": {"inner_state": {"0": {}, "1": {"0": core, "1": {}}}}}}
