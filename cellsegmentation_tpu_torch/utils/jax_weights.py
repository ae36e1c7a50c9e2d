"""Weight bridge: the JAX package's ``{"params", "batch_stats"}`` tree, as
nested numpy arrays, -> the port's ``state_dict``.

The inverse of the JAX package's torchvision converter:
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

Subtrees the port does not have are skipped and returned by name, never
dropped silently.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1)))


def _bn(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])


def _unit(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    """A conv + BatchNorm unit (``Conv_0``, ``BatchNorm_0``) -> ``.0`` /
    ``.1``."""
    _expect(params, {"Conv_0", "BatchNorm_0"}, prefix)
    sd[f"{prefix}.0.weight"] = _conv(params["Conv_0"]["kernel"])
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
                sd[f"{bpre}.{k}.{fc}.weight"] = _conv(se[f"Conv_{c}"]["kernel"])
                sd[f"{bpre}.{k}.{fc}.bias"] = _t(se[f"Conv_{c}"]["bias"])
    _unit(sd, f"{prefix}features.{stage + 1}", params["_ConvNormSiLU_1"],
          stats["_ConvNormSiLU_1"])
    return sd


def _encoder(params: dict, stats: dict, prefix: str, stage_depths=None) -> dict:
    if "_ConvNormSiLU_0" in params:
        return _effnet_encoder(params, stats, prefix, stage_depths)
    sd = {f"{prefix}conv1.weight": _conv(params["conv1"]["kernel"])}
    _bn(sd, f"{prefix}bn1", params["bn1"], stats["bn1"])
    blocks = sorted(
        (k for k in params if k.startswith("layer")),
        key=lambda k: tuple(int(v) for v in k[len("layer"):].split("_")),
    )
    for key in blocks:
        stage, b = key[len("layer"):].split("_")
        bp, bs = params[key], stats[key]
        # a Bottleneck's first conv is 1x1 (3 convs), a BasicBlock's 3x3 (2)
        k0 = np.asarray(bp["ConvBNAct_0"]["Conv_0"]["kernel"])
        n_convs = 3 if k0.shape[0] == 1 else 2
        tp = f"{prefix}layer{stage}.{b}"
        for ci in range(n_convs):
            cba, cbs = bp[f"ConvBNAct_{ci}"], bs[f"ConvBNAct_{ci}"]
            sd[f"{tp}.conv{ci + 1}.weight"] = _conv(cba["Conv_0"]["kernel"])
            _bn(sd, f"{tp}.bn{ci + 1}", cba["BatchNorm_0"], cbs["BatchNorm_0"])
        proj = f"ConvBNAct_{n_convs}"
        if proj in bp:
            sd[f"{tp}.downsample.0.weight"] = _conv(bp[proj]["Conv_0"]["kernel"])
            _bn(sd, f"{tp}.downsample.1", bp[proj]["BatchNorm_0"],
                bs[proj]["BatchNorm_0"])
    return sd


def _dense(sd: dict, prefix: str, params: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(params["kernel"], np.float32).T)
    sd[f"{prefix}.bias"] = _t(params["bias"])


_IMAGE_HEAD = (("BatchNorm_0", "1"), ("Dense_0", "4"), ("BatchNorm_1", "5"),
               ("Dense_1", "7"))


def jax_to_state_dict(variables: dict, stage_depths=None) -> tuple[dict, list[str]]:
    """JAX MILNet variables -> (port state_dict, skipped subtree names).
    An EfficientNet's ``stage_depths`` (its encoder's) place its blocks in
    their stages."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = _encoder(params["encoder"], stats["encoder"], "encoder.", stage_depths)
    _dense(sd, "fc_tile.1", params["fc_tile"]["Dense_0"])
    heads = ("fc_image_cls", "fc_image_reg")
    for head in heads:
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
            sd[f"seg_decoder.upconv{k + 1}.0.weight"] = _conv(cba["Conv_0"]["kernel"])
            _bn(sd, f"seg_decoder.upconv{k + 1}.1", cba["BatchNorm_0"],
                cbs["BatchNorm_0"])
        sd["seg_decoder.seg_out_conv.weight"] = _conv(dp["Conv_0"]["kernel"])
        sd["seg_decoder.seg_out_conv.bias"] = _t(dp["Conv_0"]["bias"])
    known = ("encoder", "fc_tile", *heads, "seg_decoder")
    skipped = sorted(k for k in params if k not in known)
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
