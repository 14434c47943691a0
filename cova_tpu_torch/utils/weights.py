"""Weights carried across: the JAX package's Flax trees -> this port's
state_dict, and loading reference-format ``.pth`` files.

``state_dict_from_jax`` is a JAX-free copy of
``cova_tpu/utils/torch_port.py::export_cova_state_dict`` (and its
``_visual_row_perm``), extended to every backbone of the registry by the
inverse of ``port_resnet_backbone`` there: it takes the Flax ``params`` and
``batch_stats`` trees as numpy arrays (``jax.device_get`` them first) and returns the
reference-namespace ``state_dict`` that ``models.cova.CoVA`` strict-loads.

Layout conversions: Flax conv [kh, kw, I, O] -> torch [O, I, kh, kw]; Flax
dense [I, O] -> torch [O, I]; BN scale/bias + batch_stats mean/var ->
weight/bias/running_mean/running_var. The JAX model flattens the RoI
features channel-minor ([r, r, C]) while torch flattens channel-major
([C, r, r]), so the rows of every weight that reads the visual feature are
permuted back.
"""

from __future__ import annotations

import collections
from typing import Any, Mapping

import numpy as np
import torch

from ..config import BACKBONES


def _visual_row_perm(n_feat: int, roi: int = 3, channels: int = 64):
    """``perm`` with ``W_jax[row] = W_torch[perm[row]]`` over the rows of a
    weight that consumes the feature vector (identity past the visual
    block)."""
    perm = np.arange(n_feat)
    for i in range(roi):
        for j in range(roi):
            for c in range(channels):
                perm[i * roi * channels + j * channels + c] = (
                    c * roi * roi + i * roi + j
                )
    return perm


def _inv_rows(kernel: np.ndarray, perm: np.ndarray) -> np.ndarray:
    out = np.empty_like(kernel)
    out[perm] = kernel
    return out


def state_dict_from_jax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any], cfg
) -> "collections.OrderedDict[str, torch.Tensor]":
    """Flax CoVA trees (numpy leaves) -> the port's state_dict, key for key
    and value for value what ``export_cova_state_dict`` writes."""
    sd: "collections.OrderedDict[str, torch.Tensor]" = (
        collections.OrderedDict()
    )

    def put(key: str, arr) -> None:
        sd[key] = torch.from_numpy(
            np.array(np.asarray(arr, dtype=np.float32), copy=True, order="C")
        )

    def put_conv(key: str, kernel) -> None:
        put(key, np.asarray(kernel, np.float32).transpose(3, 2, 0, 1))

    def put_linear(prefix: str, dense: Mapping[str, Any]) -> None:
        put(f"{prefix}.weight", np.asarray(dense["kernel"], np.float32).T)
        put(f"{prefix}.bias", dense["bias"])

    def put_bn(prefix: str, p: Mapping[str, Any], s: Mapping[str, Any]):
        put(f"{prefix}.weight", p["scale"])
        put(f"{prefix}.bias", p["bias"])
        put(f"{prefix}.running_mean", s["mean"])
        put(f"{prefix}.running_var", s["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    if cfg.backbone not in BACKBONES:
        raise ValueError(
            f"state_dict_from_jax: the JAX package has no backbone "
            f"{cfg.backbone!r}, and no released file of it is in the "
            "repository")
    cp, cs = params["convnet"], batch_stats["convnet"]
    stage_sizes, n_stages, bottleneck = BACKBONES[cfg.backbone]
    block_name = "Bottleneck" if bottleneck else "BasicBlock"
    n_blocks = sum(stage_sizes[:n_stages])
    expect = {"Conv_0", "BatchNorm_0",
              *(f"{block_name}_{i}" for i in range(n_blocks))}
    if set(cp.keys()) != expect:
        raise ValueError(
            f"state_dict_from_jax: backbone {cfg.backbone!r} expects the "
            f"convnet tree {sorted(expect)}; got {sorted(cp.keys())}"
        )
    put_conv("convnet.0.weight", cp["Conv_0"]["kernel"])
    put_bn("convnet.1", cp["BatchNorm_0"]["BatchNorm_0"],
           cs["BatchNorm_0"]["BatchNorm_0"])
    # Flax auto-names: Conv_i/BatchNorm_i are conv{i+1}/bn{i+1}; the last
    # pair of a block with a projection shortcut is downsample.{0,1}.
    n_main = 3 if bottleneck else 2
    bi = 0
    for stage in range(n_stages):
        for blk in range(stage_sizes[stage]):
            bp, bs = cp[f"{block_name}_{bi}"], cs[f"{block_name}_{bi}"]
            prefix = f"convnet.{4 + stage}.{blk}"
            names = [(f"conv{i + 1}", f"bn{i + 1}") for i in range(n_main)]
            if f"Conv_{n_main}" in bp:
                names.append(("downsample.0", "downsample.1"))
            for ci, (cname, bname) in enumerate(names):
                put_conv(f"{prefix}.{cname}.weight",
                         bp[f"Conv_{ci}"]["kernel"])
                put_bn(f"{prefix}.{bname}",
                       bp[f"BatchNorm_{ci}"]["BatchNorm_0"],
                       bs[f"BatchNorm_{ci}"]["BatchNorm_0"])
            bi += 1

    if cfg.bbox_hidden_dim > 0:
        put_linear("bbox_feat_encoder.0", params["bbox_linear"]["Dense_0"])
        put_bn("bbox_feat_encoder.1", params["bbox_bn"],
               batch_stats["bbox_bn"])

    n_add = cfg.n_additional_feat if cfg.use_additional_feat else 0
    if n_add > 0:
        put_bn("bn_additional_feat", params["additional_bn"],
               batch_stats["additional_bn"])

    channels = cfg.backbone_channels
    n_feat = channels * cfg.roi**2 + cfg.bbox_hidden_dim + n_add
    perm = _visual_row_perm(n_feat, cfg.roi, channels)

    if cfg.use_context:
        gat = params["gat"]
        for name in ("W_i", "W_j"):
            k = np.asarray(gat[name]["kernel"], np.float32)
            put(f"gat.{name}.weight", _inv_rows(k, perm).T)
        put("gat.attention_layer.weight",
            np.asarray(gat["att_w"], np.float32).T)
        put("gat.attention_layer.bias", gat["att_b"])

    dec = np.asarray(params["decoder_hidden"]["Dense_0"]["kernel"], np.float32)
    dec_perm = np.concatenate([perm, np.arange(n_feat, dec.shape[0])])
    put("decoder.1.weight", _inv_rows(dec, dec_perm).T)
    put("decoder.1.bias", params["decoder_hidden"]["Dense_0"]["bias"])
    put_bn("decoder.2", params["decoder_bn"], batch_stats["decoder_bn"])
    put_linear("decoder.5", params["decoder_out"]["Dense_0"])
    return sd


def load_state_dict_file(path: str) -> Mapping[str, torch.Tensor]:
    """Load a reference-format ``.pth`` state_dict onto the CPU (tensors
    only: ``weights_only`` refuses arbitrary pickled objects)."""
    return torch.load(path, map_location="cpu", weights_only=True)
