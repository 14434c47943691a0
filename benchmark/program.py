"""The system under test, ``cova_tpu_torch``, as the benchmark drives it.

This is the benchmark's one module that imports the port. It builds the
model from the benchmark's weights, turns raw pages into the port's host
batches with the port's own padding, collation and box buckets (as
``DataPipeline`` and ``predict_pages`` dispatch them), and hands the
batches to the port's device feed (``data.device_prefetch``) and its
serving step (``train.steps.forward_step``, which runs through the step
graphs on one card).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

from cova_tpu_torch.config import Config
from cova_tpu_torch.data.batching import Batch, bucket_batch, collate
from cova_tpu_torch.data.device_prefetch import device_prefetch
from cova_tpu_torch.data.records import PageRecord, pad_page
from cova_tpu_torch.models.cova import CoVA
from cova_tpu_torch.train.steps import forward_step


def port_config(cfg: dict) -> Config:
    """The port's ``Config`` of a benchmark configuration."""
    return Config(
        img_height=cfg["img_height"], context_size=cfg["context_size"],
        max_boxes=cfg["max_boxes"], roi=cfg["roi"],
        hidden_dim=cfg["hidden_dim"],
        bbox_hidden_dim=cfg["bbox_hidden_dim"], drop_prob=cfg["drop_prob"],
        backbone=cfg["backbone"], compute_dtype=cfg["compute_dtype"],
        learning_rate=cfg["learning_rate"],
        weight_decay=cfg["weight_decay"], n_classes=cfg["n_classes"],
        box_buckets=tuple(cfg["box_buckets"]))


def build_model(cfg: dict, weights: Dict[str, torch.Tensor],
                device) -> CoVA:
    """The port's model with ``weights`` (strict), on ``device``, in eval
    mode. Built on the meta device, so no initialiser runs."""
    pc = port_config(cfg)
    with torch.device("meta"):
        model = CoVA(
            n_classes=pc.n_classes, use_context=pc.use_context,
            hidden_dim=pc.gat_hidden_dim,
            bbox_hidden_dim=pc.bbox_hidden_dim, n_additional_feat=0,
            drop_prob=pc.drop_prob, roi_output_size=pc.roi,
            backbone=pc.backbone,
            compute_dtype=getattr(torch, pc.compute_dtype))
    model = model.to_empty(device=torch.device(device))
    model.load_state_dict(weights, strict=True)
    return model.eval()


def host_batch(pages: List[dict], cfg: dict) -> Batch:
    """The port's host batch of raw pages: each padded to the static box
    count with its context indices, collated (screenshots in s2d(4) form),
    then cut to its box bucket."""
    pc = port_config(cfg)
    padded = [pad_page(PageRecord(pg["page_id"], pg["boxes_xywh"],
                                  pg["labels"]), pc.pad_boxes,
                       pc.context_size) for pg in pages]
    batch = collate([pg["image"] for pg in pages], padded)
    return bucket_batch(batch, pc.box_buckets)


def feed(items: Iterable, device, size: int):
    """The port's device feed over ``(key, Batch)`` items: yields
    ``(key, host batch, batch on the device)``."""
    return device_prefetch(items, device, size=size)


def serve(model, batch):
    """The logits of a batch, as a device tensor [B, P, classes]."""
    return forward_step(model, batch).logits
