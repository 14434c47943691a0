"""Configuration of the PyTorch port: the same frozen ``Config`` as
``cova_tpu/config.py``.

The port keeps its own copy so that it never imports the JAX package. Field
names, defaults and the results-directory key (``params_key``) are identical,
so a run of either package finds the other's artifacts (for example a
``Fold-1 saved_model.pth`` written by ``cova export``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

# Class taxonomy. Index 0 ("BG") is ignored in all accuracy reporting.
CLASS_NAMES: Tuple[str, ...] = ("BG", "Price", "Title", "Image")
N_CLASSES: int = len(CLASS_NAMES)
SEED: int = 123

# Dataset-wide bound on boxes per page (splits/bbox_stats.txt: max 230).
# Padded static batches use the next multiple of 8 that covers it.
DATASET_MAX_BOXES: int = 230

# Cross-validation protocol size (splits/Fold-{1..5}).
N_FOLDS: int = 5


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Config:
    """All knobs for data, model, training and serving; mirrors
    ``cova_tpu.Config``."""

    # ---- paths ----
    data_dir: str = "../data"
    split_dir: str = "splits"
    output_dir: str = "results_5-Fold_CV"

    # ---- reproducibility ----
    seed: int = SEED

    # ---- data / image geometry ----
    img_height: int = 1280  # square screenshots
    context_size: int = 12  # K neighbours each side
    sampling_fraction: float = 0.9  # train-time BG subsampling
    num_workers: int = 5  # host decode thread pool
    max_boxes: int = DATASET_MAX_BOXES  # ragged bound; padded below
    # Decoded-screenshot disk cache dir ("" = off). Not a hyperparameter.
    decode_cache: str = ""

    # ---- model ----
    n_classes: int = N_CLASSES
    roi: int = 3  # RoI pool output is (roi, roi)
    hidden_dim: int = 384  # GAT context dim
    bbox_hidden_dim: int = 32  # bbox positional-feature dim
    use_additional_feat: bool = False
    n_additional_feat: int = 0  # discovered from data when enabled
    drop_prob: float = 0.2
    backbone: str = "resnet18_stem"  # truncated ResNet-18

    # ---- numerics: bf16 compute, f32 params and BN statistics ----
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # ---- training ----
    n_epochs: int = 50
    learning_rate: float = 5e-4
    batch_size: int = 5  # per-step global batch (train loader)
    eval_batch_size: int = 10
    weight_decay: float = 1e-3
    eval_interval: int = 1
    patience: int = 7

    # ---- parallelism ----
    num_devices: int = 1
    model_parallel: int = 1

    # ---- padding buckets ----
    # Eval batches slice the box dim to the smallest bucket that holds the
    # batch's max valid-box count. () disables.
    box_buckets: tuple = (64, 128, 192)

    # ---- fold protocol ----
    cv_fold: int = 1  # 1..5, or -1 = use split_dir files directly

    # ---- derived ----
    @property
    def use_context(self) -> bool:
        return self.context_size > 0

    @property
    def n_context(self) -> int:
        return 2 * self.context_size

    @property
    def gat_hidden_dim(self) -> int:
        # The reference zeroes hidden_dim when context is disabled.
        return self.hidden_dim if self.use_context else 0

    @property
    def pad_boxes(self) -> int:
        """Static per-image box count for padded batches."""
        return _round_up(self.max_boxes, 8)

    @property
    def feature_stride(self) -> int:
        n_stages = 4 if not self.backbone.endswith("_stem") else 1
        return 4 * (2 ** (n_stages - 1))

    @property
    def backbone_channels(self) -> int:
        base = 64 if self.backbone.endswith("_stem") else 512
        if self.backbone.startswith("resnet50"):
            base *= 4  # bottleneck expansion
        return base

    @property
    def n_visual_feat(self) -> int:
        return self.backbone_channels * self.roi * self.roi

    @property
    def n_feat(self) -> int:
        n_add = self.n_additional_feat if self.use_additional_feat else 0
        return self.n_visual_feat + self.bbox_hidden_dim + n_add

    @property
    def n_total_feat(self) -> int:
        return self.n_feat + self.gat_hidden_dim

    # ---- artifact locations (same keying as cova_tpu) ----
    @property
    def params_key(self) -> str:
        """Hyperparameter string that keys the results directory."""
        return (
            "lr-%.0e batch-%d cs-%d hd-%d roi-%d bbhd-%d af-%d wd-%.0e "
            "dp-%.1f sf-%.1f"
            % (
                self.learning_rate,
                self.batch_size,
                self.context_size,
                self.gat_hidden_dim,
                self.roi,
                self.bbox_hidden_dim,
                int(self.use_additional_feat),
                self.weight_decay,
                self.drop_prob,
                self.sampling_fraction,
            )
        )

    @property
    def results_dir(self) -> str:
        return os.path.join(self.output_dir, self.params_key)

    @property
    def fold_dir(self) -> str:
        if self.cv_fold == -1:
            return self.split_dir
        return os.path.join(self.split_dir, "Fold-%d" % self.cv_fold)

    def log_file(self) -> str:
        return os.path.join(self.results_dir, "Fold-%s logs.txt" % self.cv_fold)

    def ckpt_dir(self) -> str:
        """The fold's checkpoints, ``best.pt`` and ``last.pt`` (the JAX
        package keeps its orbax ones in ``Fold-<k> saved_model.orbax``)."""
        return os.path.join(
            self.results_dir, "Fold-%s saved_model.pt" % self.cv_fold
        )

    def torch_model_path(self) -> str:
        """Where ``cova export`` writes the fold's reference-format
        ``state_dict`` (and where the reference's own scripts read it)."""
        return os.path.join(
            self.results_dir, "Fold-%s saved_model.pth" % self.cv_fold
        )

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config()
