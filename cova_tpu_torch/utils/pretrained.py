"""Checksum-pinned pretrained-backbone loading.

Counterpart of ``cova_tpu/utils/pretrained.py``. The reference initialises
its backbone from torchvision's ImageNet weights; the files are supplied by
the user (nothing is downloaded here), and the load is tamper-evident:

  * ``PRETRAINED_REGISTRY`` pins each supported torchvision checkpoint by
    its canonical file name, URL and sha256 prefix. torchvision embeds the
    first 8 hex characters of the file's sha256 in its name, and the
    registry pins the same value.
  * ``verify_checkpoint`` hashes the local file and refuses a mismatch.
  * ``load_verified_backbone`` verifies, loads and renames the entries to
    the backbone's own keys (torchvision's ``conv1``, ``bn1``,
    ``layer<k>`` are children ``0``, ``1``, ``<3+k>`` of the reference's
    truncated ``nn.Sequential``), ready for
    ``model.convnet.load_state_dict(..., strict=True)``.

Recipe, on a machine with network access:

    wget https://download.pytorch.org/models/resnet18-f37072fd.pth
    sha256sum resnet18-f37072fd.pth   # must start with f37072fd
    python -m cova_tpu_torch.cli train --init_checkpoint resnet18-f37072fd.pth

A file under another name (a fine-tuned or truncated state_dict in
torchvision's key layout) loads without the pin, with a note.
"""

from __future__ import annotations

import collections
import hashlib
import os
from typing import Any, Dict, Mapping

from ..config import BACKBONES
from .weights import load_state_dict_file

PRETRAINED_REGISTRY: Dict[str, Dict[str, Any]] = {
    "resnet18": {
        "file": "resnet18-f37072fd.pth",
        "url": "https://download.pytorch.org/models/resnet18-f37072fd.pth",
        "sha256_prefix": "f37072fd",
        # Entries of a torchvision ResNet-18 state_dict: 62 parameters, 40
        # BN running statistics, 20 num_batches_tracked.
        "n_state_entries": 122,
    },
    "resnet34": {
        "file": "resnet34-b627a593.pth",
        "url": "https://download.pytorch.org/models/resnet34-b627a593.pth",
        "sha256_prefix": "b627a593",
        "n_state_entries": 218,
    },
    "resnet50": {
        "file": "resnet50-0676ba61.pth",
        "url": "https://download.pytorch.org/models/resnet50-0676ba61.pth",
        "sha256_prefix": "0676ba61",
        "n_state_entries": 320,
    },
}

# Which registry entry each ``make_backbone`` variant initialises from.
BACKBONE_TO_WEIGHTS = {
    "resnet18_stem": "resnet18",
    "resnet18": "resnet18",
    "resnet34_stem": "resnet34",
    "resnet50_stem": "resnet50",
    "resnet50": "resnet50",
}


def _weights_key(backbone: str) -> str:
    """The registry entry ``backbone`` initialises from; a ValueError for a
    backbone that has none."""
    if backbone not in BACKBONE_TO_WEIGHTS:
        raise ValueError(
            f"no pretrained file for backbone {backbone!r}: the registry pins "
            "torchvision's ResNets, and no released checkpoint of it is in "
            "the repository")
    return BACKBONE_TO_WEIGHTS[backbone]


def sha256_of(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(chunk), b""):
            h.update(blk)
    return h.hexdigest()


def verify_checkpoint(path: str, weights_key: str) -> str:
    """Hash ``path`` and check it against the pinned registry entry.
    Returns the full sha256; raises ValueError on a mismatch, so a
    truncated or wrong file cannot initialise a training run unnoticed."""
    entry = PRETRAINED_REGISTRY[weights_key]
    digest = sha256_of(path)
    if not digest.startswith(entry["sha256_prefix"]):
        raise ValueError(
            f"checkpoint {path!r} sha256={digest[:16]}… does not match the "
            f"pinned {weights_key} weights ({entry['sha256_prefix']}…, "
            f"canonical file {entry['file']}, {entry['url']}). Fetch it "
            "again per the recipe in cova_tpu_torch/utils/pretrained.py."
        )
    return digest


def backbone_state_dict(backbone: str, sd: Mapping[str, Any]):
    """The entries of a torchvision ResNet state_dict that ``backbone``
    keeps, under the backbone's own keys. Fails on a missing entry."""
    _weights_key(backbone)
    stage_sizes, n_stages, bottleneck = BACKBONES[backbone]
    out = collections.OrderedDict()

    def take(src: str, dst: str, bn: bool) -> None:
        names = (("weight", "bias", "running_mean", "running_var",
                  "num_batches_tracked") if bn else ("weight",))
        for name in names:
            key = f"{src}.{name}"
            if key not in sd:
                raise KeyError(f"{key!r} is missing from the checkpoint "
                               f"(backbone {backbone!r})")
            out[f"{dst}.{name}"] = sd[key]

    take("conv1", "0", False)
    take("bn1", "1", True)
    n_main = 3 if bottleneck else 2
    for stage in range(n_stages):
        for blk in range(stage_sizes[stage]):
            src, dst = f"layer{stage + 1}.{blk}", f"{4 + stage}.{blk}"
            for i in range(1, n_main + 1):
                take(f"{src}.conv{i}", f"{dst}.conv{i}", False)
                take(f"{src}.bn{i}", f"{dst}.bn{i}", True)
            if f"{src}.downsample.0.weight" in sd:
                take(f"{src}.downsample.0", f"{dst}.downsample.0", False)
                take(f"{src}.downsample.1", f"{dst}.downsample.1", True)
    return out


def load_verified_backbone(backbone: str, path: str, verify: bool = True):
    """Verify, load and rename a torchvision checkpoint for ``backbone``.

    ``verify=False`` skips the hash pin and the entry-count check (files
    with torchvision's key layout under another name); missing keys still
    fail loudly.
    """
    weights_key = _weights_key(backbone)
    if verify:
        verify_checkpoint(path, weights_key)
    sd = load_state_dict_file(path)
    if verify:
        expected = PRETRAINED_REGISTRY[weights_key]["n_state_entries"]
        if len(sd) != expected:
            raise ValueError(
                f"{path!r} has {len(sd)} state-dict entries; the "
                f"{weights_key} architecture has {expected}: the wrong file "
                f"for backbone {backbone!r}?"
            )
    return backbone_state_dict(backbone, sd)


def resolve_checkpoint(backbone: str, search_dirs=(".", "weights")) -> str:
    """The canonical weights file for ``backbone`` in ``search_dirs``;
    raises FileNotFoundError with the recipe if it is absent."""
    entry = PRETRAINED_REGISTRY[_weights_key(backbone)]
    for d in search_dirs:
        p = os.path.join(d, entry["file"])
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"{entry['file']} not found in {list(search_dirs)}. On a machine "
        f"with network access: wget {entry['url']} ; verify with sha256sum "
        f"(prefix {entry['sha256_prefix']}); copy it here and pass "
        f"--init_checkpoint {entry['file']}."
    )


def init_backbone_from_checkpoint(model, backbone: str, path: str) -> None:
    """``cli train --init_checkpoint``: the canonical file name is held to
    its sha256 pin, any other name loads with a note; then the backbone's
    tensors are replaced (strict) and the load is reported."""
    canonical = PRETRAINED_REGISTRY[_weights_key(backbone)]["file"]
    is_canonical = os.path.basename(path) == canonical
    if not is_canonical:
        print(
            f"Note: {path} is not the canonical {canonical}; loading "
            "without the sha256 pin (custom/fine-tuned checkpoint path)."
        )
    sd = load_verified_backbone(backbone, path, verify=is_canonical)
    model.convnet.load_state_dict(sd, strict=True)
    print(f"Initialized {backbone} backbone from {path}")
