"""``--init_checkpoint``: the port's sha-pinned backbone loading against the
JAX package's, with torchvision-layout state_dicts built locally from a
seed (no pretrained file is in the repository)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cova_tpu.models.resnet import make_backbone as jax_make_backbone
from cova_tpu.utils import pretrained as jax_pretrained
from cova_tpu_torch import cli
from cova_tpu_torch.models.resnet import make_backbone
from cova_tpu_torch.utils import pretrained
from cova_tpu_torch.config import BACKBONES

SMALL = ["--synthetic", "10", "--img_height", "64", "-cs", "3", "-hd", "32",
         "-bbhd", "8", "--compute_dtype", "float32", "-nw", "2", "--device",
         "cpu"]


def _torchvision_state_dict(arch: str, seed: int = 0):
    """A full torchvision-layout ResNet state_dict (every stage and the
    fc layer) with seeded random tensors."""
    stage_sizes, _, bottleneck = BACKBONES[
        {"resnet18": "resnet18", "resnet34": "resnet34_stem",
         "resnet50": "resnet50"}[arch]]
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(key, o, i, k):
        sd[f"{key}.weight"] = torch.randn(o, i, k, k, generator=g) * (
            2.0 / (i * k * k)) ** 0.5

    def bn(key, c):
        sd[f"{key}.weight"] = torch.rand(c, generator=g) + 0.5
        sd[f"{key}.bias"] = torch.randn(c, generator=g) * 0.1
        sd[f"{key}.running_mean"] = torch.randn(c, generator=g) * 0.2
        sd[f"{key}.running_var"] = torch.rand(c, generator=g) + 0.5
        sd[f"{key}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    exp = 4 if bottleneck else 1
    cin = 64
    for stage in range(4):
        mid = 64 * 2**stage
        for blk in range(stage_sizes[stage]):
            p = f"layer{stage + 1}.{blk}"
            stride = 2 if stage > 0 and blk == 0 else 1
            if bottleneck:
                conv(f"{p}.conv1", mid, cin, 1); bn(f"{p}.bn1", mid)
                conv(f"{p}.conv2", mid, mid, 3); bn(f"{p}.bn2", mid)
                conv(f"{p}.conv3", mid * 4, mid, 1); bn(f"{p}.bn3", mid * 4)
            else:
                conv(f"{p}.conv1", mid, cin, 3); bn(f"{p}.bn1", mid)
                conv(f"{p}.conv2", mid, mid, 3); bn(f"{p}.bn2", mid)
            if stride != 1 or cin != mid * exp:
                conv(f"{p}.downsample.0", mid * exp, cin, 1)
                bn(f"{p}.downsample.1", mid * exp)
            cin = mid * exp
    sd["fc.weight"] = torch.randn(1000, cin, generator=g) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def test_registry_is_the_jax_packages():
    assert pretrained.PRETRAINED_REGISTRY == jax_pretrained.PRETRAINED_REGISTRY
    assert pretrained.BACKBONE_TO_WEIGHTS == jax_pretrained.BACKBONE_TO_WEIGHTS
    for arch, entry in pretrained.PRETRAINED_REGISTRY.items():
        assert len(_torchvision_state_dict(arch)) == entry["n_state_entries"]


@pytest.mark.parametrize("backbone", ["resnet18_stem", "resnet18",
                                      "resnet34_stem", "resnet50_stem"])
def test_loaded_backbone_equals_the_file_and_the_jax_load(backbone, tmp_path):
    """A file under a non-canonical name loads without the pin: every
    tensor of the port's backbone equals the file's, and the same file
    through ``cova_tpu.utils.pretrained.load_verified_backbone`` gives the
    same eval-mode features (f32, 1e-4; 1e-3 of the largest for the full
    backbone's 2x2 map)."""
    arch = pretrained.BACKBONE_TO_WEIGHTS[backbone]
    sd = _torchvision_state_dict(arch, seed=3)
    path = str(tmp_path / "finetuned.pth")
    torch.save(sd, path)
    assert pretrained.sha256_of(path) == jax_pretrained.sha256_of(path)
    got = pretrained.load_verified_backbone(backbone, path, verify=False)
    bb = make_backbone(backbone).eval()
    bb.load_state_dict(got, strict=True)
    n_stages = BACKBONES[backbone][1]
    for k, v in bb.state_dict().items():
        head, rest = k.split(".", 1)
        src = {"0": "conv1", "1": "bn1"}.get(head) or f"layer{int(head) - 3}"
        assert torch.equal(v, sd[f"{src}.{rest}"]), k
    assert not any(k.startswith(f"{4 + n_stages}.") for k in got)

    params, stats = jax_pretrained.load_verified_backbone(
        backbone, path, verify=False)
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_make_backbone(backbone).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False))
    with torch.no_grad():
        out = bb(torch.from_numpy(x)).numpy()
    tol = 1e-3 * np.abs(want).max() if backbone == "resnet18" else 1e-4
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=tol)


def test_canonical_name_is_held_to_its_pin(tmp_path):
    """A file named as the canonical checkpoint whose sha256 does not start
    with the pinned prefix is refused, by both packages."""
    path = str(tmp_path / "resnet18-f37072fd.pth")
    torch.save(_torchvision_state_dict("resnet18"), path)
    with pytest.raises(ValueError, match="does not match the pinned"):
        pretrained.load_verified_backbone("resnet18_stem", path)
    with pytest.raises(ValueError, match="does not match the pinned"):
        jax_pretrained.load_verified_backbone("resnet18_stem", path)
    with pytest.raises(ValueError):
        pretrained.verify_checkpoint(path, "resnet18")
    assert pretrained.resolve_checkpoint("resnet18", [str(tmp_path)]) == path
    with pytest.raises(FileNotFoundError, match="resnet50-0676ba61.pth"):
        pretrained.resolve_checkpoint("resnet50", [str(tmp_path)])


def test_missing_entries_fail_loudly(tmp_path):
    sd = _torchvision_state_dict("resnet18")
    del sd["layer1.1.bn2.running_var"]
    path = str(tmp_path / "broken.pth")
    torch.save(sd, path)
    with pytest.raises(KeyError, match="layer1.1.bn2.running_var"):
        pretrained.load_verified_backbone("resnet18_stem", path, verify=False)


def test_cli_train_init_checkpoint(tmp_path, capsys):
    """``cli train --init_checkpoint``: the note for a non-canonical name,
    the "Initialized" line, a refused canonical name with a wrong hash, a
    refused missing file; the run trains from the file's backbone."""
    good = str(tmp_path / "mine.pth")
    torch.save(_torchvision_state_dict("resnet18", seed=5), good)
    out = str(tmp_path / "out")
    assert cli.main(["train", *SMALL, "-e", "1", "--output_dir", out,
                     "--init_checkpoint", good]) == 0
    text = capsys.readouterr().out
    assert f"Note: {good} is not the canonical resnet18-f37072fd.pth" in text
    assert f"Initialized resnet18_stem backbone from {good}" in text
    assert "Epoch:  1" in text
    bad = str(tmp_path / "resnet18-f37072fd.pth")
    torch.save(_torchvision_state_dict("resnet18", seed=6), bad)
    with pytest.raises(ValueError, match="does not match the pinned"):
        cli.main(["train", *SMALL, "-e", "1", "--output_dir", out,
                  "--init_checkpoint", bad])
    with pytest.raises(SystemExit, match="no such file"):
        cli.main(["train", *SMALL, "-e", "1", "--output_dir", out,
                  "--init_checkpoint", str(tmp_path / "absent.pth")])


def test_init_checkpoint_replaces_the_backbone(tmp_path):
    from cova_tpu_torch.config import Config
    from cova_tpu_torch.models.cova import build_model

    sd = _torchvision_state_dict("resnet50", seed=8)
    path = str(tmp_path / "r50.pth")
    torch.save(sd, path)
    cfg = Config(backbone="resnet50_stem", img_height=64, hidden_dim=32,
                 bbox_hidden_dim=8, compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    head = model.decoder[1].weight.clone()
    pretrained.init_backbone_from_checkpoint(model, cfg.backbone, path)
    assert torch.equal(model.convnet.get_submodule("4.2.conv3").weight,
                       sd["layer1.2.conv3.weight"])
    assert torch.equal(model.convnet.get_submodule("4.0.downsample.1")
                       .running_var, sd["layer1.0.downsample.1.running_var"])
    assert torch.equal(model.decoder[1].weight, head)  # the head is kept
    assert os.path.isfile(path)
