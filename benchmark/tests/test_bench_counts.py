"""The benchmark's FLOP and byte counts against hand counts."""

import numpy as np

from benchmark import counts
from benchmark.reference import cova as reference

R18 = dict(backbone="resnet18_stem", img_height=1280, roi=3, hidden_dim=384,
           bbox_hidden_dim=32, context_size=12, n_classes=4,
           compute_dtype="bfloat16")
R50 = dict(R18, backbone="resnet50_stem")


def test_trunk_flops_by_hand():
    conv1 = 2 * 640 * 640 * 64 * 3 * 49
    basic = 2 * 320 * 320 * 64 * 64 * 9
    assert counts.trunk_flops(R18) == conv1 + 4 * basic
    px = 320 * 320
    b1 = 2 * px * (64 * 64 + 64 * 64 * 9 + 64 * 256 + 64 * 256)
    b23 = 2 * px * (256 * 64 + 64 * 64 * 9 + 64 * 256)
    assert counts.trunk_flops(R50) == conv1 + b1 + 2 * b23
    # The issue's round numbers: 38.4 and 51.3 GFLOP a page.
    assert abs(counts.trunk_flops(R18) / 1e9 - 37.9) < 0.1
    assert abs(counts.trunk_flops(R50) / 1e9 - 51.3) < 0.1


def test_box_flops_by_hand():
    nf, hd, nt = 64 * 9 + 32, 384, 64 * 9 + 32 + 384
    want = (2 * 5 * 32 + 2 * 2 * nf * hd + 2 * 2 * hd + 2 * 24 * hd
            + 2 * nt * nt + 2 * nt * 4)
    assert counts.box_flops(R18) == want
    assert nt == reference.n_total(R18)


def test_step_flops_by_hand():
    assert counts.step_flops(R18, [10, 20]) == (
        2 * counts.trunk_flops(R18) + 30 * counts.box_flops(R18))


def test_covered_pixels_union_by_hand():
    # Map 8 x 8 at scale 1: a box [0, 0, 3, 3] covers rows and columns
    # 0..3 (inclusive end); a second box [2, 2, 5, 5] overlaps it.
    one = np.array([[0, 0, 3, 3]], np.float32)
    assert counts.covered_pixels(one, 3, 8, 8, 1.0) == 16
    two = np.array([[0, 0, 3, 3], [2, 2, 5, 5]], np.float32)
    assert counts.covered_pixels(two, 3, 8, 8, 1.0) == 16 + 16 - 4
    # A box past the map's edge is clipped to it.
    edge = np.array([[6, 6, 20, 20]], np.float32)
    assert counts.covered_pixels(edge, 3, 8, 8, 1.0) == 4


def test_kernel_bytes_by_hand():
    sh = {"b": 2, "p": 8, "h": 4, "w": 4, "c": 16, "bins": 9,
          "covered": [10, 6],
          "valid": [5, 3], "itemsize": 2}
    fm = 16 * 16 * 2
    boxes = 2 * 8 * 17
    pooled = 2 * 8 * 9 * 16 * 2
    assert counts.roi_pool_bytes(sh) == fm + boxes + pooled
    px = 2 * 4 * 4
    ys, out, aff = px * 256 * 2, px * 64 * 2, 2 * 64 * 4
    assert counts.bn_pool_bytes(sh) == ys + aff + out
    assert counts.bound_seconds(3.35e12) == 1.0
