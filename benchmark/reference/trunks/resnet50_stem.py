"""torchvision ResNet-50 conv1..layer1: the stem, then three
Bottlenecks (64, 64, 256), 256 channels at stride 4 (``_resnet_stem``)."""

from . import _resnet_stem as _r

KIND, BLOCKS = "bottleneck", 3
CHANNELS, STRIDE = _r.channels(KIND), _r.STRIDE


def param_shapes(cfg):
    return _r.param_shapes(KIND, BLOCKS)


def forward(m, x):
    return _r.forward(m, x, KIND, BLOCKS)


def flops(cfg):
    return _r.flops(cfg["img_height"], KIND, BLOCKS)


def bn_act_bytes(sh):
    return _r.bn_act_bytes(sh, KIND, BLOCKS)
