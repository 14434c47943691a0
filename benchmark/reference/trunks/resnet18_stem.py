"""torchvision ResNet-18 conv1..layer1, the CoVA paper's trunk: the stem,
then two BasicBlocks of 64 channels, stride 4 (``_resnet_stem``)."""

from . import _resnet_stem as _r

KIND, BLOCKS = "basic", 2
CHANNELS, STRIDE = _r.channels(KIND), _r.STRIDE


def param_shapes(cfg):
    return _r.param_shapes(KIND, BLOCKS)


def forward(m, x):
    return _r.forward(m, x, KIND, BLOCKS)


def flops(cfg):
    return _r.flops(cfg["img_height"], KIND, BLOCKS)


def bn_act_bytes(sh):
    return _r.bn_act_bytes(sh, KIND, BLOCKS)
