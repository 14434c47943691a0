"""Host data layer (numpy and ctypes; no torch needed).

    from cova_tpu_torch.data import WebDataset, DataPipeline, make_pipelines
"""

from ..utils.lazy import make_lazy_getattr

_EXPORTS = {
    "WebDataset": ("dataset", "WebDataset"),
    "DataPipeline": ("pipeline", "DataPipeline"),
    "make_pipelines": ("pipeline", "make_pipelines"),
}

__all__ = list(_EXPORTS)
__getattr__ = make_lazy_getattr(_EXPORTS, __name__)
