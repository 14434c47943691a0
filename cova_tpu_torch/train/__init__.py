"""Training, evaluation, serving and attention extraction.

    from cova_tpu_torch.train import fit, evaluate, predict_pages
    from cova_tpu_torch.train import extract_attention
"""

from ..utils.lazy import make_lazy_getattr

_EXPORTS = {
    "fit": ("trainer", "fit"),
    "evaluate": ("reporting", "evaluate"),
    "predict_pages": ("predict", "predict_pages"),
    "extract_attention": ("extract", "extract_attention"),
}

__all__ = list(_EXPORTS)
__getattr__ = make_lazy_getattr(_EXPORTS, __name__)
