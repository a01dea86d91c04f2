"""paddle_tpu_torch.sparse.nn (ref: python/paddle/incubate/sparse/nn)."""

from . import functional  # noqa: F401
