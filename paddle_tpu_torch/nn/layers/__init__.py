from .common import Dropout, Dropout2D, Embedding, Linear  # noqa: F401
from .norm import LayerNorm, RMSNorm  # noqa: F401
