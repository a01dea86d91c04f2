"""Neural-net layers of the port (the subset GPT serving uses)."""

from . import functional, initializer  # noqa: F401
from .layer import Layer, LayerList  # noqa: F401
from .layers import Dropout, Embedding, LayerNorm, Linear, RMSNorm  # noqa: F401
