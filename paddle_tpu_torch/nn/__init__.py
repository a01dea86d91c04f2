"""Neural-net layers of the port (the subset GPT serving and training
use)."""

from . import clip, functional, initializer, utils  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import Layer, LayerList, Sequential  # noqa: F401
from .layers import (Dropout, Dropout2D, Embedding, LayerNorm,  # noqa: F401
                     Linear, RMSNorm)
