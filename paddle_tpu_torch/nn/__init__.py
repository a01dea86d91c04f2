"""Neural-net layers of the port (the subset GPT serving and training
use)."""

from . import clip, functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import Layer, LayerList  # noqa: F401
from .layers import Dropout, Embedding, LayerNorm, Linear, RMSNorm  # noqa: F401
