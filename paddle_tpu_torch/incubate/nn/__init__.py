"""``incubate.nn`` in the port: the fused-layer names alias the
standard layers, whose attention takes the flash kernels B1-B3 where
the JAX package's rules allow, and the fused functionals compose the
same ops (``incubate.nn.functional``)."""

from ...nn.layers.transformer import (  # noqa: F401
    MultiHeadAttention as FusedMultiHeadAttention,
    TransformerEncoderLayer as FusedTransformerEncoderLayer)
from . import functional  # noqa: F401
