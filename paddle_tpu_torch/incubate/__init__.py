"""The port's ``incubate`` namespace: the functional autograd names,
the MoE layers, the sparse embeddings and the fused-layer names under
the reference's paths, ``incubate.nn``, n:m structured sparsity
(``asp``), the tuning facade (``autotune``, read by
``DataLoader(num_workers="auto")``) and the PS data authoring protocol
(``data_generator``)."""

from ..autograd import Hessian, Jacobian, jvp, vjp  # noqa: F401
from ..nn.layers.moe import (GShardGate, MoELayer, NaiveGate,  # noqa: F401
                             SwitchGate)
from ..nn.layers.sparse_embedding import (  # noqa: F401
    MultiSlotEmbedding, SparseEmbedding)
from ..nn.layers.transformer import (  # noqa: F401
    MultiHeadAttention as FusedMultiHeadAttention,
    TransformerEncoderLayer as FusedTransformerEncoderLayer)
from . import asp  # noqa: F401
from . import nn  # noqa: F401
from . import autotune  # noqa: F401
from . import data_generator  # noqa: F401
