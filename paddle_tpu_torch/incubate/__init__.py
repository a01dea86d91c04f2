"""The port's ``incubate`` namespace: the functional autograd names,
the MoE layers, the sparse embeddings and the fused-layer names under
the reference's paths, and ``incubate.nn``. The rest of the JAX
package's ``incubate`` (``asp``, ``autotune``, ``data_generator``) is
not ported yet (ROADMAP A7)."""

from ..autograd import Hessian, Jacobian, jvp, vjp  # noqa: F401
from ..nn.layers.moe import (GShardGate, MoELayer, NaiveGate,  # noqa: F401
                             SwitchGate)
from ..nn.layers.sparse_embedding import (  # noqa: F401
    MultiSlotEmbedding, SparseEmbedding)
from ..nn.layers.transformer import (  # noqa: F401
    MultiHeadAttention as FusedMultiHeadAttention,
    TransformerEncoderLayer as FusedTransformerEncoderLayer)
from . import nn  # noqa: F401
