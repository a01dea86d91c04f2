"""The port's ``nn``: layers and functional ops, named as in
``paddle_tpu/nn/__init__.py`` and in its order."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import clip  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import (Layer, LayerDict, LayerList, Parameter,  # noqa: F401
                    Sequential, functional_call, split_state)
from .layers.common import (ELU, GELU, SELU, Dropout, Dropout2D,  # noqa
                            Embedding, Flatten, Hardsigmoid, Hardswish,
                            Identity, LeakyReLU, Linear, LogSoftmax, Mish,
                            Pad2D, PReLU, ReLU, ReLU6, Sigmoid, SiLU,
                            Softmax, Softplus, Softsign, Swish, Tanh,
                            Upsample)
from .layers.conv import (Conv1D, Conv2D, Conv2DTranspose, Conv3D)  # noqa
from .layers.loss import (BCELoss, BCEWithLogitsLoss,  # noqa: F401
                          CrossEntropyLoss, KLDivLoss, L1Loss, MSELoss,
                          NLLLoss, SmoothL1Loss)
from .layers.norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa
                          BatchNorm3D, GroupNorm, InstanceNorm2D, LayerNorm,
                          RMSNorm, SyncBatchNorm)
from .layers.extra import (CELU, GLU, RReLU, AlphaDropout,  # noqa
                           Bilinear, CosineSimilarity, Fold,
                           Hardshrink, Hardtanh, LocalResponseNorm,
                           Maxout, Pad1D, Pad2D, Pad3D,
                           PairwiseDistance, PixelShuffle,
                           PixelUnshuffle, Softshrink, Tanhshrink,
                           ThresholdedReLU, Unfold, Upsample,
                           UpsamplingBilinear2D, UpsamplingNearest2D,
                           ZeroPad2D)
from .layers.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool3D,  # noqa
                             AdaptiveMaxPool1D, AvgPool3D, MaxPool3D)
from .layers.pooling import (AdaptiveAvgPool2D, AdaptiveMaxPool2D,  # noqa
                             AvgPool1D, AvgPool2D, MaxPool1D, MaxPool2D)
from .layers.moe import (GShardGate, MoELayer, NaiveGate,  # noqa
                         SwitchGate, collect_aux_losses)
from .layers.sparse_embedding import (MultiSlotEmbedding,  # noqa
                                      SparseEmbedding)
from .layers.host_embedding import HostOffloadedEmbedding  # noqa
from .layers.sharded_embedding import ShardedHostEmbedding  # noqa
from .layers.rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,  # noqa
                         SimpleRNN, SimpleRNNCell)
from .layers.transformer import (MultiHeadAttention, Transformer,  # noqa
                                 TransformerDecoder, TransformerDecoderLayer,
                                 TransformerEncoder, TransformerEncoderLayer)

from . import utils  # noqa: F401
from .layers.fill_r4 import (  # noqa: E402,F401
    AdaptiveMaxPool3D, BeamSearchDecoder, ChannelShuffle, CTCLoss,
    Conv1DTranspose, Conv3DTranspose, CosineEmbeddingLoss, Dropout3D,
    HSigmoidLoss, HingeEmbeddingLoss, InstanceNorm1D, InstanceNorm3D,
    LogSigmoid, MarginRankingLoss, MaxUnPool1D, MaxUnPool2D,
    MaxUnPool3D, MultiLabelSoftMarginLoss, ParameterList, RNNCellBase,
    Silu, Softmax2D, SpectralNorm, TripletMarginLoss,
    TripletMarginWithDistanceLoss, dynamic_decode)
