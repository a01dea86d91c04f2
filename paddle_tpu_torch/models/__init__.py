"""Model zoo of the port, named as in ``paddle_tpu/models/__init__.py``:
GPT, BERT / ERNIE, the vision families, the CTR models and the
HuggingFace converters."""

from .bert import (BertConfig, BertForPretraining,  # noqa: F401
                   BertForSequenceClassification,
                   BertFusedPretrainingCriterion, BertModel,
                   BertPretrainingCriterion, bert_config, ernie_config)
from .gpt import (PRESETS, GPTConfig, GPTForCausalLM,  # noqa: F401
                  GPTFusedPretrainingCriterion, GPTGreedyDecoder, GPTModel,
                  GPTPretrainingCriterion, gpt_config, llama_config)
from .lenet import LeNet  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2,  # noqa: F401
                        MobileNetV3Large, MobileNetV3Small,
                        mobilenet_v1, mobilenet_v2,
                        mobilenet_v3_large, mobilenet_v3_small)
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d,
                     resnext152_64x4d, wide_resnet50_2, wide_resnet101_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .vision_extra import (AlexNet, DenseNet, GoogLeNet,  # noqa: F401
                           InceptionV3, ShuffleNetV2, SqueezeNet,
                           alexnet,
                           densenet121, densenet161, densenet169,
                           densenet201, densenet264,
                           googlenet, inception_v3,
                           shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                           shufflenet_v2_x0_5, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0,
                           shufflenet_v2_swish,
                           squeezenet1_0, squeezenet1_1)
from .widedeep import DeepFM, WideDeep, synthetic_criteo  # noqa: F401
from .convert import (bert_from_huggingface,  # noqa: F401
                      gpt2_from_huggingface,
                      llama_from_huggingface)
