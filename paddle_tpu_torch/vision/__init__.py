"""paddle_tpu_torch.vision (the port's counterpart of
``paddle_tpu/vision``; ref: python/paddle/vision/ — models, datasets,
transforms, ops). Models live in ``paddle_tpu_torch.models``; this
package holds the data side."""

from . import datasets  # noqa
from . import transforms  # noqa
from . import ops  # noqa
from ..models import (LeNet, MobileNetV1, MobileNetV2, ResNet,  # noqa
                      VGG, mobilenet_v1, mobilenet_v2, resnet18,
                      resnet34, resnet50, resnet101, resnet152,
                      vgg11, vgg13, vgg16, vgg19)


# image IO backend (ref: vision/image.py get/set_image_backend,
# image_load — PIL is the default backend there too; the "cv2"
# backend is accepted iff cv2 is importable)
_image_backend = "pil"


def get_image_backend() -> str:
    return _image_backend


def set_image_backend(backend: str) -> None:
    global _image_backend
    if backend not in ("pil", "cv2"):
        raise ValueError(f"unsupported backend {backend!r}")
    if backend == "cv2":
        try:
            import cv2  # noqa: F401
        except ImportError as e:
            raise ValueError("cv2 backend requested but OpenCV is not "
                             "installed") from e
    _image_backend = backend


def image_load(path: str, backend=None):
    """ref: vision/image.py image_load — returns a PIL Image (pil
    backend) or an ndarray (cv2 backend)."""
    backend = backend or _image_backend
    if backend == "cv2":
        import cv2
        return cv2.imread(path)
    from PIL import Image
    return Image.open(path)
