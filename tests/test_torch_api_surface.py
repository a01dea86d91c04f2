"""Every public name of the JAX package's tensor and math namespaces is in
the port: ``tensor``, ``linalg``, ``fft``, ``signal``, ``sparse``,
``sparse.nn.functional``, ``distribution`` (and its ``transform``),
``autograd``, ``regularizer``, ``device``, the models and data side
(``models`` and its modules, ``vision`` with ``ops``, ``transforms`` and
``datasets``, ``text``, ``hub``), the tooling (``profiler``,
``cost_model``, ``jit``, ``static`` and its ``program`` and ``nn``,
``quant``, ``incubate`` and its ``autotune``, ``asp`` and
``data_generator``, ``testing``, ``sysconfig``, ``version``), the
predictor and the native feed (``inference``, ``io.native_feed``), and the
top-level names these modules give ``paddle_tpu``. A public name is one
without a leading underscore that is not a module, a ``typing`` object
or a ``__future__`` feature. A name the port leaves out sits in ``DECLINED`` with its reason
(more than 30 characters); the list is empty."""

import __future__
import importlib
import inspect

import pytest
from torch_gc_barrier import collect_around_module  # noqa: F401

pytest.importorskip("torch")

import paddle_tpu as J  # noqa: E402
import paddle_tpu_torch as T  # noqa: E402


NAMESPACES = ["tensor", "tensor.extra", "linalg", "fft", "signal",
              "sparse", "sparse.nn", "sparse.nn.functional",
              "distribution", "distribution.transform", "autograd",
              "regularizer", "device", "device.fill_r4", "framework",
              "compat_fill", "core.dtype", "models", "models.bert",
              "models.resnet", "models.vgg", "models.mobilenet",
              "models.lenet", "models.vision_extra", "models.convert",
              "vision", "vision.ops", "vision.ops_fill",
              "vision.transforms", "vision.transforms_fill",
              "vision.datasets", "text", "hub",
              # the tooling (ROADMAP A7.4)
              "profiler", "cost_model", "jit", "static", "static.program",
              "static.nn", "quant", "incubate", "incubate.autotune",
              "incubate.asp", "incubate.data_generator", "testing",
              "sysconfig", "version",
              # the predictor and native/ (ROADMAP A7.5)
              "inference", "io.native_feed"]

# (namespace, name) -> why the port leaves it out
DECLINED: dict = {}

# the names paddle_tpu/__init__.py gives the top level from these
# modules and beside them
TOP_LEVEL_EXTRA = ["get_flags", "set_flags", "seed", "compile", "iinfo",
                   "finfo", "set_device", "device_count",
                   "is_compiled_with_tpu", "is_compiled_with_cuda",
                   "tensor", "linalg", "fft", "signal", "sparse",
                   "distribution", "autograd", "regularizer", "device",
                   "models", "vision", "text", "hub",
                   "DataParallel", "distributed", "observability",
                   "parallel", "reliability", "__version__", "jit",
                   "profiler", "quant", "cost_model", "sysconfig",
                   "version", "static", "incubate"]


def _public(mod):
    out = set()
    for name, value in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(value):
            continue
        if isinstance(value, __future__._Feature):
            continue
        if getattr(value, "__module__", None) == "typing":
            continue
        out.add(name)
    return out


def _missing(ns):
    jmod = importlib.import_module(f"paddle_tpu.{ns}")
    tmod = importlib.import_module(f"paddle_tpu_torch.{ns}")
    return sorted(n for n in _public(jmod)
                  if not hasattr(tmod, n) and (ns, n) not in DECLINED)


@pytest.mark.parametrize("ns", NAMESPACES)
def test_namespace_has_every_public_name(ns):
    assert _missing(ns) == []


def test_top_level_names():
    """The names whose top-level value IS these modules' (``paddle_tpu.
    jit`` is the jit module, ROADMAP A7.4, not ``framework.jit``)."""
    names = set(TOP_LEVEL_EXTRA)
    for ns in ("tensor", "framework", "compat_fill", "core.dtype"):
        src = importlib.import_module(f"paddle_tpu.{ns}")
        names |= {n for n in _public(src)
                  if getattr(J, n, None) is getattr(src, n)}
    missing = sorted(n for n in names
                     if not hasattr(T, n) and ("", n) not in DECLINED)
    assert missing == []


def test_incubate_autograd_names():
    for name in ("Hessian", "Jacobian", "jvp", "vjp"):
        assert getattr(T.incubate, name) is getattr(T.autograd, name)


def test_every_declined_name_has_a_reason():
    for key, why in DECLINED.items():
        assert isinstance(why, str) and len(why) > 30, key
