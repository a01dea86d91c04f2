"""High-level API of the port: ``Model`` (train/eval/predict batches)."""

from .model import Model  # noqa: F401
