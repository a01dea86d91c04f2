"""Vision datasets (the port's copy of ``paddle_tpu/vision/datasets.py``;
ref: python/paddle/vision/datasets/ — MNIST, Cifar, FashionMNIST,
ImageFolder / DatasetFolder).

Datasets read the standard on-disk formats from a local path (IDX for
MNIST, the python-pickle batches for CIFAR, directory trees for
ImageFolder) and raise a clear error when files are absent: there is no
downloader. Synthetic generators are provided for tests and
benchmarks."""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..io import Dataset

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".npy")


def _missing(path, what, fmt):
    raise FileNotFoundError(
        f"{what} not found at {path!r}. This environment has no network "
        f"access; place the standard {fmt} files there.")


class MNIST(Dataset):
    """IDX-format MNIST reader (ref: vision/datasets/mnist.py).

    ``root`` must contain train-images-idx3-ubyte(.gz) etc."""

    _FILES = {
        "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, root: str, mode: str = "train",
                 transform: Optional[Callable] = None,
                 backend: str = "cv2"):
        img_name, lbl_name = self._FILES[mode]
        self.images = self._read_idx(os.path.join(root, img_name), 3)
        self.labels = self._read_idx(os.path.join(root, lbl_name), 1)
        self.transform = transform

    @staticmethod
    def _read_idx(path, ndim):
        opener = open
        if not os.path.exists(path):
            if os.path.exists(path + ".gz"):
                path, opener = path + ".gz", gzip.open
            else:
                _missing(path, "MNIST file", "IDX (optionally .gz)")
        with opener(path, "rb") as f:
            magic = struct.unpack(">i", f.read(4))[0]
            dims = [struct.unpack(">i", f.read(4))[0]
                    for _ in range(magic % 256)]
            data = np.frombuffer(f.read(), dtype=np.uint8)
            return data.reshape(dims)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        else:
            img = img[None].astype(np.float32) / 255.0
        return img, np.int64(self.labels[idx])


class FashionMNIST(MNIST):
    """Same IDX format, different files (ref: fashion_mnist.py)."""


class Cifar10(Dataset):
    """CIFAR-10 python-pickle batches (ref: vision/datasets/cifar.py)."""

    def __init__(self, root: str, mode: str = "train",
                 transform: Optional[Callable] = None):
        batch_dir = root
        sub = os.path.join(root, "cifar-10-batches-py")
        if os.path.isdir(sub):
            batch_dir = sub
        names = [f"data_batch_{i}" for i in range(1, 6)] \
            if mode == "train" else ["test_batch"]
        xs, ys = [], []
        for n in names:
            p = os.path.join(batch_dir, n)
            if not os.path.exists(p):
                _missing(p, "CIFAR-10 batch", "python pickle")
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        self.images = np.concatenate(xs).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(ys, np.int64)
        self.transform = transform

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img.transpose(1, 2, 0))
        else:
            img = img.astype(np.float32) / 255.0
        return img, self.labels[idx]


class Cifar100(Cifar10):
    """CIFAR-100 (ref: vision/datasets/cifar.py Cifar100 — same pickle
    format, 'train'/'test' files, b'fine_labels' key)."""

    def __init__(self, root: str, mode: str = "train",
                 transform: Optional[Callable] = None):
        batch_dir = root
        sub = os.path.join(root, "cifar-100-python")
        if os.path.isdir(sub):
            batch_dir = sub
        name = "train" if mode == "train" else "test"
        p = os.path.join(batch_dir, name)
        if not os.path.exists(p):
            _missing(p, "CIFAR-100 batch", "python pickle")
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        self.images = d[b"data"].reshape(-1, 3, 32, 32)
        self.labels = np.asarray(d[b"fine_labels"], np.int64)
        self.transform = transform


class DatasetFolder(Dataset):
    """class-per-subdirectory tree (ref: vision/datasets/folder.py)."""

    def __init__(self, root: str, loader: Optional[Callable] = None,
                 extensions: Sequence[str] = IMAGE_EXTS,
                 transform: Optional[Callable] = None):
        if not os.path.isdir(root):
            _missing(root, "dataset root", "class-per-subdir tree")
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(tuple(extensions)):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))
        self.loader = loader or self._default_loader
        self.transform = transform

    @staticmethod
    def _default_loader(path: str):
        if path.endswith(".npy"):
            return np.load(path)
        try:
            from PIL import Image
            return np.asarray(Image.open(path).convert("RGB"))
        except ImportError as e:
            raise ImportError(
                "loading encoded images needs Pillow; store .npy arrays "
                "or pass a custom loader") from e

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform:
            img = self.transform(img)
        return img, np.int64(target)


ImageFolder = DatasetFolder


def synthetic_imagenet(n: int = 256, image_size: int = 224,
                       num_classes: int = 1000, seed: int = 0):
    """Synthetic NCHW ImageNet-shaped data for benchmarks (the
    reference's CI uses fake_reader equivalents for the same purpose)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 3, image_size, image_size).astype(np.float32)
    y = rs.randint(0, num_classes, n).astype(np.int64)
    return x, y
