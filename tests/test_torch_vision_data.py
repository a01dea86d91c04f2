"""The port's data side against the JAX package's: ``vision.transforms``
(every transform and functional under one ``random.seed``: equal
arrays), ``vision.datasets`` (the readers over files written under
``tmp_path``, ``synthetic_imagenet``), a ``DataLoader`` over a
``DatasetFolder`` (the JAX loader's batches: 2 fork workers through the
ImageNet eval transforms, the training transforms in the loader's
thread), ``text`` (the readers, ``viterbi_decode`` and
``ViterbiDecoder``: paths exactly equal, scores within ``1e-6 + 1e-5
|jax|``) and ``hub`` over a local ``hubconf.py``."""

import gzip
import os
import pickle
import random
import struct
import textwrap

import numpy as np
import pytest
from torch_gc_barrier import collect_around_module  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu import hub as jhub  # noqa: E402
from paddle_tpu import text as jtext  # noqa: E402
from paddle_tpu.vision import datasets as jds  # noqa: E402
from paddle_tpu.vision import transforms as jtf  # noqa: E402
from paddle_tpu_torch import hub as thub  # noqa: E402
from paddle_tpu_torch import text as ttext  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.vision import datasets as tds  # noqa: E402
from paddle_tpu_torch.vision import transforms as ttf  # noqa: E402

IMAGENET_MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
IMAGENET_STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]


@pytest.fixture(autouse=True)
def _on_cpu():
    tpt.set_device("cpu")
    yield
    tdevice.set_current(None)


def _img(seed=0, h=40, w=52, dtype=np.uint8):
    rs = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return rs.rand(h, w, 3).astype(dtype)


def _same(build, img, seeds=(0, 1, 2)):
    """``build(module)`` applied by both packages under the same seeds."""
    for s in seeds:
        random.seed(s)
        want = np.asarray(build(jtf)(img))
        random.seed(s)
        got = np.asarray(build(ttf)(img))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


TRANSFORMS = {
    "Resize": lambda m: m.Resize((17, 23)),
    "Resize-nearest": lambda m: m.Resize(20, "nearest"),
    "CenterCrop": lambda m: m.CenterCrop(24),
    "RandomCrop": lambda m: m.RandomCrop(32),
    "RandomCrop-pad": lambda m: m.RandomCrop((48, 60)),
    "RandomHorizontalFlip": lambda m: m.RandomHorizontalFlip(),
    "RandomResizedCrop": lambda m: m.RandomResizedCrop(24),
    "Normalize": lambda m: m.Compose([m.ToTensor(), m.Normalize(
        [0.5, 0.4, 0.3], [0.2, 0.3, 0.25])]),
    "Normalize-HWC": lambda m: m.Normalize(IMAGENET_MEAN, IMAGENET_STD,
                                           data_format="HWC"),
    "ToTensor": lambda m: m.ToTensor(),
    "Transpose": lambda m: m.Transpose(),
    "RandomVerticalFlip": lambda m: m.RandomVerticalFlip(),
    "Pad": lambda m: m.Pad((2, 3, 1, 4)),
    "Pad-reflect": lambda m: m.Pad(3, padding_mode="reflect"),
    "Grayscale": lambda m: m.Grayscale(3),
    "BrightnessTransform": lambda m: m.BrightnessTransform(0.4),
    "ContrastTransform": lambda m: m.ContrastTransform(0.4),
    "SaturationTransform": lambda m: m.SaturationTransform(0.4),
    "HueTransform": lambda m: m.HueTransform(0.2),
    "ColorJitter": lambda m: m.ColorJitter(0.3, 0.3, 0.3, 0.1),
    "RandomRotation": lambda m: m.RandomRotation(30),
    "RandomAffine": lambda m: m.RandomAffine(20, (0.1, 0.1), (0.8, 1.2),
                                             10),
    "RandomPerspective": lambda m: m.RandomPerspective(0.9),
    "RandomErasing": lambda m: m.Compose([m.ToTensor(),
                                          m.RandomErasing(0.9)]),
    "ImageNet-train": lambda m: m.Compose([
        m.RandomResizedCrop(32), m.RandomHorizontalFlip(), m.ToTensor(),
        m.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    _same(TRANSFORMS[name], _img())


def test_functionals_match_jax():
    img, f = _img(3), _img(4, dtype=np.float32)
    calls = [
        lambda m: m.to_tensor(img), lambda m: m.to_tensor(f, "HWC"),
        lambda m: m.hflip(img), lambda m: m.vflip(img),
        lambda m: m.normalize(f, [0.1, 0.2, 0.3], [0.5, 0.5, 0.5], "HWC"),
        lambda m: m.resize(img, (30, 31)),
        lambda m: m.crop(img, 3, 4, 10, 12),
        lambda m: m.center_crop(img, (20, 21)),
        lambda m: m.pad(img, (1, 2), fill=7),
        lambda m: m.pad(img, 2, padding_mode="edge"),
        lambda m: m.to_grayscale(img), lambda m: m.to_grayscale(img, 3),
        lambda m: m.adjust_brightness(img, 1.3),
        lambda m: m.adjust_contrast(img, 0.7),
        lambda m: m.adjust_saturation(img, 1.4),
        lambda m: m.adjust_hue(img, 0.1),
        lambda m: m.affine(img, 15, (2, -3), 1.1, (5.0, 2.0)),
        lambda m: m.rotate(img, 33), lambda m: m.rotate(img, 20,
                                                        expand=True),
        lambda m: m.perspective(img, [(0, 0), (51, 0), (51, 39), (0, 39)],
                                [(2, 3), (48, 1), (50, 36), (1, 38)]),
        lambda m: m.erase(img, 3, 4, 5, 6, 9),
    ]
    for i, call in enumerate(calls):
        np.testing.assert_array_equal(np.asarray(call(ttf)),
                                      np.asarray(call(jtf)), err_msg=str(i))


def _write_mnist(root, n=10, prefix="train"):
    os.makedirs(root, exist_ok=True)
    imgs = np.random.RandomState(0).randint(0, 255, (n, 28, 28)) \
        .astype(np.uint8)
    with gzip.open(os.path.join(root, f"{prefix}-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">i", 2051) + struct.pack(">iii", n, 28, 28)
                + imgs.tobytes())
    with open(os.path.join(root, f"{prefix}-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">i", 2049) + struct.pack(">i", n)
                + (np.arange(n) % 10).astype(np.uint8).tobytes())


def _same_items(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        x = x if isinstance(x, tuple) else (x,)
        y = y if isinstance(y, tuple) else (y,)
        for p, q in zip(x, y):
            np.testing.assert_array_equal(np.asarray(p), np.asarray(q))


def test_vision_datasets_match_jax(tmp_path):
    _write_mnist(str(tmp_path / "mnist"))
    for cls in ("MNIST", "FashionMNIST"):
        _same_items(getattr(tds, cls)(str(tmp_path / "mnist")),
                    getattr(jds, cls)(str(tmp_path / "mnist")))
    _same_items(tds.MNIST(str(tmp_path / "mnist"),
                          transform=ttf.ToTensor()),
                jds.MNIST(str(tmp_path / "mnist"), transform=jtf.ToTensor()))
    d = tmp_path / "cifar" / "cifar-10-batches-py"
    d.mkdir(parents=True)
    rs = np.random.RandomState(1)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 255, (4, 3072))
                         .astype(np.uint8), b"labels": [1, 2, 3, 4]}, f)
    for mode in ("train", "test"):
        _same_items(tds.Cifar10(str(tmp_path / "cifar"), mode),
                    jds.Cifar10(str(tmp_path / "cifar"), mode))
    d100 = tmp_path / "c100" / "cifar-100-python"
    d100.mkdir(parents=True)
    with open(d100 / "train", "wb") as f:
        pickle.dump({b"data": rs.randint(0, 255, (5, 3072))
                     .astype(np.uint8), b"fine_labels": [9, 8, 7, 6, 5]}, f)
    _same_items(tds.Cifar100(str(tmp_path / "c100"),
                             transform=ttf.ToTensor()),
                jds.Cifar100(str(tmp_path / "c100"),
                             transform=jtf.ToTensor()))
    for a, b in zip(tds.synthetic_imagenet(8, 32, 10, seed=3),
                    jds.synthetic_imagenet(8, 32, 10, seed=3)):
        np.testing.assert_array_equal(a, b)
    assert tds.ImageFolder is tds.DatasetFolder
    for make in (lambda m: m.MNIST(str(tmp_path / "none")),
                 lambda m: m.Cifar10(str(tmp_path / "none")),
                 lambda m: m.DatasetFolder(str(tmp_path / "none"))):
        with pytest.raises(FileNotFoundError) as want:
            make(jds)
        with pytest.raises(FileNotFoundError) as got:
            make(tds)
        assert str(got.value) == str(want.value)


def _folder(root, classes=3, per=6, size=40):
    rs = np.random.RandomState(5)
    for c in range(classes):
        os.makedirs(os.path.join(root, f"c{c}"))
        for i in range(per):
            np.save(os.path.join(root, f"c{c}", f"{i:02d}.npy"),
                    rs.randint(0, 256, (size, size, 3)).astype(np.uint8))


def _imagenet_train(m, size=32):
    return m.Compose([m.RandomResizedCrop(size), m.RandomHorizontalFlip(),
                      m.ToTensor(), m.Normalize(
                          [0.485, 0.456, 0.406], [0.229, 0.224, 0.225])])


def _imagenet_eval(m, size=32):
    return m.Compose([m.Resize(size + 4), m.CenterCrop(size), m.ToTensor(),
                      m.Normalize([0.485, 0.456, 0.406],
                                  [0.229, 0.224, 0.225])])


def _batches(loader, dev):
    return [[np.asarray(t.cpu() if dev else t) for t in b] for b in loader]


@pytest.mark.parametrize("workers", [0, 2])
def test_dataset_folder_loader_matches_jax(tmp_path, workers):
    """A ``DataLoader`` over a ``DatasetFolder`` of uint8 HWC ``.npy``
    images gives the JAX loader's batches: with 2 fork workers through
    the ImageNet eval transforms; in the loader's thread through the
    training transforms under one ``random.seed``. Neither package seeds
    Python's ``random`` in a fork worker, and which worker draws which
    batch is up to the pool, so random crops in workers are reproducible
    in neither."""
    root = str(tmp_path / "folder")
    _folder(root)
    make = _imagenet_eval if workers else _imagenet_train
    tset = tds.DatasetFolder(root, transform=make(ttf))
    jset = jds.DatasetFolder(root, transform=make(jtf))
    assert tset.classes == jset.classes and tset.samples == jset.samples
    random.seed(0)
    want = _batches(jpt.io.DataLoader(jset, batch_size=4, shuffle=True,
                                      num_workers=workers), False)
    random.seed(0)
    got = _batches(tpt.io.DataLoader(tset, batch_size=4, shuffle=True,
                                     num_workers=workers, device="cpu"),
                   True)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g[0].shape[1:] == (3, 32, 32) and g[0].dtype == np.float32
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1].reshape(-1), w[1].reshape(-1))


def _text_files(root):
    (root / "ptb.train.txt").write_text(
        "the cat sat on the mat\nthe dog <unk> on the rug\n" * 30)
    (root / "ptb.valid.txt").write_text("the cat sat on the bed\n")
    for split in ("train", "test"):
        for label in ("pos", "neg"):
            d = root / "aclImdb" / split / label
            os.makedirs(d)
            for i in range(3):
                (d / f"{i}.txt").write_text(
                    ("great movie, loved it! " if label == "pos" else
                     "terrible film hated it ") * (i + 2))
    d = root / "ml-1m"
    d.mkdir()
    (d / "users.dat").write_text("1::F::1::10::48067\n2::M::56::16::7\n")
    (d / "movies.dat").write_text("1::Toy Story::Animation\n2::Jumanji::"
                                  "Adventure\n")
    (d / "ratings.dat").write_text(
        "\n".join(f"{u}::{m}::{3 + (u + m) % 3}::97830{u}{m}"
                  for u in (1, 2) for m in (1, 2)) + "\n")
    np.savetxt(root / "housing.data", np.random.RandomState(0).rand(20, 14))
    (root / "conll05st.txt").write_text(
        "The - B-A0\ncat sit B-V\nsat - O\n\nA - O\ndog run B-V\n")
    for split in ("train", "test"):
        for lang, words in (("en", "a b c d"), ("de", "w x y z"),
                            ("fr", "p q r s")):
            (root / f"{split}.{lang}").write_text(
                "\n".join(" ".join(words.split()[i:] + words.split()[:i])
                          for i in range(4)) + "\n")


def test_text_readers_match_jax(tmp_path):
    _text_files(tmp_path)
    r = str(tmp_path)
    cases = [
        lambda m: m.UCIHousing(r), lambda m: m.UCIHousing(r, "test"),
        lambda m: m.Imikolov(r, "NGRAM", 3, "train", 10),
        lambda m: m.Imikolov(r, "SEQ", 3, "valid", 10),
        lambda m: m.Imdb(r, "train", 1), lambda m: m.Imdb(r, "test", 1),
        lambda m: m.Movielens(r, "train", 0.5, 0),
        lambda m: m.Movielens(r, "test", 0.5, 0),
        lambda m: m.Conll05st(r), lambda m: m.WMT14(r, "test"),
        lambda m: m.WMT16(r, "train", 5, 5),
    ]
    for make in cases:
        _same_items(make(ttext), make(jtext))
    assert ttext.Conll05st(r).get_dict() == jtext.Conll05st(r).get_dict()
    with pytest.raises(FileNotFoundError):
        ttext.Imdb(str(tmp_path / "none"))


@pytest.mark.parametrize("bos_eos,lengths", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_viterbi_decode_matches_jax(bos_eos, lengths):
    rs = np.random.RandomState(6)
    pot = rs.randn(5, 9, 6).astype(np.float32)
    trans = rs.randn(6, 6).astype(np.float32)
    lens = np.array([9, 1, 4, 7, 2]) if lengths else None
    ws, wp = jtext.viterbi_decode(jnp.asarray(pot), jnp.asarray(trans),
                                  None if lens is None
                                  else jnp.asarray(lens), bos_eos)
    gs, gp = ttext.viterbi_decode(torch.from_numpy(pot),
                                  torch.from_numpy(trans),
                                  None if lens is None
                                  else torch.from_numpy(lens), bos_eos)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-6)


def test_viterbi_ties_take_the_first_index():
    """Equal scores everywhere: every argmax takes tag 0, as
    ``jnp.argmax`` does."""
    pot = np.zeros((2, 6, 4), np.float32)
    trans = np.zeros((4, 4), np.float32)
    _, wp = jtext.viterbi_decode(jnp.asarray(pot), jnp.asarray(trans))
    dec = ttext.ViterbiDecoder(trans)
    _, gp = dec(torch.from_numpy(pot))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    assert not gp.any()


def test_hub_local_matches_jax(tmp_path):
    (tmp_path / "hubconf.py").write_text(textwrap.dedent('''
        def tiny_model(width=4):
            "builds a tiny model"
            return {"width": width}
        def other():
            "another entry point"
            return 1
        def _private():
            pass
    '''))
    r = str(tmp_path)
    assert thub.list(r) == jhub.list(r) == ["other", "tiny_model"]
    assert thub.help(r, "tiny_model") == jhub.help(r, "tiny_model")
    assert thub.load(r, "tiny_model", width=6) == {"width": 6}
    with pytest.raises(ValueError, match="no entrypoint"):
        thub.load(r, "nope")
    with pytest.raises(NotImplementedError, match="network"):
        thub.list(r, source="github")
    with pytest.raises(FileNotFoundError):
        thub.list(str(tmp_path / "none"))


def test_image_backend_and_load(tmp_path):
    from paddle_tpu_torch import vision
    assert vision.get_image_backend() == "pil"
    with pytest.raises(ValueError):
        vision.set_image_backend("nope")
    pil = pytest.importorskip("PIL.Image")
    path = str(tmp_path / "x.png")
    img = _img(7, 8, 9)
    pil.fromarray(img).save(path)
    np.testing.assert_array_equal(np.asarray(vision.image_load(path)), img)
