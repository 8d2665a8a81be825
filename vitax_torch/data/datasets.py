"""Raw dataset readers (host side, no torch/torchvision dependency).

Capability parity with the reference's loaders (src/data_loaders.py,
res-vit/data_loaders.py):

  * CIFAR-10 / CIFAR-100 — read the standard python pickle batches directly
    (the format torchvision's `CIFAR10(download=True)` unpacks). Like the
    reference (src/data_loaders.py:50,82 passes `download=True`), a missing
    archive is fetched from the canonical URL and md5-checked; when
    `data_dir` already contains `cifar-10-batches-py/` / `cifar-100-python/`
    (or the .tar.gz, extracted in place) no network access is attempted, so
    zero-egress environments with pre-placed data work unchanged.
  * ImageNet — `ImageFolder` semantics: `{split}/{class_name}/*.JPEG`, classes
    sorted alphabetically (src/data_loaders.py:100-113).
  * TinyImageNet — `{split}/{class}/images/*.{png,jpg,jpeg}` walk
    (res-vit/data_loaders.py:154-174).
  * Synthetic — deterministic random data for benches/CI (not in the
    reference; the zero-egress environment needs it).

Each reader returns `(items, labels, num_classes)` where `items` is either a
uint8 array [N,H,W,3] (CIFAR/synthetic — fully in-memory like torchvision) or
a list of file paths decoded lazily by the pipeline.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import List, Tuple

import numpy as np

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".ppm", ".bmp", ".webp", ".JPEG",
                  ".PNG", ".JPG")


# Canonical torchvision sources (torchvision/datasets/cifar.py)
_CIFAR_URLS = {
    "cifar-10-python.tar.gz": (
        "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
        "c58f30108f718f92721af3b95e74349a"),
    "cifar-100-python.tar.gz": (
        "https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz",
        "eb9058c3a382ffc7106e4002c42a8d85"),
}


def _download(url: str, dest: str, md5: str) -> None:
    import hashlib
    import urllib.request
    tmp = dest + ".part"
    try:
        with urllib.request.urlopen(url, timeout=60) as r, open(tmp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    except Exception as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise FileNotFoundError(
            f"dataset archive missing and download from {url} failed ({e}); "
            f"pre-place the archive or extracted directory under "
            f"{os.path.dirname(dest)}") from e
    h = hashlib.md5()
    with open(tmp, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    if h.hexdigest() != md5:
        os.remove(tmp)
        raise IOError(f"md5 mismatch for {url}: got {h.hexdigest()}")
    os.replace(tmp, dest)


def _maybe_extract(data_dir: str, tarname: str, marker: str,
                   download: bool = True) -> None:
    if os.path.isdir(os.path.join(data_dir, marker)):
        return
    tar_path = os.path.join(data_dir, tarname)
    if not os.path.isfile(tar_path) and download and tarname in _CIFAR_URLS:
        os.makedirs(data_dir, exist_ok=True)
        url, md5 = _CIFAR_URLS[tarname]
        _download(url, tar_path, md5)
    if os.path.isfile(tar_path):
        with tarfile.open(tar_path, "r:gz") as tf:
            tf.extractall(data_dir)


def load_cifar10(data_dir: str, split: str) -> Tuple[np.ndarray, np.ndarray, int]:
    _maybe_extract(data_dir, "cifar-10-python.tar.gz", "cifar-10-batches-py")
    base = os.path.join(data_dir, "cifar-10-batches-py")
    files = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
             else ["test_batch"])
    xs, ys = [], []
    for fname in files:
        with open(os.path.join(base, fname), "rb") as f:
            d = pickle.load(f, encoding="latin1")
        xs.append(np.asarray(d["data"], np.uint8))
        ys.extend(d["labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, np.asarray(ys, np.int32), 10


def load_cifar100(data_dir: str, split: str) -> Tuple[np.ndarray, np.ndarray, int]:
    _maybe_extract(data_dir, "cifar-100-python.tar.gz", "cifar-100-python")
    base = os.path.join(data_dir, "cifar-100-python")
    fname = "train" if split == "train" else "test"
    with open(os.path.join(base, fname), "rb") as f:
        d = pickle.load(f, encoding="latin1")
    x = np.asarray(d["data"], np.uint8).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, np.asarray(d["fine_labels"], np.int32), 100


def load_imagefolder(root: str) -> Tuple[List[str], np.ndarray, int]:
    """torchvision `ImageFolder` contract: sorted class dirs → indices."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class directories under {root}")
    paths, labels = [], []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for dirpath, _, filenames in sorted(os.walk(cdir)):
            for fn in sorted(filenames):
                if fn.endswith(IMG_EXTENSIONS):
                    paths.append(os.path.join(dirpath, fn))
                    labels.append(idx)
    return paths, np.asarray(labels, np.int32), len(classes)


def load_imagenet(data_dir: str, split: str) -> Tuple[List[str], np.ndarray, int]:
    return load_imagefolder(os.path.join(data_dir, split))


def load_tinyimagenet(data_dir: str, split: str) -> Tuple[List[str], np.ndarray, int]:
    """res-vit/data_loaders.py:154-174 layout: {split}/{class}/images/*."""
    root = os.path.join(data_dir, split)
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for idx, cls in enumerate(classes):
        img_dir = os.path.join(root, cls, "images")
        if not os.path.isdir(img_dir):  # val layout fallback: class dir itself
            img_dir = os.path.join(root, cls)
        for fn in sorted(os.listdir(img_dir)):
            if fn.endswith(IMG_EXTENSIONS):
                paths.append(os.path.join(img_dir, fn))
                labels.append(idx)
    return paths, np.asarray(labels, np.int32), len(classes)


def load_synthetic(num_samples: int = 512, image_hw: int = 32,
                   num_classes: int = 10, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (num_samples, image_hw, image_hw, 3), np.uint8)
    y = rng.randint(0, num_classes, (num_samples,)).astype(np.int32)
    return x, y, num_classes
