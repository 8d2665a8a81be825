"""Host input pipeline: transforms + batched loader with thread prefetch.

Behavioral parity with the reference's loaders (src/data_loaders.py:32-124,
res-vit/data_loaders.py):

  * train transform: Resize((s,s)) + RandomHorizontalFlip + Normalize(.5,.5)
  * val transform:   Resize((s,s)) + Normalize(.5,.5)
  * seeded shuffle per epoch (the reference seeds a torch.Generator,
    src/data_loaders.py:53-54); vitax derives a numpy permutation from
    (seed, epoch) so data order is reproducible and resumable.

Resize uses PIL bilinear with antialias — the same code path torchvision's
`transforms.Resize` takes on PIL images, so preprocessing matches the
reference pixel-for-pixel (SURVEY §7 "input-pipeline parity").

Batches are NHWC float32 in [-1, 1]; `drop_last` defaults False like torch
DataLoader — the final partial batch is PADDED to full size and carries a
`weight` mask so eval metrics count exactly the real samples while every jit
step sees one static shape (no recompilation).

Copied from vitax/data/pipeline.py without the native C++ batch assembly
and the uint8 `raw` batches of vitax's device-side preprocessing (both come
with the training port), so every split takes the PIL path here.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Tuple, Union

import numpy as np

from vitax_torch.data import datasets as D

try:
    from PIL import Image
    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False

MEAN = 0.5
STD = 0.5


def _resize_uint8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H,W,3] uint8 → [h,w,3] uint8, PIL bilinear (torchvision-identical)."""
    if img.shape[:2] == size:
        return img
    if _HAVE_PIL:
        return np.asarray(Image.fromarray(img).resize(
            (size[1], size[0]), Image.BILINEAR))
    # crude fallback: nearest via index sampling
    ys = (np.arange(size[0]) * img.shape[0] / size[0]).astype(int)
    xs = (np.arange(size[1]) * img.shape[1] / size[1]).astype(int)
    return img[ys][:, xs]


def _decode(path: str) -> np.ndarray:
    img = Image.open(path).convert("RGB")
    return np.asarray(img)


def normalize(batch_uint8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] → float32, ToTensor then Normalize(0.5, 0.5) → [-1,1]."""
    return (batch_uint8.astype(np.float32) / 255.0 - MEAN) / STD


class Batch:
    __slots__ = ("images", "labels", "weight")

    def __init__(self, images, labels, weight):
        self.images = images   # [B,H,W,3] float32 NHWC
        self.labels = labels   # [B] int32
        self.weight = weight   # [B] float32 — 0 for padding rows

    def __iter__(self):  # tuple-unpacking convenience
        return iter((self.images, self.labels, self.weight))


class DataLoader:
    """Epoch-iterable batched loader with background prefetch.

    Mirrors the reference loaders' constructor surface
    (`{CIFAR10,...}DataLoader(data_dir, split, image_size, batch_size,
    num_workers, seed)`); `num_workers` sizes the decode thread pool for
    path-backed datasets.
    """

    def __init__(self, items: Union[np.ndarray, List[str]], labels: np.ndarray,
                 num_classes: int, image_size: int = 224, batch_size: int = 32,
                 split: str = "train", seed: int = 42, num_workers: int = 4,
                 flip: Optional[bool] = None, drop_last: bool = False,
                 prefetch: int = 4):
        self.items = items
        self.labels = np.asarray(labels, np.int32)
        self.num_classes = num_classes
        self.image_size = (image_size, image_size)
        self.batch_size = batch_size
        self.split = split
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.flip = (split == "train") if flip is None else flip
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        self._n = len(self.labels)
        # decode pool for path-backed datasets (ImageNet-style): PIL decode
        # releases the GIL during I/O and JPEG work, so threads give real
        # parallelism; in-memory datasets skip it (slicing is cheap)
        self._pool = None
        if (self.num_workers > 1 and len(items)
                and isinstance(items[0], str)):
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                            thread_name_prefix="vitax-decode")

    def __len__(self) -> int:
        if self.drop_last:
            return self._n // self.batch_size
        return (self._n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    # -- internals ---------------------------------------------------------

    def _order(self) -> np.ndarray:
        if self.split != "train":
            return np.arange(self._n)
        rng = np.random.RandomState((self.seed * 1_000_003 + self.epoch)
                                    % (2 ** 31))
        return rng.permutation(self._n)

    def _load_image(self, idx: int) -> np.ndarray:
        item = self.items[idx]
        img = _decode(item) if isinstance(item, str) else item
        return _resize_uint8(img, self.image_size)

    def _load_many(self, idxs: np.ndarray) -> List[np.ndarray]:
        if self._pool is not None:
            return list(self._pool.map(self._load_image,
                                       [int(i) for i in idxs]))
        return [self._load_image(int(i)) for i in idxs]

    def _make_batch(self, idxs: np.ndarray, flip_bits: np.ndarray) -> Batch:
        bs = self.batch_size
        h, w = self.image_size
        images = np.empty((bs, h, w, 3), np.float32)
        labels = np.zeros((bs,), np.int32)
        weight = np.zeros((bs,), np.float32)
        for j, img in enumerate(self._load_many(idxs)):
            if flip_bits[j]:
                img = img[:, ::-1]
            images[j] = normalize(img)
            labels[j] = self.labels[idxs[j]]
            weight[j] = 1.0
        # padding rows replicate row 0 (weight 0) so shapes stay static
        for j in range(len(idxs), bs):
            images[j] = images[0]
        return Batch(images, labels, weight)

    def __iter__(self) -> Iterator[Batch]:
        order = self._order()
        nb = len(self)
        flip_rng = np.random.RandomState(
            (self.seed * 7_368_787 + self.epoch + 13) % (2 ** 31))
        flips = (flip_rng.rand(self._n) < 0.5) if self.flip \
            else np.zeros(self._n, bool)

        def gen():
            for b in range(nb):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                yield self._make_batch(idxs, flips[b * self.batch_size:
                                                   b * self.batch_size + len(idxs)])

        if self.prefetch <= 0:
            yield from gen()
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []

        def worker():
            try:
                for item in gen():
                    q.put(item)
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item


# -- reference-named constructors -------------------------------------------

def _make(loader_fn: Callable, data_dir: str, split: str, image_size: int,
          batch_size: int, num_workers: int, seed: int, **kw) -> DataLoader:
    items, labels, ncls = loader_fn(data_dir, split)
    return DataLoader(items, labels, ncls, image_size=image_size,
                      batch_size=batch_size, split=split, seed=seed,
                      num_workers=num_workers, **kw)


def CIFAR10DataLoader(data_dir: str, split: str = "train", image_size: int = 224,
                      batch_size: int = 32, num_workers: int = 4,
                      seed: int = 42, **kw) -> DataLoader:
    return _make(D.load_cifar10, data_dir, split, image_size, batch_size,
                 num_workers, seed, **kw)


def CIFAR100DataLoader(data_dir: str, split: str = "train", image_size: int = 224,
                       batch_size: int = 32, num_workers: int = 4,
                       seed: int = 42, **kw) -> DataLoader:
    return _make(D.load_cifar100, data_dir, split, image_size, batch_size,
                 num_workers, seed, **kw)


def ImageNetDataLoader(data_dir: str, split: str = "train", image_size: int = 224,
                       batch_size: int = 32, num_workers: int = 4,
                       seed: int = 42, **kw) -> DataLoader:
    return _make(D.load_imagenet, data_dir, split, image_size, batch_size,
                 num_workers, seed, flip=False, **kw)


def TinyImageNetDataLoader(data_dir: str, split: str = "train",
                           image_size: int = 64, batch_size: int = 32,
                           num_workers: int = 4, seed: int = 42,
                           **kw) -> DataLoader:
    return _make(D.load_tinyimagenet, data_dir, split, image_size, batch_size,
                 num_workers, seed, **kw)


def SyntheticDataLoader(data_dir: str = "", split: str = "train",
                        image_size: int = 224, batch_size: int = 32,
                        num_workers: int = 0, seed: int = 42,
                        num_samples: int = 512, num_classes: int = 10,
                        **kw) -> DataLoader:
    items, labels, ncls = D.load_synthetic(num_samples, image_size,
                                           num_classes, seed)
    return DataLoader(items, labels, ncls, image_size=image_size,
                      batch_size=batch_size, split=split, seed=seed,
                      num_workers=num_workers, **kw)


DATALOADER_REGISTRY = {
    "CIFAR10": CIFAR10DataLoader,
    "CIFAR100": CIFAR100DataLoader,
    "ImageNet": ImageNetDataLoader,
    "TinyImageNet": TinyImageNetDataLoader,
    "Synthetic": SyntheticDataLoader,
}


def get_dataloader(dataset: str, **kw) -> DataLoader:
    """Registry dispatch — replaces the reference's
    `eval("{dataset}DataLoader")` (src/train.py:134)."""
    if dataset not in DATALOADER_REGISTRY:
        raise ValueError(f"unknown dataset {dataset!r}; "
                         f"choose from {sorted(DATALOADER_REGISTRY)}")
    return DATALOADER_REGISTRY[dataset](**kw)
