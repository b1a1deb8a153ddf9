"""Vision datasets (the counterpart of ``paddle_tpu/vision/datasets.py``;
reference: python/paddle/vision/datasets/: mnist.py, cifar.py,
folder.py, flowers.py, voc2012.py).

They read local files only: MNIST and Cifar take a local ``image_path``
/ ``data_file`` and otherwise make paddle_tpu's deterministic synthetic
stand-in with the real shapes and classes; Flowers and VOC2012 raise
without their archives.  Nothing downloads.  :class:`DatasetFolder` and
:class:`ImageFolder` read ``.npy`` arrays natively and image files
through PIL where it is installed (or a ``loader=``)."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io import Dataset


def _synthetic_images(n, shape, num_classes, seed):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, num_classes, n).astype(np.int64)
    imgs = rs.rand(n, *shape).astype(np.float32)
    # make images weakly class-dependent so models can actually learn
    for c in range(num_classes):
        mask = labels == c
        imgs[mask] += 0.5 * np.sin(
            np.linspace(0, 3.14 * (c + 1), int(np.prod(shape)))
        ).reshape(shape).astype(np.float32)
    return imgs, labels


class MNIST(Dataset):
    """reference: vision/datasets/mnist.py.  Reads idx-format files when
    ``image_path``/``label_path`` provided; synthetic otherwise."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="cv2"):
        self.mode = mode
        self.transform = transform
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                self.images = np.frombuffer(
                    f.read(), np.uint8).reshape(n, rows, cols).astype(
                        np.float32) / 255.0
            with gzip.open(label_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                self.labels = np.frombuffer(f.read(), np.uint8).astype(
                    np.int64)
        else:
            n = 6000 if mode == "train" else 1000
            self.images, self.labels = _synthetic_images(
                n, (28, 28), 10, seed=0 if mode == "train" else 1)

    def __getitem__(self, idx):
        img = self.images[idx][None]  # [1, 28, 28]
        if self.transform is not None:
            img = self.transform(img)
        return img.astype(np.float32), np.asarray(self.labels[idx])

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    """reference: vision/datasets/cifar.py."""

    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="cv2"):
        self.transform = transform
        if data_file and os.path.exists(data_file):
            import pickle
            import tarfile
            imgs, labels = [], []
            with tarfile.open(data_file) as tf:
                names = [m for m in tf.getnames()
                         if ("data_batch" in m if mode == "train"
                             else "test_batch" in m)]
                for name in sorted(names):
                    d = pickle.load(tf.extractfile(name), encoding="bytes")
                    imgs.append(d[b"data"])
                    labels.extend(d.get(b"labels", d.get(b"fine_labels")))
            self.images = (np.concatenate(imgs).reshape(-1, 3, 32, 32)
                           .astype(np.float32) / 255.0)
            self.labels = np.asarray(labels, np.int64)
        else:
            n = 5000 if mode == "train" else 1000
            self.images, self.labels = _synthetic_images(
                n, (3, 32, 32), self.NUM_CLASSES,
                seed=2 if mode == "train" else 3)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img.astype(np.float32), np.asarray(self.labels[idx])

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100


class DatasetFolder(Dataset):
    """Class-per-subdirectory dataset (reference:
    vision/datasets/folder.py DatasetFolder): ``root/<class>/<file>``
    layouts, with classes sorted alphabetically into label ids.

    Supports ``.npy`` arrays natively and standard image files via PIL
    when installed (the reference uses cv2/PIL loaders)."""

    IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        import os
        self.root = root
        self.transform = transform
        self.loader = loader or self._default_loader
        exts = tuple(e.lower() for e in (extensions or
                                         (".npy",) + self.IMG_EXTS))
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise ValueError(
                f"DatasetFolder: no class subdirectories under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fn in sorted(files):
                    path = os.path.join(dirpath, fn)
                    ok = (is_valid_file(path) if is_valid_file
                          else fn.lower().endswith(exts))
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise ValueError(
                f"DatasetFolder: no files with extensions {exts} under "
                f"{root}")

    @staticmethod
    def _default_loader(path):
        if path.lower().endswith(".npy"):
            return np.load(path)
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                f"loading {path} needs PIL (or pass loader=)") from e
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(label)

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    """reference: folder.py ImageFolder — unlabeled flat/recursive image
    tree; __getitem__ returns just the image."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        import os
        self.root = root
        self.transform = transform
        self.loader = loader or self._default_loader
        exts = tuple(e.lower() for e in (extensions or
                                         (".npy",) + self.IMG_EXTS))
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fn in sorted(files):
                path = os.path.join(dirpath, fn)
                ok = (is_valid_file(path) if is_valid_file
                      else fn.lower().endswith(exts))
                if ok:
                    self.samples.append((path, -1))
        if not self.samples:
            raise ValueError(f"ImageFolder: no images under {root}")

    def __getitem__(self, idx):
        path, _ = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img


class _LazyTarReader:
    """Per-thread tarfile handles over one archive path: a single shared
    TarFile is neither picklable (DataLoader worker processes) nor
    thread-safe (the prefetch threads seek one shared offset).  TarInfo
    members carry their own data offsets, so any handle can serve any
    member; the handle cache is excluded from pickling."""

    def _init_tar(self, data_file):
        import tarfile
        import threading
        self._tar_path = self._ensure_seekable(data_file)
        self._tar_local = threading.local()
        with tarfile.open(self._tar_path) as tf:
            self.name2mem = {m.name: m for m in tf.getmembers()}

    # archive identity -> decompressed temp path (one decompression per
    # archive even across train/valid/test splits)
    _SEEKABLE_CACHE: dict = {}

    @classmethod
    def _ensure_seekable(cls, data_file):
        """gzip has no random access: a seek backwards inside a .tgz
        re-decompresses from byte 0, making shuffled epochs
        quasi-quadratic.  Decompress ONCE to an uncompressed temp tar
        and serve offsets from that (deleted at interpreter exit)."""
        import gzip as _gz
        with open(data_file, "rb") as f:
            magic = f.read(2)
        if magic != b"\x1f\x8b":
            return data_file
        st = os.stat(data_file)
        key = (os.path.abspath(data_file), st.st_size, st.st_mtime_ns)
        cached = cls._SEEKABLE_CACHE.get(key)
        if cached is not None and os.path.exists(cached):
            return cached
        import atexit
        import shutil
        import tempfile
        tmp = tempfile.NamedTemporaryFile(suffix=".tar", delete=False)
        with _gz.open(data_file, "rb") as src:
            shutil.copyfileobj(src, tmp)
        tmp.close()
        atexit.register(lambda p=tmp.name: os.path.exists(p)
                        and os.unlink(p))
        cls._SEEKABLE_CACHE[key] = tmp.name
        return tmp.name

    def _read_member(self, name):
        import tarfile
        tf = getattr(self._tar_local, "tf", None)
        if tf is None:
            tf = tarfile.open(self._tar_path)
            self._tar_local.tf = tf
        return tf.extractfile(self.name2mem[name]).read()

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_tar_local", None)
        return state

    def __setstate__(self, state):
        import threading
        self.__dict__.update(state)
        self._tar_local = threading.local()


class Flowers(_LazyTarReader, Dataset):
    """reference: vision/datasets/flowers.py:47 (102flowers jpg tarball +
    imagelabels.mat 'labels' + setid.mat subset indices; NOTE the
    reference maps train->'tstid' and test->'trnid' on purpose — the
    official split has more test data, flowers.py:37-40).  Images decode
    lazily per __getitem__, exactly like the reference."""

    MODE_FLAG_MAP = {"train": "tstid", "test": "trnid", "valid": "valid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True,
                 backend="cv2"):
        assert mode.lower() in self.MODE_FLAG_MAP, mode
        self.flag = self.MODE_FLAG_MAP[mode.lower()]
        self.transform = transform
        for name, p in (("data_file", data_file),
                        ("label_file", label_file),
                        ("setid_file", setid_file)):
            if p is None or not os.path.exists(p):
                raise ValueError(
                    f"Flowers: {name} must point at a local file "
                    f"(102flowers.tgz / imagelabels.mat / setid.mat; no "
                    f"downloads in this environment), got {p!r}")
        import scipy.io as scio
        self.labels = scio.loadmat(label_file)["labels"][0]
        self.indexes = scio.loadmat(setid_file)[self.flag][0]
        self._init_tar(data_file)

    def _decode(self, raw):
        import io as _io

        from PIL import Image
        with Image.open(_io.BytesIO(raw)) as im:
            return np.asarray(im.convert("RGB"))

    def __getitem__(self, idx):
        index = int(self.indexes[idx])
        label = np.array([self.labels[index - 1]])
        img = self._decode(self._read_member(f"jpg/image_{index:05d}.jpg"))
        if self.transform is not None:
            img = self.transform(img)
        return img, label.astype(np.int64)

    def __len__(self):
        return len(self.indexes)


class VOC2012(_LazyTarReader, Dataset):
    """reference: vision/datasets/voc2012.py:40 (VOCdevkit tar;
    ImageSets/Segmentation/{flag}.txt name lists; JPEGImages/{name}.jpg
    inputs and SegmentationClass/{name}.png masks; train->'trainval',
    test->'train', valid->'val' per voc2012.py:37)."""

    SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
    DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
    LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"
    MODE_FLAG_MAP = {"train": "trainval", "test": "train", "valid": "val"}

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="cv2"):
        assert mode.lower() in self.MODE_FLAG_MAP, mode
        self.flag = self.MODE_FLAG_MAP[mode.lower()]
        self.transform = transform
        if data_file is None or not os.path.exists(data_file):
            raise ValueError(
                f"VOC2012: data_file must point at a local VOCtrainval "
                f"tar (no downloads in this environment), got "
                f"{data_file!r}")
        self._init_tar(data_file)
        names = self._read_member(self.SET_FILE.format(self.flag))
        self.name_list = [ln.strip() for ln in names.decode().splitlines()
                          if ln.strip()]

    def _decode(self, raw, mode):
        import io as _io

        from PIL import Image
        with Image.open(_io.BytesIO(raw)) as im:
            return np.asarray(im if mode is None else im.convert(mode))

    def __getitem__(self, idx):
        name = self.name_list[idx]
        image = self._decode(
            self._read_member(self.DATA_FILE.format(name)), "RGB")
        label = self._decode(
            self._read_member(self.LABEL_FILE.format(name)), None)
        if self.transform is not None:
            image = self.transform(image)
        return image, label.astype(np.int64)

    def __len__(self):
        return len(self.name_list)
