"""``vision.transforms`` and ``vision.datasets`` held to paddle_tpu's (the
twins of ``tests/test_vision_datasets_formats.py``, the transform and
folder cases of ``tests/test_hapi_vision_breadth.py`` and the vision data
cases of ``tests/test_highlevel.py``).

The same image goes through both packages' transform after the same
``numpy`` and ``random`` seeds; the datasets read the same archives
written here and their items are compared exactly.  ``Resize`` is the
one transform that computes: the port's
``F.interpolate(..., "bilinear", antialias=True)`` against paddle_tpu's
``jax.image.resize(..., "linear")``, held to ``RESIZE_ATOL`` (float32
rounding of two weightings of the same triangle filter; no border
difference was found, so the borders are held to the same bound)."""
import gzip
import io
import os
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest

import paddle_tpu.vision.datasets as jds
import paddle_tpu.vision.transforms as JT

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.vision.datasets as tds
import paddle_tpu_torch.vision.transforms as TT
from paddle_tpu_torch.core import placement

SIDES = {"jax": (JT, jds), "torch": (TT, tds)}
RESIZE_ATOL = {"float": 2e-6, "uint8": 5e-4}   # data range 1 and 255


@pytest.fixture(autouse=True)
def _cpu():
    tpaddle.set_device("cpu")
    yield
    placement.set_default(None)


def _img(kind, shape, seed=0):
    r = np.random.RandomState(seed)
    if kind == "uint8":
        return r.randint(0, 256, shape).astype(np.uint8)
    return r.rand(*shape).astype(np.float32)


def _apply(make, img, seed=5):
    out = {}
    for side, (T, _) in SIDES.items():
        np.random.seed(seed)
        random.seed(seed)
        out[side] = np.asarray(make(T)(img))
    return out


@pytest.mark.parametrize("kind", ["float", "uint8"])
@pytest.mark.parametrize("layout", ["CHW", "HWC"])
@pytest.mark.parametrize("size", [(4, 4), (40, 24), (7, 5), (16, 16)])
def test_resize_matches_paddle_tpu(kind, layout, size):
    shape = (3, 17, 13) if layout == "CHW" else (17, 13, 3)
    out = _apply(lambda T: T.Resize(size), _img(kind, shape))
    assert out["torch"].dtype == out["jax"].dtype == np.float32
    assert out["torch"].shape == out["jax"].shape
    err = np.abs(out["torch"] - out["jax"])
    assert err.max() <= RESIZE_ATOL[kind], err.max()


TRANSFORMS = {
    "to_tensor": lambda T: T.ToTensor(),
    "normalize_hwc": lambda T: T.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4],
                                           data_format="HWC"),
    "transpose": lambda T: T.Transpose(),
    "center_crop": lambda T: T.CenterCrop(5),
    "random_crop_pad": lambda T: T.RandomCrop(6, padding=2),
    "hflip": lambda T: T.RandomHorizontalFlip(1.0),
    "vflip": lambda T: T.RandomVerticalFlip(1.0),
    "brightness": lambda T: T.BrightnessTransform(0.4),
    "pad": lambda T: T.Pad([1, 2]),
    "contrast": lambda T: T.ContrastTransform(0.5),
    "saturation": lambda T: T.SaturationTransform(0.5),
    "hue": lambda T: T.HueTransform(0.2),
    "color_jitter": lambda T: T.ColorJitter(0.2, 0.2, 0.2, 0.1),
    "grayscale": lambda T: T.Grayscale(3),
    "rotation": lambda T: T.RandomRotation(30),
    "erasing": lambda T: T.RandomErasing(prob=1.0, value=0),
    "compose": lambda T: T.Compose([T.RandomCrop(8), T.ToTensor(),
                                    T.Normalize(0.5, 0.5)]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_paddle_tpu(name):
    img = _img("uint8", (10, 10, 3), seed=1)
    out = _apply(TRANSFORMS[name], img)
    assert out["torch"].dtype == out["jax"].dtype
    np.testing.assert_array_equal(out["torch"], out["jax"])


def test_random_resized_crop_matches_paddle_tpu():
    out = _apply(lambda T: T.RandomResizedCrop(4), _img("uint8", (9, 9, 3)))
    assert out["torch"].shape[:2] == (4, 4)
    assert np.abs(out["torch"] - out["jax"]).max() <= RESIZE_ATOL["uint8"]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_new_transforms_behave(side):
    T, _ = SIDES[side]
    random.seed(7)
    img = (np.random.RandomState(7).rand(8, 8, 3) * 255).astype(np.uint8)
    g = np.asarray(T.Grayscale(3)(img), np.float32)
    assert g.shape == img.shape and np.allclose(g[..., 0], g[..., 1])
    assert T.RandomResizedCrop(4)(img).shape[:2] == (4, 4)
    np.testing.assert_array_equal(T.RandomRotation(0.0)(img), img)
    er = T.RandomErasing(prob=1.0, value=0)(img.astype(np.float32))
    assert (er == 0).sum() > (img == 0).sum()
    cj = T.ColorJitter(brightness=0.2, contrast=0.2, saturation=0.2,
                       hue=0.1)(img)
    assert cj.shape == img.shape and cj.dtype == img.dtype
    np.testing.assert_array_equal(T.ContrastTransform(0.0)(img), img)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_transforms_shapes(side):
    T, _ = SIDES[side]
    img = np.random.RandomState(3).rand(3, 16, 16).astype(np.float32)
    assert T.CenterCrop(8)(img).shape == (3, 8, 8)
    assert T.Resize((4, 4))(img).shape == (3, 4, 4)
    hwc = np.random.RandomState(4).randint(0, 255, (8, 8, 3), np.uint8)
    out = T.ToTensor()(hwc)
    assert out.shape == (3, 8, 8) and out.max() <= 1.0


def test_mnist_synthetic_and_transform():
    got = {}
    for side, (T, ds) in SIDES.items():
        d = ds.MNIST(mode="train", transform=T.Compose(
            [T.Normalize(mean=0.5, std=0.5)]))
        assert len(d) == 6000
        got[side] = [d[i] for i in (0, 17, 5999)]
    for (a, la), (b, lb) in zip(got["torch"], got["jax"]):
        assert a.shape == (1, 28, 28)
        np.testing.assert_array_equal(a, b)
        assert int(la) == int(lb)
    c = {side: ds.Cifar10(mode="test")[3] for side, (_, ds) in SIDES.items()}
    np.testing.assert_array_equal(c["torch"][0], c["jax"][0])


def _add_bytes(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _image_bytes(arr, fmt):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def _items(ds, n=None):
    return [ds[i] for i in range(len(ds) if n is None else n)]


def _same_items(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_mnist_parses_idx_gzip(tmp_path):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (5, 28, 28), dtype=np.uint8)
    labels = np.array([3, 1, 4, 1, 5], np.uint8)
    ip = str(tmp_path / "train-images-idx3-ubyte.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28))
        f.write(imgs.tobytes())
    lp = str(tmp_path / "train-labels-idx1-ubyte.gz")
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 5))
        f.write(labels.tobytes())
    got = {side: _items(ds.MNIST(image_path=ip, label_path=lp))
           for side, (_, ds) in SIDES.items()}
    _same_items(got["torch"], got["jax"])
    np.testing.assert_allclose(got["torch"][0][0][0],
                               imgs[0].astype(np.float32) / 255.0)
    assert [int(x[1]) for x in got["torch"]] == [3, 1, 4, 1, 5]


def _make_cifar(path, coarse=False):
    rs = np.random.RandomState(1)

    def batch(n, key):
        return pickle.dumps({
            b"data": rs.randint(0, 256, (n, 3072), dtype=np.uint8),
            key: rs.randint(0, 10, n).tolist()})
    with tarfile.open(path, "w:gz") as tf:
        key = b"fine_labels" if coarse else b"labels"
        _add_bytes(tf, "cifar/data_batch_1", batch(3, key))
        _add_bytes(tf, "cifar/data_batch_2", batch(3, key))
        _add_bytes(tf, "cifar/test_batch", batch(4, key))


@pytest.mark.parametrize("cls,coarse", [("Cifar10", False),
                                        ("Cifar100", True)])
def test_cifar_parses_pickle_tar(tmp_path, cls, coarse):
    p = str(tmp_path / "cifar.tar.gz")
    _make_cifar(p, coarse)
    for mode, n in (("train", 6), ("test", 4)):
        got = {side: _items(getattr(ds, cls)(data_file=p, mode=mode))
               for side, (_, ds) in SIDES.items()}
        _same_items(got["torch"], got["jax"])
        assert len(got["torch"]) == n
        assert got["torch"][0][0].shape == (3, 32, 32)


def test_flowers_parses_tgz_and_mat(tmp_path):
    import scipy.io as scio
    rs = np.random.RandomState(2)
    tgz = str(tmp_path / "102flowers.tgz")
    with tarfile.open(tgz, "w:gz") as tf:
        for i in range(1, 7):
            img = rs.randint(0, 256, (8, 8, 3), dtype=np.uint8)
            _add_bytes(tf, f"jpg/image_{i:05d}.jpg", _image_bytes(img, "JPEG"))
    lm = str(tmp_path / "imagelabels.mat")
    scio.savemat(lm, {"labels": np.arange(1, 7, dtype=np.uint8)[None, :]})
    sm = str(tmp_path / "setid.mat")
    scio.savemat(sm, {"tstid": np.array([[1, 2, 3, 4]]),
                      "trnid": np.array([[5, 6]]),
                      "valid": np.array([[5]])})
    for mode, n in (("train", 4), ("test", 2)):
        got = {side: _items(ds.Flowers(data_file=tgz, label_file=lm,
                                       setid_file=sm, mode=mode))
               for side, (_, ds) in SIDES.items()}
        _same_items(got["torch"], got["jax"])
        assert len(got["torch"]) == n
    assert int(got["torch"][0][1][0]) == 5
    with pytest.raises(ValueError, match="local file"):
        tds.Flowers(data_file=None, label_file=lm, setid_file=sm)


def test_voc2012_parses_devkit_tar(tmp_path):
    rs = np.random.RandomState(3)
    tar_p = str(tmp_path / "VOCtrainval_11-May-2012.tar")
    names = ["2007_000027", "2007_000032"]
    with tarfile.open(tar_p, "w") as tf:
        _add_bytes(tf, "VOCdevkit/VOC2012/ImageSets/Segmentation/"
                   "trainval.txt", ("\n".join(names) + "\n").encode())
        _add_bytes(tf, "VOCdevkit/VOC2012/ImageSets/Segmentation/val.txt",
                   (names[0] + "\n").encode())
        for nm in names:
            img = rs.randint(0, 256, (10, 12, 3), dtype=np.uint8)
            _add_bytes(tf, f"VOCdevkit/VOC2012/JPEGImages/{nm}.jpg",
                       _image_bytes(img, "JPEG"))
            mask = rs.randint(0, 21, (10, 12), dtype=np.uint8)
            _add_bytes(tf, f"VOCdevkit/VOC2012/SegmentationClass/{nm}.png",
                       _image_bytes(mask, "PNG"))
    got = {side: _items(ds.VOC2012(data_file=tar_p, mode="train"))
           for side, (_, ds) in SIDES.items()}
    _same_items(got["torch"], got["jax"])
    image, label = got["torch"][0]
    assert image.shape == (10, 12, 3) and label.dtype == np.int64
    assert len(tds.VOC2012(data_file=tar_p, mode="valid")) == 1
    ds = tds.VOC2012(data_file=tar_p, mode="train")
    ds2 = pickle.loads(pickle.dumps(ds))      # picklable for workers
    np.testing.assert_array_equal(ds2[1][1], ds[1][1])


def test_dataset_folder_and_image_folder(tmp_path):
    root = tmp_path / "ds"
    for k, cls in enumerate(("cat", "dog")):
        d = root / cls
        os.makedirs(d)
        for i in range(3):
            np.save(d / f"{i}.npy", np.full((2, 2, 3), fill_value=k * 3 + i,
                                            dtype=np.float32))
    got = {}
    for side, (_, ds) in SIDES.items():
        folder = ds.DatasetFolder(str(root))
        assert folder.classes == ["cat", "dog"] and len(folder) == 6
        flat = ds.ImageFolder(str(root))
        assert len(flat) == 6 and flat[0].shape == (2, 2, 3)
        got[side] = _items(folder)
        empty = tmp_path / f"empty_{side}"
        os.makedirs(empty)
        with pytest.raises(ValueError, match="no class"):
            ds.DatasetFolder(str(empty))
    _same_items(got["torch"], got["jax"])
    assert sorted(int(x[1]) for x in got["torch"]) == [0, 0, 0, 1, 1, 1]
