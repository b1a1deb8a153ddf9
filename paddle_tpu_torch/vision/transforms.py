"""Image transforms over numpy HWC or CHW arrays (the counterpart of
``paddle_tpu/vision/transforms.py``; reference:
python/paddle/vision/transforms/).

They run on the host, in DataLoader workers, and draw from numpy's and
Python's global generators as paddle_tpu's do.  :class:`Resize` is
bilinear with half-pixel centres and, when it shrinks, an antialiasing
triangle filter (``torch.nn.functional.interpolate(..., antialias=True)``
on the CPU, paddle_tpu's ``jax.image.resize(..., "linear")``); its output
is float32 whatever the input's type, as paddle_tpu's is."""
from __future__ import annotations

import numbers

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(np.asarray(img))

    def _apply_image(self, img):
        raise NotImplementedError


class ToTensor(BaseTransform):
    """HWC uint8 [0,255] → CHW float32 [0,1]."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        if img.ndim == 2:
            img = img[..., None]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if self.data_format == "CHW" and img.shape[-1] in (1, 3, 4):
            img = np.transpose(img, (2, 0, 1))
        return img.astype(np.float32)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        mean, std = self.mean, self.std
        if self.data_format == "CHW":
            shape = (-1,) + (1,) * (img.ndim - 1)
        else:
            shape = (1,) * (img.ndim - 1) + (-1,)
        return ((img - mean.reshape(shape)) /
                std.reshape(shape)).astype(np.float32)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = tuple(order)

    def _apply_image(self, img):
        return np.transpose(img, self.order)


def _chw(img):
    return img.ndim == 3 and img.shape[0] in (1, 3, 4)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = ((size, size) if isinstance(size, numbers.Number)
                     else tuple(size))

    def _apply_image(self, img):
        import torch
        import torch.nn.functional as F
        chw = _chw(img)
        a = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        if not chw:
            a = a.movedim(-1, 0)
        out = F.interpolate(a[None], size=self.size, mode="bilinear",
                            align_corners=False, antialias=True)[0]
        if not chw:
            out = out.movedim(0, -1)
        return np.ascontiguousarray(out.numpy())


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = ((size, size) if isinstance(size, numbers.Number)
                     else tuple(size))

    def _apply_image(self, img):
        th, tw = self.size
        if _chw(img):
            h, w = img.shape[1:]
            i, j = (h - th) // 2, (w - tw) // 2
            return img[:, i:i + th, j:j + tw]
        h, w = img.shape[:2]
        i, j = (h - th) // 2, (w - tw) // 2
        return img[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False):
        self.size = ((size, size) if isinstance(size, numbers.Number)
                     else tuple(size))
        self.padding = padding

    def _apply_image(self, img):
        th, tw = self.size
        chw = _chw(img)
        if self.padding:
            p = self.padding
            pad = ((0, 0), (p, p), (p, p)) if chw else ((p, p), (p, p),
                                                        (0, 0))
            img = np.pad(img, pad[:img.ndim], mode="constant")
        h, w = img.shape[1:] if chw else img.shape[:2]
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        if chw:
            return img[:, i:i + th, j:j + tw]
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return img[..., ::-1].copy() if _chw(img) else \
                img[:, ::-1].copy()
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return (img[:, ::-1].copy() if _chw(img)
                    else img[::-1].copy())
        return img


class BrightnessTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        alpha = 1 + np.random.uniform(-self.value, self.value)
        out = img.astype(np.float32) * alpha
        if np.issubdtype(np.asarray(img).dtype, np.integer):
            return np.clip(out, 0, 255).astype(img.dtype)
        return np.clip(out, 0, 1).astype(np.float32)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = (padding if isinstance(padding, (list, tuple))
                        else (padding,) * 4)
        self.fill = fill

    def _apply_image(self, img):
        l, t, r, b = (self.padding * 2)[:4] if len(self.padding) == 2 \
            else self.padding
        if _chw(img):
            return np.pad(img, ((0, 0), (t, b), (l, r)),
                          constant_values=self.fill)
        return np.pad(img, ((t, b), (l, r)) + ((0, 0),) * (img.ndim - 2),
                      constant_values=self.fill)


# -- the rest of the reference's transforms/transforms.py ------------------

class ContrastTransform(BaseTransform):
    """reference: transforms.py ContrastTransform — blend with the mean."""

    def __init__(self, value):
        self.value = float(value)

    def _apply_image(self, img):
        import random
        f = 1.0 + random.uniform(-self.value, self.value)
        x = img.astype(np.float32)
        mean = x.mean()
        out = mean + (x - mean) * f
        return _like(out, img)


class SaturationTransform(BaseTransform):
    """Blend with the grayscale image (HWC or CHW, 3 channels)."""

    def __init__(self, value):
        self.value = float(value)

    def _apply_image(self, img):
        import random
        f = 1.0 + random.uniform(-self.value, self.value)
        x = img.astype(np.float32)
        gray = _to_gray(x)
        out = gray + (x - gray) * f
        return _like(out, img)


class HueTransform(BaseTransform):
    """Channel-roll hue approximation in RGB space (value in [0, 0.5])."""

    def __init__(self, value):
        self.value = float(value)

    def _apply_image(self, img):
        import random
        f = random.uniform(-self.value, self.value)
        x = img.astype(np.float32)
        ch_axis = 0 if x.shape[0] in (1, 3) else -1
        if x.shape[ch_axis] != 3:
            return img
        other = x.sum(axis=ch_axis, keepdims=True) - x
        out = x + f * (other / 2.0 - x)
        return _like(out, img)


class ColorJitter(BaseTransform):
    """reference: transforms.py ColorJitter — random order of
    brightness/contrast/saturation/hue."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.ts = []
        if brightness:
            self.ts.append(BrightnessTransform(brightness))
        if contrast:
            self.ts.append(ContrastTransform(contrast))
        if saturation:
            self.ts.append(SaturationTransform(saturation))
        if hue:
            self.ts.append(HueTransform(hue))

    def _apply_image(self, img):
        import random
        order = list(self.ts)
        random.shuffle(order)
        for t in order:
            img = t._apply_image(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1):
        self.n = num_output_channels

    def _apply_image(self, img):
        x = img.astype(np.float32)
        gray = _to_gray(x)
        ch_axis = 0 if x.shape[0] in (1, 3) else -1
        take = [0] * self.n
        out = np.take(gray, take, axis=ch_axis)
        return _like(out, img)


class RandomResizedCrop(BaseTransform):
    """reference: transforms.py RandomResizedCrop (scale/ratio sampling,
    resize to target)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def _apply_image(self, img):
        import random
        chw = img.ndim == 3 and img.shape[0] in (1, 3)
        h, w = (img.shape[1:], img.shape[:2])[0 if chw else 1]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = random.uniform(*self.ratio)
            cw = int(round((target * ar) ** 0.5))
            ch = int(round((target / ar) ** 0.5))
            if 0 < cw <= w and 0 < ch <= h:
                top = random.randint(0, h - ch)
                left = random.randint(0, w - cw)
                if chw:
                    crop = img[:, top:top + ch, left:left + cw]
                else:
                    crop = img[top:top + ch, left:left + cw]
                return Resize(self.size)._apply_image(crop)
        return Resize(self.size)._apply_image(img)


class RandomRotation(BaseTransform):
    """Nearest-neighbour rotation about the center (reference
    RandomRotation without the PIL resample modes)."""

    def __init__(self, degrees):
        self.degrees = ((-degrees, degrees)
                        if isinstance(degrees, numbers.Number)
                        else tuple(degrees))

    def _apply_image(self, img):
        import random
        ang = np.deg2rad(random.uniform(*self.degrees))
        chw = img.ndim == 3 and img.shape[0] in (1, 3)
        x = img if chw else (np.moveaxis(img, -1, 0)
                             if img.ndim == 3 else img[None])
        C, H, W = x.shape
        cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
        yy, xx = np.mgrid[0:H, 0:W]
        ys = cy + (yy - cy) * np.cos(ang) - (xx - cx) * np.sin(ang)
        xs = cx + (yy - cy) * np.sin(ang) + (xx - cx) * np.cos(ang)
        yi = np.clip(np.round(ys).astype(int), 0, H - 1)
        xi = np.clip(np.round(xs).astype(int), 0, W - 1)
        valid = (ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1)
        out = x[:, yi, xi] * valid[None]
        out = out.astype(img.dtype)
        if chw:
            return out
        return np.moveaxis(out, 0, -1) if img.ndim == 3 else out[0]


class RandomErasing(BaseTransform):
    """reference: transforms.py RandomErasing — cutout regularizer."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        import random
        if random.random() > self.prob:
            return img
        chw = img.ndim == 3 and img.shape[0] in (1, 3)
        h, w = (img.shape[1:] if chw else img.shape[:2])
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = random.uniform(*self.ratio)
            eh = int(round((target / ar) ** 0.5))
            ew = int(round((target * ar) ** 0.5))
            if eh < h and ew < w:
                top = random.randint(0, h - eh)
                left = random.randint(0, w - ew)
                out = img.copy()
                if chw:
                    out[:, top:top + eh, left:left + ew] = self.value
                else:
                    out[top:top + eh, left:left + ew] = self.value
                return out
        return img


def _to_gray(x):
    ch_axis = 0 if x.shape[0] in (1, 3) else -1
    if x.shape[ch_axis] == 1:
        return x
    wts = np.asarray([0.299, 0.587, 0.114], np.float32)
    shape = [1, 1, 1]
    shape[ch_axis] = 3
    g = (x * wts.reshape(shape)).sum(axis=ch_axis, keepdims=True)
    return np.repeat(g, 3, axis=ch_axis)


def _like(out, img):
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(out, 0, 255).astype(img.dtype)
    return out.astype(img.dtype)
