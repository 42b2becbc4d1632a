"""In-memory patch dataset with foreground oversampling (the port's copy of
``deepwmh_tpu.unet.data``, numpy only).

Cases live as numpy volumes on the host; each training batch is a set of
random patches with a forced-foreground fraction (nnU-Net's 1/3
oversampling rule). The same ``RandomState`` gives the same batches, byte
for byte, as the JAX package's dataset; augmentation runs on the device
(``unet/augment.py``).
"""

from __future__ import annotations

import numpy as np

MAX_FG_COORDS = 10000


class SegDataset:
    def __init__(self, patch_size):
        self.patch_size = tuple(int(p) for p in patch_size)
        self.cases = []

    def add_case(self, name: str, image: np.ndarray, label: np.ndarray):
        """image [D,H,W] float32 (already preprocessed to plan spacing +
        normalized), label [D,H,W] integer."""
        image = np.asarray(image, np.float32)
        label = np.asarray(label, np.uint8)
        if image.shape != label.shape:
            raise ValueError("case %s: image %s and label %s differ in shape"
                             % (name, image.shape, label.shape))
        # pad up to the patch size so any crop is valid
        pads = [(0, max(p - s, 0)) for p, s in zip(self.patch_size, image.shape)]
        if any(p[1] > 0 for p in pads):
            image = np.pad(image, pads)
            label = np.pad(label, pads)
        fg = np.argwhere(label > 0)
        if len(fg) > MAX_FG_COORDS:
            sel = np.random.RandomState(0).choice(len(fg), MAX_FG_COORDS, replace=False)
            fg = fg[sel]
        self.cases.append(
            {"name": name, "image": image, "label": label, "fg": fg.astype(np.int64)}
        )

    def __len__(self):
        return len(self.cases)

    @property
    def names(self):
        return [c["name"] for c in self.cases]

    def _crop(self, case, center=None, rng=None):
        img, lbl = case["image"], case["label"]
        ps = self.patch_size
        starts = []
        for ax in range(3):
            hi = img.shape[ax] - ps[ax]
            if center is None:
                s = int(rng.randint(0, hi + 1))
            else:
                s = int(np.clip(center[ax] - ps[ax] // 2, 0, hi))
            starts.append(s)
        sl = tuple(slice(s, s + p) for s, p in zip(starts, ps))
        return img[sl], lbl[sl]

    def sample_batch(self, rng: np.random.RandomState, batch_size: int, oversample_fg: float = 0.33):
        """Returns (images [N,D,H,W] f32, labels [N,D,H,W] int32). The last
        ceil(oversample_fg * N) samples are centered on a random foreground
        voxel of their case (nnU-Net's oversampling convention)."""
        imgs, lbls = [], []
        n_fg = int(np.ceil(oversample_fg * batch_size))
        for i in range(batch_size):
            case = self.cases[rng.randint(0, len(self.cases))]
            force_fg = i >= batch_size - n_fg
            if force_fg and len(case["fg"]) > 0:
                center = case["fg"][rng.randint(0, len(case["fg"]))]
                im, lb = self._crop(case, center=center)
            else:
                im, lb = self._crop(case, rng=rng)
            imgs.append(im)
            lbls.append(lb)
        return np.stack(imgs), np.stack(lbls).astype(np.int32)
