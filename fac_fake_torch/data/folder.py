"""Crop-folder dataset (the ImageFolder equivalent) — the port of
`fac_fake_tpu/data/folder.py`.

``{split}/{fake,real}`` folders of face crops (`CViT-main/helpers/loader.py`)
as a host iterator of uint8 batches: JPEG decode on a thread pool (the
native decoder, `data/native_loader.py`, where it builds; else cv2, imported
only when an image is loaded), a deterministic shuffle an epoch, static
batch shapes (drop_last for training; eval's last batch zero-padded and
masked). Classes in alphabetical order, as ImageFolder: label 0 = fake,
1 = real. Augmentation runs on the device in the train step
(`data/augment.py`), not here.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


class CropFolderDataset:
    def __init__(self, root: str, image_size: int = 224, use_native: Optional[bool] = None):
        self.root = root
        self.image_size = image_size
        self.classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.samples: List[Tuple[str, int]] = []
        for label, cls in enumerate(self.classes):
            cdir = os.path.join(root, cls)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(IMG_EXTS):
                    self.samples.append((os.path.join(cdir, f), label))
        if use_native is None:       # the native decoder reads JPEG only
            from fac_fake_torch.data import native_loader
            use_native = native_loader.available() and all(
                p.lower().endswith((".jpg", ".jpeg")) for p, _ in self.samples[:64])
        self.use_native = use_native

    def __len__(self):
        return len(self.samples)

    def _load(self, path: str) -> np.ndarray:
        import cv2
        img = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        if img.shape[:2] != (self.image_size, self.image_size):
            img = cv2.resize(img, (self.image_size, self.image_size),
                             interpolation=cv2.INTER_AREA)
        return img

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0, epoch: int = 0,
                drop_last: bool = True, num_workers: int = 4) -> Iterator[Dict[str, np.ndarray]]:
        """Yield {'image': uint8 (B, H, W, 3), 'label': int32 (B,), 'mask':
        float32 (B,)}; the epoch folds into the shuffle seed."""
        order = np.arange(len(self.samples))
        if shuffle:
            np.random.RandomState(seed + epoch).shuffle(order)
        n = len(order)
        stops = range(0, n - batch_size + 1, batch_size) if drop_last else range(0, n, batch_size)
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            for start in stops:
                idxs = order[start:start + batch_size]
                if self.use_native:
                    from fac_fake_torch.data import native_loader
                    arr, ok = native_loader.decode_batch(
                        [self.samples[i][0] for i in idxs], self.image_size, threads=num_workers)
                    imgs = [arr[k] if ok[k] else self._load(self.samples[i][0])
                            for k, i in enumerate(idxs)]
                else:
                    imgs = list(pool.map(lambda i: self._load(self.samples[i][0]), idxs))
                labels = np.array([self.samples[i][1] for i in idxs], np.int32)
                mask = np.ones(batch_size, np.float32)
                if len(idxs) < batch_size:     # eval tail: pad and mask
                    pad = batch_size - len(idxs)
                    imgs += [np.zeros_like(imgs[0])] * pad
                    labels = np.concatenate([labels, np.zeros(pad, np.int32)])
                    mask[len(idxs):] = 0.0
                yield {"image": np.stack(imgs), "label": labels, "mask": mask}


def build_session(root_dir: str, image_size: int = 224) -> Dict[str, CropFolderDataset]:
    """The train, validation and test splits under ``root_dir``
    (`helpers/loader.py:41-53`); a split without a folder is left out."""
    return {split: CropFolderDataset(os.path.join(root_dir, split), image_size)
            for split in ("train", "validation", "test")
            if os.path.isdir(os.path.join(root_dir, split))}
