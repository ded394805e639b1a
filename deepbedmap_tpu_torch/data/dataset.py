"""Training-tile dataset: the X/W1/W2/W3/Y array contract.

Counterpart of ``deepbedmap_tpu/data/dataset.py``. The reference saves five
.npy arrays (data_prep.py:925-930) and trains on them with a 95/5 split at
seed 42 and shuffled minibatches of 128 (srgan_train.py:87-166). The whole
dataset, a few hundred MB at the reference's scale, lives on one device as
NHWC tensors; an epoch gathers its minibatches there by index, so no step
copies from the host.

``content_hash``, ``train_dev_split`` and ``epoch_batches`` are JAX's, with
the same numpy ``RandomState`` calls, so the index batches equal JAX's bit for
bit. As in JAX the last partial minibatch of an epoch is dropped (the
reference tops it up from the next epoch): 28 x 128 = 3584 of 3634 reference
train tiles per epoch. ``from_package`` restores the arrays from a
content-addressed package (``data/packaging.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepbedmap_tpu_torch.device import resolve_device

ARRAY_KEYS = ("X", "W1", "W2", "W3", "Y")

# reference-contract NCHW channel / shape suffixes per tile (data_prep.py:745-930)
REFERENCE_SHAPES_NCHW = {
    "X": (1, 11, 11),
    "W1": (1, 110, 110),
    "W2": (2, 22, 22),
    "W3": (1, 11, 11),
    "Y": (1, 36, 36),
}


@dataclasses.dataclass
class TileDataset:
    """NHWC float32 tile tensors on one device, sharing the leading tile axis."""

    arrays: Dict[str, torch.Tensor]

    def __post_init__(self):
        lengths = {k: v.shape[0] for k, v in self.arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"ragged dataset: {lengths}")

    def __len__(self) -> int:
        return next(iter(self.arrays.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.arrays.values())).device

    @classmethod
    def from_nchw(cls, arrays: Dict[str, np.ndarray], device="cuda") -> "TileDataset":
        """From reference-layout (N, C, H, W) arrays, onto ``device`` (the
        card unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        converted = {}
        for key in ARRAY_KEYS:
            a = np.asarray(arrays[key], np.float32)
            if a.ndim != 4:
                raise ValueError(f"{key} must be (N, C, H, W), got {a.shape}")
            converted[key] = torch.from_numpy(
                np.ascontiguousarray(a.transpose(0, 2, 3, 1))).to(dev)
        return cls(converted)

    @classmethod
    def load_npy_dir(
        cls, directory: str, expected_hash: Optional[str] = None, device="cuda",
        suffix: str = "",
    ) -> "TileDataset":
        """Load X.npy, W1.npy, ... from a directory (the model/train layout;
        ``suffix="_data"`` reads the X_data.npy, ... that ``build`` writes).
        ``expected_hash`` pins the content (the reference pins a quilt hash,
        srgan_train.py:89); a mismatch raises."""
        arrays = {k: np.load(os.path.join(directory, f"{k}{suffix}.npy"))
                  for k in ARRAY_KEYS}
        if expected_hash is not None:
            actual = content_hash(arrays)
            if actual != expected_hash:
                raise ValueError(f"dataset hash mismatch: {actual} != {expected_hash}")
        return cls.from_nchw(arrays, device)

    def save_npy_dir(self, directory: str) -> str:
        """Write the reference NCHW npy contract; returns the content hash."""
        os.makedirs(directory, exist_ok=True)
        arrays = {}
        for k in ARRAY_KEYS:
            a = self.arrays[k].cpu().numpy().transpose(0, 3, 1, 2)
            np.save(os.path.join(directory, f"{k}.npy"), a)
            arrays[k] = a
        return content_hash(arrays)

    @classmethod
    def from_package(cls, registry: str, name: str = "deepbedmap/model/train",
                     pkg_hash: Optional[str] = None, device="cuda") -> "TileDataset":
        """Restore the training arrays from a content-addressed package
        (the reference's quilt.load-by-hash path, srgan_train.py:87-125) onto
        ``device``; every blob's sha256 is verified on the way out."""
        from deepbedmap_tpu_torch.data.packaging import load_arrays

        loaded = load_arrays(registry, name, pkg_hash)
        return cls.from_nchw({k: loaded[f"{k}_data"] for k in ARRAY_KEYS}, device)

    @classmethod
    def synthetic(cls, n: int, seed: int = 0, device="cuda") -> "TileDataset":
        """Uniform random tiles of the reference shapes (JAX's numbers for
        the same seed)."""
        rs = np.random.RandomState(seed)
        arrays = {
            k: rs.rand(n, *REFERENCE_SHAPES_NCHW[k]).astype(np.float32)
            for k in ARRAY_KEYS
        }
        return cls.from_nchw(arrays, device)

    def take(self, indices) -> Dict[str, torch.Tensor]:
        """Gather a minibatch by index (an integer array or tensor) on the
        dataset's device."""
        idx = torch.as_tensor(indices, dtype=torch.long, device=self.device)
        return {k: v.index_select(0, idx) for k, v in self.arrays.items()}


def content_hash(arrays: Dict[str, np.ndarray]) -> str:
    """Deterministic sha256 of the dataset content (JAX's)."""
    digest = hashlib.sha256()
    for key in ARRAY_KEYS:
        a = np.ascontiguousarray(arrays[key])
        digest.update(key.encode())
        digest.update(str(a.shape).encode())
        digest.update(a.tobytes())
    return digest.hexdigest()


def train_dev_split(
    n: int, train_fraction: float = 0.95, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """Random 95/5 index split, seed 42 (srgan_train.py:132-151)."""
    rs = np.random.RandomState(seed)
    perm = rs.permutation(n)
    n_train = int(n * train_fraction)
    return perm[:n_train], perm[n_train:]


def epoch_batches(
    indices: np.ndarray, batch_size: int, rs: np.random.RandomState
) -> np.ndarray:
    """Shuffled (num_batches, batch_size) index matrix; the last partial
    batch is dropped."""
    shuffled = rs.permutation(indices)
    n_batches = len(shuffled) // batch_size
    if n_batches == 0:
        raise ValueError(
            f"dataset split of {len(indices)} tiles smaller than one batch "
            f"({batch_size}); lower batch_size"
        )
    return shuffled[: n_batches * batch_size].reshape(n_batches, batch_size)
