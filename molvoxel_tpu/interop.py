"""PyTorch interoperability: voxelized grids into torch training loops.

The reference's production backend *is* PyTorch (its voxelizer subclasses
feed torch models directly, /root/reference/molvoxel/voxelizer/torch/
voxelizer.py:13-88), so a migrating user typically keeps a torch model and
dataloader stack.  This module is the bridge:

- ``to_torch(array)`` / ``from_torch(tensor)``: dtype-faithful conversion
  between JAX arrays (including bfloat16 / float8_e4m3fn grids, which numpy
  cannot represent natively — they cross as bit-views) and torch tensors.
  Zero-copy via DLPack when both sides share host memory; device arrays are
  fetched once.
- ``VoxelGridDataset``: a ``torch.utils.data.IterableDataset`` that streams
  a multi-record SDF through the native parser + batching feeder
  (data.feed.SDFBatchFeeder) and the JAX voxelizer, yielding ready
  ``(grids, num_atoms)`` torch batches — the drop-in replacement for a
  precompute-grids-then-Dataset torch pipeline, with the voxelization on
  the accelerator and double-buffered against conversion.

torch is an optional dependency: importing this module without torch raises
only when the torch-requiring entry points are used.
"""

from __future__ import annotations

from collections.abc import Iterator, Sequence
from pathlib import Path

import numpy as np

try:
    import torch

    TORCH_AVAILABLE = True
    _IterableDataset = torch.utils.data.IterableDataset
    _Dataset = torch.utils.data.Dataset
except ImportError:  # pragma: no cover
    torch = None
    TORCH_AVAILABLE = False
    _IterableDataset = object
    _Dataset = object

__all__ = [
    "TORCH_AVAILABLE",
    "to_torch",
    "from_torch",
    "VoxelGridDataset",
    "GridStoreDataset",
]


def _require_torch():
    if not TORCH_AVAILABLE:  # pragma: no cover
        raise ImportError("molvoxel_tpu.interop requires torch")


def to_torch(array):
    """JAX array (or numpy) -> torch.Tensor, preserving dtype.

    float32/int dtypes convert zero-copy when the array already lives in
    host memory (DLPack / ``torch.from_numpy``); bfloat16 and float8_e4m3fn
    have no numpy representation, so they cross as uint16/uint8 bit-views
    reinterpreted on the torch side (bit-exact, no rounding).

    JAX device arrays export as *read-only* numpy views; those are copied
    once here so the returned tensor is writable (torch has no read-only
    tensors — wrapping the view directly would be undefined behavior on
    in-place writes, and warns on every call).
    """
    _require_torch()
    np_arr = np.asarray(array)  # device arrays fetch once; host arrays are views
    if not np_arr.flags.writeable:
        np_arr = np.array(np_arr)
    name = np_arr.dtype.name  # ml_dtypes names: 'bfloat16', 'float8_e4m3fn'
    if name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(np_arr).view(np.uint16)
        ).view(torch.bfloat16)
    if name.startswith("float8_e4m3"):
        t = torch.from_numpy(np.ascontiguousarray(np_arr).view(np.uint8))
        if hasattr(torch, "float8_e4m3fn"):
            return t.view(torch.float8_e4m3fn)
        raise TypeError("this torch build has no float8_e4m3fn dtype")
    return torch.from_numpy(np.ascontiguousarray(np_arr))


def from_torch(tensor) -> np.ndarray:
    """torch.Tensor -> numpy array ready for the feed/batch layer.

    bfloat16/float8 tensors are upcast to float32 (numpy cannot hold them);
    everything else converts dtype-faithfully.  Always detached and on host.
    """
    _require_torch()
    t = tensor.detach().cpu()
    if t.dtype in (torch.bfloat16,) or str(t.dtype).startswith("torch.float8"):
        t = t.float()
    return t.numpy()


class VoxelGridDataset(_IterableDataset):
    """Stream an SDF as voxelized torch batches.

    Each iteration yields ``(grids, num_atoms)``:

    - ``grids``: torch.Tensor (B, C, D, H, W) in ``out_dtype`` — the atom-type
      channel semantics of the reference's `forward_types` path (one channel
      per symbol, optional catch-all via ``unknown``).
    - ``num_atoms``: torch.LongTensor (B,) true atom counts (0 marks padded
      tail slots whose grids are all-zero).

    Use with ``torch.utils.data.DataLoader(ds, batch_size=None)`` — batching
    happens here (fixed-shape device batches), the DataLoader just iterates.
    Voxelization is dispatched asynchronously and double-buffered against
    the previous batch's torch conversion.

    ``augment=True`` applies a fresh random rigid-body rotation (+
    ``random_translation`` Å jitter) per molecule per pass — infinite-epoch
    augmentation without precomputing grids, which the reference cannot do
    (its torch path runs under ``no_grad`` on precomputed tensors).

    ``DataLoader(ds, batch_size=None, num_workers=N)`` is supported: each
    worker reads a disjoint stripe of the file's record shards (the usual
    IterableDataset duplication trap is handled), with per-worker RNG
    streams.  Pass ``multiprocessing_context="spawn"`` alongside
    ``num_workers>0`` — the workers run JAX, which does not survive
    ``fork()`` from a JAX-initialized parent.  ``shuffle=True`` reshuffles
    the shard order every epoch (deterministically from ``seed`` + epoch;
    records within an ~8 MB shard stay in file order — pass
    ``feeder_kwargs={"target_shard_bytes": ...}`` for finer mixing).
    """

    def __init__(
        self,
        path: str | Path,
        symbols: Sequence[str],
        spec=None,
        *,
        batch_size: int = 64,
        unknown: bool = False,
        density_type: str = "gaussian",
        sigma: float = 0.5,
        radii: float = 1.0,
        out_dtype: str = "float32",
        augment: bool = False,
        random_translation: float = 0.0,
        seed: int = 0,
        workers: int = 2,
        shuffle: bool = False,
        feeder_kwargs: dict | None = None,
    ):
        _require_torch()
        from .core.config import GridSpec

        super().__init__()
        self.path = str(path)
        self.symbols = list(symbols)
        self.spec = spec if spec is not None else GridSpec(0.5, 64)
        self.batch_size = batch_size
        self.unknown = unknown
        self.density_type = density_type
        self.sigma = sigma
        self.radii = radii
        self.out_dtype = out_dtype
        self.augment = augment
        self.random_translation = random_translation
        self.seed = seed
        self.workers = workers
        self.shuffle = shuffle
        self.feeder_kwargs = dict(feeder_kwargs or {})
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Set the epoch for shuffle order + augmentation RNG.

        Required with ``DataLoader(num_workers>0)`` (call before each epoch,
        like ``DistributedSampler.set_epoch``); single-process iteration
        advances the epoch automatically."""
        self._epoch = int(epoch)

    def _feeder(self, worker_id: int = 0, num_workers: int = 1, epoch: int = 0):
        from .data.feed import SDFBatchFeeder

        return SDFBatchFeeder(
            self.path,
            self.symbols,
            batch_size=self.batch_size,
            unknown=self.unknown,
            workers=self.workers,
            shuffle_seed=self.seed + epoch if self.shuffle else None,
            span_offset=worker_id,
            span_stride=num_workers,
            **self.feeder_kwargs,
        )

    def __iter__(self) -> Iterator[tuple]:
        from .parallel.stream import StreamingVoxelizer

        info = torch.utils.data.get_worker_info()
        worker_id = info.id if info is not None else 0
        num_workers = info.num_workers if info is not None else 1
        epoch = self._epoch
        if info is None:
            # single-process: each pass is a new epoch automatically.  With
            # num_workers>0 the parent never runs __iter__, so worker copies
            # would restart at the pickled epoch every time — call
            # ``ds.set_epoch(e)`` in the training loop instead (the
            # DistributedSampler convention).
            self._epoch += 1

        sv = StreamingVoxelizer(
            self.spec,
            batch_size=self.batch_size,
            density_type=self.density_type,
            sigma=self.sigma,
            radii=self.radii,
            random_rotation=self.augment,
            random_translation=self.random_translation if self.augment else 0.0,
            out_dtype=self.out_dtype,
            seed=self.seed + 1000003 * worker_id + epoch,
        )
        import jax.numpy as jnp

        from .data.feed import prefetch_iter

        radii_dev = None
        pending = None
        # prefetch: parse/assembly runs one batch ahead on a worker thread,
        # overlapping the device dispatch + torch conversion below
        for batch in prefetch_iter(iter(self._feeder(worker_id, num_workers, epoch))):
            if radii_dev is None or radii_dev.shape[0] != batch.padded_atoms:
                radii_dev = jnp.full((batch.padded_atoms,), float(self.radii), jnp.float32)
            images = sv._dispatch(batch, radii_dev)  # async on-device
            if pending is not None:
                yield self._emit(*pending)
            pending = (images, batch)
        if pending is not None:
            yield self._emit(*pending)

    def _emit(self, images, batch):
        return to_torch(images), torch.from_numpy(batch.num_atoms.astype(np.int64))


class GridStoreDataset(_Dataset):
    """Map-style torch Dataset over a precomputed grid store.

    The precompute-then-train workflow (the reference's primary pattern,
    with ``voxelize -o store/`` as the precompute step): random access into
    mmap'd shards, so a shuffling DataLoader works out of the box and only
    the touched grids page in.

    Each item is ``(grid, num_atoms)``; bf16 shards cross as bit-views.
    """

    def __init__(self, root):
        _require_torch()
        from .data.gridstore import GridShardReader

        self.reader = GridShardReader(root)
        self._num_atoms = self.reader.num_atoms()

    def __len__(self) -> int:
        return len(self.reader)

    def __getitem__(self, i: int):
        return to_torch(self.reader[i]), int(self._num_atoms[i])

    @property
    def channels(self):
        return self.reader.channels
