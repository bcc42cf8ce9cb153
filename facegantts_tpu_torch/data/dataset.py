"""Dataset and input pipeline of the PyTorch port.

A copy of the JAX package's ``data/dataset.py`` (the port imports nothing of
that package): the packed shards written offline by the JAX package's
``preprocess.py`` are read as they are, padded to static buckets and
prefetched on a background thread.  Batches stay numpy arrays here; the
train step moves them to the device.

Batch schema: {x, x_len, y, y_len, spk} (reference lrs2_dataset.py:280-286),
with mel lengths padded to a multiple of 4 for the U-Net
(fix_len_compatibility, lrs2_dataset.py:252).
"""

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from facegantts_tpu_torch.config import Config
from facegantts_tpu_torch.ops.align import fix_len_compatibility
from facegantts_tpu_torch.train.state import Batch


#: member arrays of one packed shard
SHARD_MEMBERS = ("text_flat", "text_offsets", "mel_flat", "mel_offsets",
                 "faces", "spk_ids")


def _open_shard(path: str) -> Dict[str, np.ndarray]:
    """One shard -> {member: array}.

    Two on-disk formats:
    - ``<stem>/`` directory of raw ``<member>.npy`` files (the default
      written by preprocess.py): opened with ``mmap_mode='r'`` — random
      item access touches only the pages it reads, nothing is decompressed,
      and the OS page cache is shared across loader epochs/processes.
    - legacy ``.npz``: numpy's NpzFile DECOMPRESSES THE WHOLE MEMBER ON
      EVERY ``[]`` ACCESS (no caching), which turns per-item reads into
      per-item full-shard inflations — so materialize each member exactly
      once here."""
    if os.path.isdir(path):
        return {
            m: np.load(os.path.join(path, f"{m}.npy"), mmap_mode="r")
            for m in SHARD_MEMBERS
        }
    with np.load(path, allow_pickle=False) as z:
        return {m: z[m] for m in SHARD_MEMBERS}


class PackedDataset:
    """Reads preprocessed shards written by preprocess.py.

    Shard members: text_flat/text_offsets (ragged int32), mel_flat
    (n_mels, total_frames) float16/32 + mel_offsets, faces (N, 224, 224, 3)
    uint8 BGR, spk_ids (N,) int32.  See :func:`_open_shard` for the raw
    (mmap) vs legacy (.npz) formats."""

    def __init__(self, shard_paths: Sequence[str], n_mels: int = 128):
        self.shards = [_open_shard(p) for p in shard_paths]
        self.n_mels = n_mels
        self.index: List[tuple] = []  # (shard_idx, item_idx)
        for si, sh in enumerate(self.shards):
            n = len(sh["spk_ids"])
            self.index += [(si, i) for i in range(n)]

    def __len__(self):
        return len(self.index)

    def lengths(self):
        """(text_len, mel_len) per item — used for bucketing.  Vectorized
        per shard (self.index is shard-major sequential)."""
        out: List[tuple] = []
        for sh in self.shards:
            tl = np.diff(np.asarray(sh["text_offsets"]))
            ml = np.diff(np.asarray(sh["mel_offsets"]))
            out += list(zip(tl.tolist(), ml.tolist()))
        return out

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        si, i = self.index[idx]
        sh = self.shards[si]
        to, mo = sh["text_offsets"], sh["mel_offsets"]
        return {
            "x": sh["text_flat"][to[i] : to[i + 1]].astype(np.int32),
            "y": sh["mel_flat"][:, mo[i] : mo[i + 1]].astype(np.float32),
            "spk": sh["faces"][i].astype(np.float32),
            "spk_id": int(sh["spk_ids"][i]),
        }


class SyntheticDataset:
    """LRS2-shaped random data: benchmarking and tests without the corpus.

    Mimics the reference distribution: text 30..180 interspersed symbols, mel
    90..870 frames (1.3s minimum clip per lrs2 filtering), 224x224 faces."""

    def __init__(self, n_items: int = 512, n_mels: int = 128, seed: int = 0,
                 min_frames: int = 90, max_frames: int = 560,
                 spk_mode: str = "face"):
        rng = np.random.default_rng(seed)
        self.n_mels = n_mels
        self._tlen = rng.integers(30, 180, n_items)
        self._mlen = rng.integers(min_frames, max_frames, n_items)
        self._seed = seed
        self.spk_mode = spk_mode  # "face" (224x224x3) | "speech" (mel clip)

    def __len__(self):
        return len(self._tlen)

    def lengths(self):
        return list(zip(self._tlen.tolist(), self._mlen.tolist()))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self._seed * 100003 + idx)
        if self.spk_mode == "speech":
            spk = (rng.standard_normal((self.n_mels, self._mlen[idx])) - 5.0)
        else:
            spk = rng.integers(0, 255, (224, 224, 3))
        return {
            "x": rng.integers(1, 148, self._tlen[idx]).astype(np.int32),
            "y": (rng.standard_normal((self.n_mels, self._mlen[idx])) - 5.0).astype(np.float32),
            "spk": spk.astype(np.float32),
            "spk_id": int(rng.integers(0, 100)),
        }


def collate(items: List[Dict[str, np.ndarray]], tx_bucket: int, ty_bucket: int) -> Batch:
    """Zero-pad to static buckets (TextMelVideoBatchCollate parity,
    lrs2_dataset.py:248-286)."""
    b = len(items)
    n_mels = items[0]["y"].shape[0]
    x = np.zeros((b, tx_bucket), np.int32)
    y = np.zeros((b, n_mels, ty_bucket), np.float32)
    # spk carries the conditioning input: a 224x224x3 face frame (spk_emb=
    # face, the reference's lrs2_dataset.py:188-244 video frame) or a 2-D
    # (n_mels, T) mel clip (spk_emb=speech, reference face_tts.py:108-114),
    # zero-padded to the same static ty bucket as y
    if items[0]["spk"].ndim == 2:
        spk = np.zeros((b, n_mels, ty_bucket), np.float32)
    else:
        spk = np.zeros((b, 224, 224, 3), np.float32)
    x_len = np.zeros(b, np.int32)
    y_len = np.zeros(b, np.int32)
    for i, it in enumerate(items):
        tl = min(len(it["x"]), tx_bucket)
        ml = min(it["y"].shape[1], ty_bucket)
        x[i, :tl] = it["x"][:tl]
        y[i, :, :ml] = it["y"][:, :ml]
        if it["spk"].ndim == 2:
            sl = min(it["spk"].shape[1], ty_bucket)
            spk[i, :, :sl] = it["spk"][:, :sl]
        else:
            spk[i] = it["spk"]
        x_len[i], y_len[i] = tl, ml
    # host (numpy) leaves: the train step moves the batch to the device;
    # collate runs on the loader's prefetch thread
    return Batch(x=x, x_len=x_len, y=y, y_len=y_len, spk=spk)


def _rank_and_world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class BucketedLoader:
    """Length-bucketed batcher with background prefetch.

    Groups items whose (text, mel) lengths fall in the same static bucket
    pair so every batch has one of a small set of shapes — each shape
    compiles once.  Shuffles within buckets each epoch."""

    def __init__(
        self,
        dataset,
        cfg: Config,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        """``batch_size`` is GLOBAL.  With several processes each builds
        the identical epoch plan (same seed) but loads/collates ONLY its
        contiguous row block -- batch_size/process_count items per process.
        The process index and count default to the ``torch.distributed``
        rank and world size when it is initialised, else 0 and 1."""
        self.ds = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        if process_index is None:
            process_index, process_count = _rank_and_world()
        self.process_index = process_index
        self.process_count = process_count or 1
        if self.process_count > 1:
            if batch_size % self.process_count:
                raise ValueError(
                    f"global batch {batch_size} not divisible by "
                    f"process_count {self.process_count}")
            if not drop_last:
                raise ValueError("multi-host loading requires drop_last "
                                 "(ragged final batches cannot be split "
                                 "evenly across processes)")

        self.buckets: Dict[tuple, List[int]] = {}
        for i, (tl, ml) in enumerate(dataset.lengths()):
            tb = self._pick(tl, cfg.text_buckets)
            mb = fix_len_compatibility(self._pick(ml, cfg.mel_buckets))
            self.buckets.setdefault((tb, mb), []).append(i)

    @staticmethod
    def _pick(n: int, buckets: Sequence[int]) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def _epoch_plan(self, epoch: int) -> List[tuple]:
        rng = np.random.default_rng(self.seed + epoch)
        plan = []
        for key, idxs in self.buckets.items():
            idxs = list(idxs)
            if self.shuffle:
                rng.shuffle(idxs)
            for s in range(0, len(idxs), self.batch_size):
                chunk = idxs[s : s + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                plan.append((key, chunk))
        if self.shuffle:
            rng.shuffle(plan)
        return plan

    def __len__(self):
        return len(self._epoch_plan(0))

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        plan = self._epoch_plan(epoch)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        local = self.batch_size // self.process_count

        def worker():
            for (tb, mb), chunk in plan:
                # this process's contiguous row block of the global batch
                rows = chunk[self.process_index * local:
                             (self.process_index + 1) * local]
                items = [self.ds[i] for i in rows]
                q.put(collate(items, tb, mb))
            q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item


def load_packed(cfg: Config, split: str) -> Optional[PackedDataset]:
    """Find packed shards for a split under cfg.packed_data_dir."""
    root = cfg.packed_data_dir
    if not root:
        return None
    paths = sorted(
        os.path.join(root, f)
        for f in os.listdir(root)
        if f.startswith(f"{split}_")
        and (f.endswith(".npz")                      # legacy compressed
             or os.path.isdir(os.path.join(root, f)))  # raw mmap shards
    )
    if not paths:
        return None
    return PackedDataset(paths, n_mels=cfg.n_mels)


# Registry parity with reference data/__init__.py:4-6
_datasets = {"dataset_lrs2": load_packed}
