"""Train-state containers of the PyTorch port (the JAX package's
``train/state.py``)."""

from dataclasses import dataclass, fields
from typing import Any

import numpy as np
import torch


@dataclass
class Batch:
    """One training batch (schema of reference data/lrs2_dataset.py:280-286).

    x:      (B, T_x)  int32 interspersed symbol ids
    x_len:  (B,)      int32
    y:      (B, n_feats, T_y) float32 log-mel
    y_len:  (B,)      int32
    spk:    (B, 224, 224, 3) float32 face frames, or (B, n_feats, T_y) mel
            clips with ``spk_emb="speech"``

    The loader yields numpy arrays; :meth:`to` moves them to a device."""

    x: Any
    x_len: Any
    y: Any
    y_len: Any
    spk: Any

    def to(self, device) -> "Batch":
        def move(a):
            t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            return t.to(device, non_blocking=True)

        return Batch(**{f.name: move(getattr(self, f.name)) for f in fields(self)})


@dataclass
class TrainState:
    """The generator, its optimizer and the number of steps taken.

    ``model`` holds the parameters and the SyncNet BatchNorm running
    statistics (the JAX ``params`` and ``model_state``); ``optimizer`` is a
    :class:`facegantts_tpu_torch.train.optim.GeneratorOptimizer`."""

    step: int
    model: torch.nn.Module
    optimizer: Any
