"""Training loop of the PyTorch port: the core of the JAX package's
``train/loop.py`` for the plain (no-GAN) step on one device.

Packed data (or synthetic data when there is none), the bucketed loader,
:func:`make_plain_train_step`, JSONL metrics, the divergence watchdog and a
validation pass at the end of every epoch.  Not ported yet, and so not run:
checkpointing (``save_step``, top-k), early stopping, in-training evaluation
(``eval_interval``), graceful shutdown on SIGTERM and the GAN step;
``use_gan=1`` and ``resume_from`` raise.
"""

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from facegantts_tpu_torch.config import Config
from facegantts_tpu_torch.data.dataset import BucketedLoader, SyntheticDataset, load_packed
from facegantts_tpu_torch.synthesis import resolve_device
from facegantts_tpu_torch.train.state import TrainState
from facegantts_tpu_torch.train.step import init_state, make_plain_train_step


class MetricLogger:
    """JSONL metrics, one record per logged step (the JAX package's
    ``MetricLogger`` without its TensorBoard mirror)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "train"):
        rec = {"step": step, **{f"{prefix}/{k}": float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class DivergenceWatchdog:
    """A run whose logged losses are non-finite for ``patience`` consecutive
    logged steps is diverged; the loop halts instead of burning the rest of
    the budget."""

    def __init__(self, patience: int = 10):
        self.patience = patience
        self.streak = 0

    def update(self, metrics) -> bool:
        vals = [float(v) for v in metrics.values()]
        if vals and not all(np.isfinite(v) for v in vals):
            self.streak += 1
        else:
            self.streak = 0
        return self.streak >= self.patience


def _validate(state, val_step, val_loader, generator, logger, step, epoch):
    vals = []
    for vb in val_loader.epoch(0):
        vals.append({k: float(v) for k, v in val_step(state, vb, generator).items()})
    if not vals:
        print(f"[WARN] epoch {epoch}: validation produced 0 batches -- val set too "
              f"small for the batch size per bucket; no val metrics this epoch")
        return
    avg = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
    avg["batches"] = len(vals)
    logger.log(step, avg, prefix="val")
    print(f"[epoch {epoch}] val " + " ".join(f"{k}={v:.4f}" for k, v in avg.items()))


def train(cfg: Config, work_dir: str = "runs/default", max_steps: Optional[int] = None,
          train_ds=None, val_ds=None, device=None) -> TrainState:
    """Train until ``max_steps``; returns the final :class:`TrainState`.

    ``device=None`` is the GPU (raises without one); pass ``"cpu"`` to run
    on the CPU.  ``train_ds``/``val_ds`` default to the packed corpus under
    ``cfg.packed_data_dir``, falling back to synthetic data.  Metrics go to
    ``<work_dir>/metrics.jsonl``."""
    if cfg.use_gan:
        raise NotImplementedError(
            "use_gan=1: the GAN training step is not ported yet (it comes with the "
            "GAN slice of the port); pass use_gan=0 for the plain FaceTTS step")
    if cfg.resume_from:
        raise NotImplementedError(
            f"resume_from={cfg.resume_from!r}: warm starts and checkpoints are not "
            "ported yet")
    device = resolve_device(device)
    max_steps = max_steps or cfg.max_steps
    print("[INFO] not ported yet, so not run: checkpointing (save_step), early "
          "stopping, in-training evaluation (eval_interval), graceful shutdown")

    if train_ds is None:
        train_ds = load_packed(cfg, "train") or SyntheticDataset(n_items=256, n_mels=cfg.n_mels)
    if val_ds is None:
        val_ds = load_packed(cfg, "val") or SyntheticDataset(n_items=32, n_mels=cfg.n_mels, seed=1)
    batch = cfg.per_gpu_batchsize  # one device: the global batch is the per-device one
    loader = BucketedLoader(train_ds, cfg, batch)
    val_loader = BucketedLoader(val_ds, cfg, max(1, min(batch, len(val_ds))), shuffle=False)
    if len(loader) == 0:
        raise ValueError(f"the training set gives no full batch of {batch} in any bucket")

    logger = MetricLogger(work_dir)
    watchdog = DivergenceWatchdog()
    forked = []
    if device.type == "cuda":
        forked = [device.index if device.index is not None else torch.cuda.current_device()]
    with torch.random.fork_rng(devices=forked):
        torch.manual_seed(cfg.seed)  # dropout
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        state = init_state(cfg, device)
        train_step, val_step = make_plain_train_step(cfg, device)
        step, epoch = state.step, 0
        t_last, n_last = time.time(), step
        while step < max_steps:
            for b in loader.epoch(epoch):
                state, metrics = train_step(state, b, generator)
                step += 1
                if step % cfg.log_every_n_steps == 0 or step == 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    if watchdog.update(m):
                        print(f"[FATAL] losses non-finite for {watchdog.patience} "
                              f"consecutive logged steps; halting at step {step}")
                        logger.close()
                        return state
                    dt = time.time() - t_last
                    m["steps_per_sec"] = (step - n_last) / max(dt, 1e-9)
                    t_last, n_last = time.time(), step
                    logger.log(step, m)
                    print(f"[step {step}] " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
                if step >= max_steps:
                    break
            _validate(state, val_step, val_loader, generator, logger, step, epoch)
            epoch += 1
    logger.close()
    return state
