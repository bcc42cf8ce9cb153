"""Training loop of the PyTorch port: the JAX package's ``train/loop.py``
on one device.

Packed data (or synthetic data when there is none), the bucketed loader,
the GAN step (``use_gan=1``, :func:`make_gan_train_step`, with the switches
of :func:`gan_flags`) or the plain step (:func:`make_plain_train_step`),
JSONL metrics (mirrored to TensorBoard where it is installed), the
divergence watchdog, a validation pass at the end of every epoch, the
checkpoint policy (``save_step``, top-k on ``checkpoint_monitor``, epoch
snapshots, the best copy), early stopping, a clean checkpoint-and-return on
SIGTERM / SIGINT, and ``resume_from``: a port checkpoint directory resumes,
a reference FaceTTS file warm-starts the generator.  As in the JAX loop, a
resumed run draws its noise and dropout from ``cfg.seed`` again and starts
epoch ``step // len(loader)`` from its first batch.

In-training evaluation: with a non-zero ``eval_interval`` the loop builds an
:class:`IntrainEvaluator` once (its backend provenance goes into
``metrics.jsonl``) and every ``eval_interval`` steps synthesizes validation
items with the live weights, logs ``eval/*``, mirrors each sample to
TensorBoard and, when ``checkpoint_monitor`` is one of the evaluation's
keys ("Composite Metric"), ranks a checkpoint on it.

Profiling: with ``profile_dir`` set, steps ``profile_start_step`` to
``profile_start_step + profile_num_steps`` are traced by ``torch.profiler``
(``utils/profiling.py``) into a TensorBoard / Chrome trace under it, with
the step, validation and checkpoint spans annotated.
"""

import json
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from facegantts_tpu_torch.config import Config
from facegantts_tpu_torch.data.dataset import BucketedLoader, SyntheticDataset, load_packed
from facegantts_tpu_torch.synthesis import resolve_device
from facegantts_tpu_torch.train import checkpoint as ck
from facegantts_tpu_torch.train.state import TrainState
from facegantts_tpu_torch.train.step import (
    check_ported,
    init_state,
    make_gan_train_step,
    make_plain_train_step,
)
from facegantts_tpu_torch.utils.profiling import StepProfiler, annotate


class MetricLogger:
    """JSONL metrics, one record per logged step, and TensorBoard scalars
    where ``torch.utils.tensorboard`` imports (the JAX package's
    ``MetricLogger``)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir)
        except ImportError:  # tensorboard is optional
            pass

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "train"):
        rec = {"step": step, **{f"{prefix}/{k}": float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.tb:
            for k, v in metrics.items():
                self.tb.add_scalar(f"{prefix}/{k}", float(v), step)

    def log_audio(self, step: int, tag: str, wav, sample_rate: int):
        """A waveform to TensorBoard (the reference's add_audio walk)."""
        if self.tb:
            self.tb.add_audio(tag, torch.as_tensor(wav).reshape(1, -1), step,
                              sample_rate=sample_rate)

    def write(self, record: Dict) -> None:
        """One JSON record as it is (no step, no prefix)."""
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
        if self.tb:
            self.tb.close()


class EarlyStopping:
    """Patience-based stop on a monitored value (reference train.py:75-81)."""

    def __init__(self, patience: int, min_delta: float):
        self.patience, self.min_delta = patience, min_delta
        self.best = float("inf")
        self.bad = 0

    def update(self, value: float) -> bool:
        if value < self.best - self.min_delta:
            self.best, self.bad = value, 0
        else:
            self.bad += 1
        return self.bad > self.patience


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


class GracefulShutdown:
    """SIGTERM / SIGINT set a flag; the loop checkpoints at the next step
    boundary and returns, so a preempted run resumes from its last step."""

    def __init__(self):
        self.requested = False
        self._old = {}

    def _handle(self, signum, frame):
        self.requested = True

    def install(self) -> "GracefulShutdown":
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old[sig] = signal.signal(sig, self._handle)
            except ValueError:  # not the main thread
                break
        return self

    def restore(self) -> None:
        for sig, old in self._old.items():
            signal.signal(sig, old)
        self._old = {}


def warm_start(cfg: Config, state: TrainState) -> TrainState:
    """``cfg.resume_from``: a port checkpoint directory restores the model,
    the discriminator, both optimizers and the step; a reference FaceTTS
    ``.pt``/``.ckpt`` loads the generator by name and shape
    (:func:`checkpoint.merge_state_dict`); a missing path trains from
    scratch."""
    path = cfg.resume_from
    if not path:
        return state
    if os.path.isdir(path):
        ck.restore_checkpoint(path, state)  # in place; a directory without steps: as it was
        return state
    if not os.path.exists(path):
        print(f"[INFO] resume_from {path} not found; training from scratch")
        return state
    print(f"[INFO] warm-starting generator from {path}")
    ck.merge_state_dict(state.model, ck.load_facetts_state_dict(path))
    return state


def gan_flags(cfg: Config, epoch: int, step: int) -> Dict[str, bool]:
    """The GAN step's switches at ``epoch`` for the update after ``step``
    updates (the JAX loop's): D trains from ``warmup_disc_epochs``, G from
    ``freeze_gen_epochs``, and R1 applies from ``r1_start_epoch`` on every
    ``r1_interval``-th step (lazy R1)."""
    return {
        "train_disc": epoch >= cfg.warmup_disc_epochs,
        "train_gen": epoch >= cfg.freeze_gen_epochs,
        "use_r1": bool(cfg.use_r1_penalty) and epoch >= cfg.r1_start_epoch
        and step % max(1, cfg.r1_interval) == 0,
    }


def _validate(state, val_step, val_loader, generator, logger, step, epoch, **kw):
    """Mean validation metrics, logged; None when the loader gave no batch."""
    vals = []
    for vb in val_loader.epoch(0):
        vals.append({k: float(v) for k, v in val_step(state, vb, generator, **kw).items()})
    if not vals:
        print(f"[WARN] epoch {epoch}: validation produced 0 batches -- val set too "
              f"small for the batch size per bucket; no val metrics or ranked "
              f"checkpoints this epoch")
        return None
    avg = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
    avg["batches"] = len(vals)
    logger.log(step, avg, prefix="val")
    print(f"[epoch {epoch}] val " + " ".join(f"{k}={v:.4f}" for k, v in avg.items()))
    return avg


def _evaluate(evaluator, state, step, epoch, work_dir, logger, policy) -> Dict[str, float]:
    """One in-training evaluation: ``eval/*`` logged, each sample mirrored
    to TensorBoard (the reference walks the wav directory into add_audio,
    custom_callbacks.py:44-55), and with an evaluation metric as the monitor
    a ranked checkpoint without a snapshot (the reference's StepwiseEval
    ranked retention, custom_callbacks.py:57-92)."""
    from facegantts_tpu_torch.utils.audio import load_wav

    results = evaluator.run(state, step)
    logger.log(step, results, prefix="eval")
    step_dir = os.path.join(work_dir, "inference", f"step_{step:08d}")
    for i in range(int(results.get("Samples", 0))):
        wav_path = os.path.join(step_dir, f"sample_{i}.wav")
        if os.path.exists(wav_path):
            wav, sr = load_wav(wav_path)
            logger.log_audio(step, f"eval/sample_{i}", wav, sr)
    print(f"[eval step {step}] " + " ".join(f"{k}={v:.4f}" for k, v in results.items()))
    if policy.monitor in results:
        policy.save_epoch(state, step, epoch, results, with_snapshot=False)
    return results


def train(cfg: Config, work_dir: str = "runs/default", max_steps: Optional[int] = None,
          train_ds=None, val_ds=None, device=None) -> TrainState:
    """Train until ``max_steps``; returns the final :class:`TrainState`.

    ``device=None`` is the GPU (raises without one); pass ``"cpu"`` to run
    on the CPU.  ``train_ds``/``val_ds`` default to the packed corpus under
    ``cfg.packed_data_dir``, falling back to synthetic data.  Metrics go to
    ``<work_dir>/metrics.jsonl``, checkpoints under ``work_dir`` (see
    :class:`checkpoint.CheckpointPolicy`)."""
    check_ported(cfg)
    device = resolve_device(device)
    # from the start: a SIGTERM during set-up still ends in a clean exit
    shutdown = GracefulShutdown().install()
    try:
        return _train(cfg, work_dir, max_steps or cfg.max_steps, train_ds, val_ds, device,
                      shutdown)
    finally:
        shutdown.restore()


def _train(cfg, work_dir, max_steps, train_ds, val_ds, device, shutdown) -> TrainState:
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
    policy = ck.CheckpointPolicy(work_dir, keep_top_k=cfg.keep_top_k,
                                 monitor=cfg.checkpoint_monitor,
                                 snapshot_epochs=cfg.snapshot_epochs)
    stopper = EarlyStopping(cfg.early_stopping_patience, cfg.early_stopping_min_delta)
    watchdog = DivergenceWatchdog()
    profiler = StepProfiler(cfg.profile_dir, cfg.profile_start_step, cfg.profile_num_steps,
                            device)
    forked = []
    if device.type == "cuda":
        forked = [device.index if device.index is not None else torch.cuda.current_device()]
    try:
        with torch.random.fork_rng(devices=forked):
            torch.manual_seed(cfg.seed)  # dropout
            generator = torch.Generator(device=device).manual_seed(cfg.seed)
            state = warm_start(cfg, init_state(cfg, device))
            make_step = make_gan_train_step if cfg.use_gan else make_plain_train_step
            train_step, val_step = make_step(cfg, device)
            evaluator = None
            if cfg.eval_interval:  # built once; its weights are swapped at each run
                from facegantts_tpu_torch.evaluation.intrain import IntrainEvaluator

                evaluator = IntrainEvaluator(cfg, val_ds, os.path.join(work_dir, "inference"),
                                             device=device)
                logger.write({"eval_backends": evaluator.provenance})
            step = state.step
            # a resumed run goes on with the epoch it stopped in, from its start
            epoch = step // max(1, len(loader))
            t_last, n_last = time.time(), step
            while step < max_steps:
                for b in loader.epoch(epoch):
                    profiler.step(step)
                    flags = gan_flags(cfg, epoch, step) if cfg.use_gan else {}
                    with annotate("train_step"):
                        state, metrics = train_step(state, b, generator, **flags)
                    step += 1
                    if shutdown.requested:
                        print(f"[INFO] shutdown signal received; checkpointing at step "
                              f"{step} and exiting")
                        policy.save_step(state, step)
                        return state
                    if step % cfg.log_every_n_steps == 0 or step == 1:
                        m = {k: float(v) for k, v in metrics.items()}
                        if watchdog.update(m):
                            print(f"[FATAL] losses non-finite for {watchdog.patience} "
                                  f"consecutive logged steps; halting at step {step}")
                            policy.save_step(state, step)
                            return state
                        dt = time.time() - t_last
                        m["steps_per_sec"] = (step - n_last) / max(dt, 1e-9)
                        t_last, n_last = time.time(), step
                        logger.log(step, m)
                        print(f"[step {step}] " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
                    if step % cfg.save_step == 0:
                        with annotate("checkpoint"):
                            policy.save_step(state, step)
                    if evaluator is not None and step % cfg.eval_interval == 0:
                        _evaluate(evaluator, state, step, epoch, work_dir, logger, policy)
                    if step >= max_steps:
                        break
                val_kw = ({"train_disc": gan_flags(cfg, epoch, step)["train_disc"]}
                          if cfg.use_gan else {})
                with annotate("validation"):
                    avg = _validate(state, val_step, val_loader, generator, logger, step, epoch,
                                    **val_kw)
                if avg is not None:
                    if policy.monitor in avg:
                        policy.save_epoch(state, step, epoch, avg)
                    else:  # the monitor is an eval-interval metric
                        policy.snapshot(state, step, epoch)
                    if stopper.update(avg.get("total_loss", float("inf"))):
                        print(f"[INFO] early stopping at epoch {epoch} (patience exceeded)")
                        break
                epoch += 1
        policy.save_step(state, step)
        return state
    finally:
        profiler.close()
        logger.close()
