"""Training step of the PyTorch port: the plain (no-GAN) FaceTTS step.

Port of the JAX package's ``train/step.py: make_plain_train_step``
(reference face_tts.py:243-279): FaceTTS losses, backward, global-norm clip
and Adam, on one device.  Dropout is live in training and off in
validation; SyncNet's BatchNorm runs on its running statistics in both.
The crop offset, the diffusion time and the noise come from the
``torch.Generator`` the caller passes; dropout draws from torch's default
generator of the device, which ``train/loop.py`` seeds.  Data parallelism
over NCCL, the GAN step and mixed-precision training (``train_bf16``) are
not ported yet.
"""

from typing import Callable, Dict, Tuple

import torch

from facegantts_tpu_torch.config import Config
from facegantts_tpu_torch.models.facetts import FaceTTS
from facegantts_tpu_torch.train.optim import GeneratorOptimizer
from facegantts_tpu_torch.train.state import Batch, TrainState

METRICS = ("duration_loss", "prior_loss", "diffusion_loss", "spk_loss", "total_loss")


def init_state(cfg: Config, device) -> TrainState:
    """A FaceTTS of ``cfg`` with weights from ``cfg.seed`` on ``device``, and
    its generator optimizer.  The weights are made on the CPU, so a seed
    gives the same weights on every device."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = FaceTTS.from_config(cfg)
    model = model.to(device)
    return TrainState(step=0, model=model, optimizer=GeneratorOptimizer(cfg, model))


def _metrics(parts) -> Dict[str, torch.Tensor]:
    vals = (parts.dur_loss, parts.prior_loss, parts.diff_loss, parts.spk_loss, parts.total)
    return {k: v.detach() for k, v in zip(METRICS, vals)}


def make_plain_train_step(cfg: Config, device) -> Tuple[Callable, Callable]:
    """(train_step, val_step) for ``use_gan=0`` on ``device``.

    ``train_step(state, batch, generator) -> (state, metrics)`` updates the
    state in place; ``val_step(state, batch, generator) -> metrics``.  The
    metrics are 0-d tensors on the device (reading them synchronises):
    the four losses, ``total_loss`` and, in training, ``grad_norm``."""
    if cfg.train_bf16:
        raise NotImplementedError(
            "train_bf16=1: mixed-precision training is not ported yet; train in f32")
    device = torch.device(device)

    def loss(model: FaceTTS, batch: Batch, generator):
        b = batch.to(device)
        parts, _ = model.compute_loss(b.x, b.x_len, b.y, b.y_len, b.spk, cfg.out_size,
                                      generator=generator)
        return parts

    def train_step(state: TrainState, batch: Batch, generator: torch.Generator):
        state.model.train()
        state.optimizer.zero_grad()
        parts = loss(state.model, batch, generator)
        parts.total.backward()
        metrics = _metrics(parts)
        metrics["grad_norm"] = state.optimizer.step()
        state.step += 1
        return state, metrics

    def val_step(state: TrainState, batch: Batch, generator: torch.Generator):
        state.model.eval()
        with torch.no_grad():
            return _metrics(loss(state.model, batch, generator))

    return train_step, val_step
