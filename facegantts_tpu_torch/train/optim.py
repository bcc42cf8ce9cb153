"""Learning-rate schedules and the generator optimizer of the PyTorch port.

Port of the JAX package's ``train/optim.py`` (reference
utils/scheduler.py:12-71) for the plain FaceTTS step: adam / adamw /
adam_diff (SyncNet learning rate x 1e-7) / sgd, crossed with the warm-up
plus constant / cosine / linear / polynomial-decay schedules selected by
``decay_power``.

The JAX package chains ``clip_by_global_norm`` BEFORE its per-partition
optimizers, so the frozen SyncNet audio trunk's gradients (reference
face_tts.py:81-82) count toward the clip norm and the ``grad_norm`` metric,
and only its update is zero.  :class:`GeneratorOptimizer` does the same:
every gradient enters the norm and the clip, and the frozen parameters are
simply not handed to the torch optimizer.  Schedules follow optax's
convention: update n uses the schedule at count n, so a warm-up starts at
learning rate 0.
"""

import math
from typing import Callable, List

import torch

from facegantts_tpu_torch.config import Config

Schedule = Callable[[int], float]


def _polynomial(init: float, end: float, power: float, steps: int) -> Schedule:
    """optax.polynomial_schedule (linear_schedule is power 1)."""
    if steps <= 0:
        return lambda n: init

    def schedule(n: int) -> float:
        frac = 1.0 - min(max(n, 0), steps) / steps
        return (init - end) * frac**power + end

    return schedule


def _cosine(init: float, steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0."""
    return lambda n: init * 0.5 * (1.0 + math.cos(math.pi * min(n, steps) / steps))


def build_schedule(cfg: Config) -> Schedule:
    """Learning rate as a function of the update count (JAX package
    ``build_schedule``)."""
    lr, end_lr = cfg.learning_rate, cfg.end_lr
    warmup = int(cfg.warmup_steps)
    total = max(cfg.max_steps, warmup + 1)
    sel = cfg.decay_power  # reference scheduler.py:51-70 switches on this
    if sel == "cosine":
        main = _cosine(lr, total - warmup)
    elif sel == "linear":
        main = _polynomial(lr, 0.0, 1.0, total - warmup)
    elif sel == "constant":
        main = lambda n: lr  # noqa: E731
    else:  # polynomial decay to end_lr with power=decay_power
        main = _polynomial(lr, end_lr, float(sel), total - warmup)
    if warmup <= 0:
        return main
    warm = _polynomial(0.0, lr, 1.0, max(warmup, 1))
    return lambda n: warm(n) if n < warmup else main(n - warmup)


def frozen_aud_trunk(name: str) -> bool:
    """Plain-FaceTTS freeze rule: only the SyncNet audio CNN is frozen
    (reference face_tts.py:81-82 freezes netcnnaud; the fc head trains)."""
    return name.startswith("syncnet.netcnnaud.")


def _torch_optimizer(cfg: Config, groups: List[dict]) -> torch.optim.Optimizer:
    if cfg.optim_type == "adamw":
        return torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.98), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    if cfg.optim_type == "sgd":
        return torch.optim.SGD(groups, lr=0.0, momentum=0.9, weight_decay=1e-5)
    if cfg.optim_type in ("adam", "adam_diff"):
        return torch.optim.Adam(groups, lr=0.0, eps=cfg.gen_eps)
    raise ValueError(f"optim_type={cfg.optim_type!r}: expected adam, adamw, adam_diff or sgd")


class GeneratorOptimizer:
    """The optimizer of the full generator: global-norm clip over every
    gradient, then the configured optimizer (JAX package
    ``build_generator_optimizer``).

    With ``optim_type=adam_diff`` every SyncNet parameter trains at the
    learning rate x 1e-7 and nothing is frozen; otherwise the SyncNet audio
    trunk is frozen.  :meth:`step` returns the global norm of the gradients
    before the clip (the ``grad_norm`` metric)."""

    def __init__(self, cfg: Config, model: torch.nn.Module):
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        self.max_norm = float(cfg.grad_clip)
        self.count = 0
        if cfg.optim_type == "adam_diff":
            slow = build_schedule(cfg.replace(learning_rate=cfg.learning_rate * 1e-7))
            groups = [([p for n, p in named if not n.startswith("syncnet.")], build_schedule(cfg)),
                      ([p for n, p in named if n.startswith("syncnet.")], slow)]
            self.frozen = []
        else:
            groups = [([p for n, p in named if not frozen_aud_trunk(n)], build_schedule(cfg))]
            self.frozen = [n for n, _ in named if frozen_aud_trunk(n)]
        self.schedules = [sched for _, sched in groups]
        self.opt = _torch_optimizer(cfg, [{"params": ps} for ps, _ in groups])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            raise RuntimeError("GeneratorOptimizer.step: no gradients")
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax clip_by_global_norm: t if norm < max else (t / norm) * max
        keep = norm < self.max_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.max_norm))
        for group, schedule in zip(self.opt.param_groups, self.schedules):
            group["lr"] = schedule(self.count)
        self.opt.step()
        self.count += 1
        return norm

