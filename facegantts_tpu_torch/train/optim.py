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

The GAN step has two more (JAX package ``build_gan_generator_optimizer``
and ``build_discriminator_optimizer``, reference
face_tts_w_discriminator.py:116-125, 312-313):
:class:`GanGeneratorOptimizer` clips the encoder's and the decoder's
gradients each by its own global norm and runs Adam at a constant rate on
each, and never sees SyncNet; :class:`DiscriminatorOptimizer` clips and runs
Adam with the discriminator's betas and eps.
"""

import math
from typing import Callable, List, Sequence

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


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: each gradient becomes
    ``t if norm < max_norm else (t / norm) * max_norm``.  Returns the norm
    before the clip; no host synchronisation."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


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
        norm = clip_by_global_norm_(grads, self.max_norm)
        for group, schedule in zip(self.opt.param_groups, self.schedules):
            group["lr"] = schedule(self.count)
        self.opt.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        """The Adam (or SGD) moments and step counts of every group, and the
        schedule's position (the JAX ``opt_state``)."""
        return {"count": self.count, "opt": self.opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        self.opt.load_state_dict(sd["opt"])


def gan_group(name: str) -> str:
    """The GAN generator optimizer's partition of a FaceTTS parameter
    (JAX ``build_gan_generator_optimizer``'s ``label``): SyncNet is frozen,
    the decoder is its own group, everything else goes with the encoder."""
    if name.startswith("syncnet."):
        return "frozen"
    return "decoder" if name.startswith("decoder.") else "encoder"


class _ClippedAdam:
    """Per group: clip the gradients in ``.grad`` by the group's own global
    norm, then Adam."""

    def __init__(self, groups: List[List[torch.nn.Parameter]], max_norm: float, lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.groups = [g for g in groups if g]
        self.max_norm = float(max_norm)
        self.opt = torch.optim.Adam([{"params": g} for g in self.groups], lr=lr,
                                    betas=betas, eps=eps)

    def step(self) -> None:
        for group in self.groups:
            grads = [p.grad for p in group if p.grad is not None]
            if not grads:
                raise RuntimeError(f"{type(self).__name__}.step: no gradients")
            clip_by_global_norm_(grads, self.max_norm)
        self.opt.step()

    def state_dict(self) -> dict:
        """The Adam moments and step counts of every group (the learning
        rate is constant)."""
        return {"opt": self.opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.opt.load_state_dict(sd["opt"])


class GanGeneratorOptimizer(_ClippedAdam):
    """The GAN step's generator optimizer: the ``encoder`` and ``decoder``
    groups of :func:`gan_group`, each clipped by its own global norm to
    ``grad_clip``, then Adam at the constant ``learning_rate`` with
    ``gen_eps``.  SyncNet's parameters are not handed over, so their update
    is exactly zero."""

    def __init__(self, cfg: Config, model: torch.nn.Module):
        named = list(model.named_parameters())
        groups = [[p for n, p in named if gan_group(n) == g] for g in ("encoder", "decoder")]
        self.frozen = [n for n, _ in named if gan_group(n) == "frozen"]
        super().__init__(groups, cfg.grad_clip, cfg.learning_rate, eps=cfg.gen_eps)


class DiscriminatorOptimizer(_ClippedAdam):
    """Clip by the global norm to ``grad_clip``, then Adam at
    ``disc_learning_rate`` with ``disc_betas_*`` and ``disc_eps``."""

    def __init__(self, cfg: Config, disc: torch.nn.Module):
        super().__init__([list(disc.parameters())], cfg.grad_clip, cfg.disc_learning_rate,
                         betas=(cfg.disc_betas_0, cfg.disc_betas_1), eps=cfg.disc_eps)
