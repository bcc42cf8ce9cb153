"""FLOP audit of the GAN training step (the JAX package's ``utils/flops.py``).

The pieces the step repeats are counted with the per-operator formulas of
``torch.utils.flop_counter.FlopCounterMode`` over the port's own code
(``train/step.py: make_gan_loss_fns``): one U-Net evaluation, the no-grad
sampler (the encoder and the duration path, then ``train_fake_timesteps``
U-Net evaluations), the D phase's gradient (R1 on) and the G phase's
gradient, at one micro-batch of ``cfg.micro_batch_size`` and bucket (tx,
ty).  They compose as in the JAX package::

    step = n_micro * (sampler + d_grad + g_grad),  n_micro = 2
    sampler = prologue + T * unet_eval

(the bench's per-card batch is two micro-batches).  ``step_measured`` is
one real ``make_gan_train_step`` step of that batch under the counter.  It
is ``step`` less ``n_micro * disc_fake``: the composed G phase runs the
discriminator on the fake, as JAX's ``g_loss_fn`` with ``reuse=None``
does, while the step reuses the D phase's fake logits.

Those formulas count matrix products, convolutions (their backward
included) and attention; XLA's cost model, which the JAX audit reads, also
counts elementwise work.  At the full U-Net width (``dec_dim`` 64) a U-Net
evaluation counts 0.96 of XLA's figure; at narrow widths elementwise work
dominates and the ratio falls (0.46 at ``dec_dim`` 8).
"""

import json
import os
import sys
from typing import Dict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

N_MICRO = 2  # the bench's per-card batch: two micro-batches


class _FlopCount(TorchDispatchMode):
    """``FlopCounterMode``'s count without its module tracker, whose hooks
    refuse ``autograd.grad`` on a leaf input (R1's gradient in the D phase):
    the same per-operator formulas (``flop_counter.flop_registry``), summed."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def _count(fn) -> float:
    with _FlopCount() as counter:
        fn()
    return float(counter.total)


def gan_batch(cfg, tx: int, ty: int, b: int, seed: int = 0):
    """A random :class:`Batch` of ``b`` full-length items at bucket (tx, ty)
    (the JAX bench's ``_gan_batch``), numpy arrays."""
    from facegantts_tpu_torch.train.state import Batch

    rng = np.random.default_rng(seed)
    spk = (rng.standard_normal((b, cfg.image_size, cfg.image_size, 3)) if cfg.spk_emb == "face"
           else rng.standard_normal((b, cfg.n_mels, ty)))
    return Batch(x=rng.integers(1, 148, (b, tx)).astype(np.int32),
                 x_len=np.full(b, tx, np.int32),
                 y=rng.standard_normal((b, cfg.n_mels, ty)).astype(np.float32),
                 y_len=np.full(b, ty, np.int32),
                 spk=spk.astype(np.float32))


def gan_step_flops(cfg, ty: int, tx: int, device=None) -> Dict[str, float]:
    """FLOPs of one GAN train step at the per-card batch ``2 *
    cfg.micro_batch_size`` and bucket (tx, ty), by part (see the module
    docstring), counted on ``device`` (the card unless given)."""
    from facegantts_tpu_torch.synthesis import resolve_device
    from facegantts_tpu_torch.train.optim import gan_group
    from facegantts_tpu_torch.train.step import init_state, make_gan_loss_fns, make_gan_train_step

    device = resolve_device(device)
    cfg = cfg.replace(use_gan=1)
    mb = cfg.micro_batch_size
    state = init_state(cfg, device)
    model, disc = state.model, state.disc
    model.syncnet.requires_grad_(False)  # frozen in the GAN step
    sample_fake, d_loss_fn, g_loss_fn = make_gan_loss_fns(cfg)
    batch = gan_batch(cfg, tx, ty, N_MICRO * mb).to(device)
    micro = type(batch)(*(a[:mb] for a in (batch.x, batch.x_len, batch.y, batch.y_len,
                                             batch.spk)))
    gen = torch.Generator(device=device).manual_seed(0)
    d_params = list(disc.parameters())
    g_params = [p for n, p in model.named_parameters() if gan_group(n) != "frozen"]

    est = model.decoder.estimator
    x_t = torch.zeros((mb, cfg.n_mels, ty), device=device)
    with torch.no_grad():
        unet_eval = _count(lambda: est(x_t, torch.ones((mb, 1, ty), device=device), x_t,
                                       torch.full((mb,), 0.5, device=device),
                                       torch.zeros((mb, cfg.vid_emb_dim), device=device)))
    sampler = _count(lambda: sample_fake(model, micro, gen))
    fake = torch.zeros((mb, cfg.n_mels, ty), device=device)
    d_grad = _count(lambda: torch.autograd.grad(d_loss_fn(disc, micro.y, fake, True)[0],
                                                d_params))
    model.train()
    g_grad = _count(lambda: torch.autograd.grad(
        g_loss_fn(model, disc, micro, fake, True, None, gen)[0], g_params, allow_unused=True))
    with torch.no_grad():
        disc_fake = _count(lambda: disc(fake[:, None]))
    train_step, _ = make_gan_train_step(cfg, device)
    step_measured = _count(lambda: train_step(state, batch, gen))
    t = cfg.train_fake_timesteps
    return {
        "unet_eval": unet_eval,
        "sampler": sampler,
        "prologue": sampler - t * unet_eval,
        "d_grad": d_grad,
        "g_grad": g_grad,
        "disc_fake": disc_fake,
        "step": N_MICRO * (sampler + d_grad + g_grad),
        "step_measured": step_measured,
    }


def main(argv=None):
    """Print one JSON line: the parts of :func:`gan_step_flops` at the
    bench's bucket (128, 436), on the card (``device=cpu`` for the CPU).
    ``$FLOPS_OVERRIDES`` (a JSON dict) applies Config overrides."""
    from facegantts_tpu_torch.config import default_config, parse_cli_overrides

    args = parse_cli_overrides(argv if argv is not None else sys.argv[1:])
    overrides = json.loads(os.environ.get("FLOPS_OVERRIDES", "{}"))
    cfg = default_config(env={}, overrides=overrides)
    out = gan_step_flops(cfg, ty=436, tx=128, device=args.get("device"))
    print(json.dumps({k: round(v) for k, v in out.items()}))


if __name__ == "__main__":
    main()
