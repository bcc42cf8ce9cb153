"""Training steps of the PyTorch port: the plain FaceTTS step and the GAN step.

Port of the JAX package's ``train/step.py`` on one device:

- :func:`make_plain_train_step` (reference face_tts.py:243-279): FaceTTS
  losses, backward, global-norm clip and Adam.
- :func:`make_gan_train_step` (reference face_tts_w_discriminator.py:127-349):
  per micro-batch, a fake mel from the no-grad sampler, a discriminator
  phase (hinge / mse / bce, optional R1) and a generator phase (adversarial
  + full-length FaceTTS losses), each gated on a finite loss; then one
  update of D and one of G.  As in JAX, both phases see the pre-update
  discriminator and the same fake, and the G phase reuses the D phase's
  fake logits and feature maps (a documented deviation from the reference,
  which steps D first and resamples): with the no-grad sampler the
  adversarial term carries no generator gradient.

Dropout is live in training and off in validation; SyncNet's BatchNorm runs
on its running statistics in both, and in the GAN step SyncNet is frozen
whole.  The crop offset, the diffusion time and the noise come from the
``torch.Generator`` the caller passes, or are injected (``draws``); dropout
draws from torch's default generator of the device, which ``train/loop.py``
seeds.  The JAX ``micro_unroll`` and ``fast_rng`` are XLA / TPU scheduling
and random-bit knobs with the same math: they have no effect here.

The JAX package's options of the two steps run as they do there:

- ``train_bf16``: the losses of both steps through ``train/precision.py``
  (bf16 parameters and model state, flax's dtype promotion, the loss parts
  back in f32; master parameters, Adam moments, gradient sums and the clip
  in f32);
- ``disc_bf16``: the D phase alone so (also the R1 double backward), with
  the logits in f32 before the loss;
- ``adv_grad_through_sampler``: the G phase resamples its fake with
  gradient through the reverse sampler and gates on ``g_loss``;
- ``grad_remat``: each phase's loss under ``torch.utils.checkpoint``; the
  recompute starts the explicit generator from its state at the forward.

Not ported, and raising: data parallelism over NCCL, the spectral-norm
discriminator, which the JAX package's GAN step cannot run (ROADMAP §3),
and the ``tpu_opt`` discriminator (ROADMAP item 18).
"""

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from facegantts_tpu_torch.config import Config
from facegantts_tpu_torch.models.discriminator import SpectrogramDiscriminator
from facegantts_tpu_torch.models.facetts import FaceTTS
from facegantts_tpu_torch.train.optim import (
    DiscriminatorOptimizer,
    GanGeneratorOptimizer,
    GeneratorOptimizer,
    gan_group,
)
from facegantts_tpu_torch.train.precision import mp_caster
from facegantts_tpu_torch.train.state import Batch, TrainState

METRICS = ("duration_loss", "prior_loss", "diffusion_loss", "spk_loss", "total_loss")
LOSS_TYPES = ("hinge", "mse", "bce")

# option -> (value that is not ported, why)
_UNPORTED = {
    "use_spectral_norm": (1, "the JAX package's GAN step cannot run the spectral-norm "
                             "discriminator (its init_state keeps only the discriminator's "
                             "'params', facegantts_tpu/train/step.py:91, and flax's "
                             "SpectralNorm needs its batch_stats: every disc.apply raises "
                             "InvalidRngError: SpectralNorm_0 needs PRNG for \"params\"), so "
                             "there is no reference to port it against (ROADMAP §3); use "
                             "weight norm (use_spectral_norm=0)"),
    "disc_family": ("tpu_opt", "the tpu_opt discriminator is not ported yet "
                               "(ROADMAP item 18)"),
}


def check_ported(cfg: Config) -> None:
    """Raise NotImplementedError, naming the option and why, for a GAN
    setting of ``cfg`` that the port does not run."""
    if not cfg.use_gan:
        return
    for name, (bad, why) in _UNPORTED.items():
        if getattr(cfg, name) == bad:
            raise NotImplementedError(f"{name}={bad}: {why}")


def init_state(cfg: Config, device) -> TrainState:
    """A FaceTTS of ``cfg`` with weights from ``cfg.seed`` on ``device``, and
    its optimizer; with ``use_gan`` also the discriminator (made after the
    generator, from the same seed) and its optimizer.  The weights are made
    on the CPU, so a seed gives the same weights on every device, and the
    generator's are those of ``use_gan=0``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = FaceTTS.from_config(cfg)
        disc = SpectrogramDiscriminator.from_config(cfg) if cfg.use_gan else None
    model = model.to(device)
    if disc is None:
        return TrainState(step=0, model=model, optimizer=GeneratorOptimizer(cfg, model))
    disc = disc.to(device)
    return TrainState(step=0, model=model, optimizer=GanGeneratorOptimizer(cfg, model),
                      disc=disc, disc_optimizer=DiscriminatorOptimizer(cfg, disc))


def _metrics(parts) -> Dict[str, torch.Tensor]:
    vals = (parts.dur_loss, parts.prior_loss, parts.diff_loss, parts.spk_loss, parts.total)
    return {k: v.detach() for k, v in zip(METRICS, vals)}


def make_plain_train_step(cfg: Config, device) -> Tuple[Callable, Callable]:
    """(train_step, val_step) for ``use_gan=0`` on ``device``; with
    ``train_bf16`` the losses run in mixed precision (``train/precision.py``).

    ``train_step(state, batch, generator) -> (state, metrics)`` updates the
    state in place; ``val_step(state, batch, generator) -> metrics``.  The
    metrics are 0-d tensors on the device (reading them synchronises):
    the four losses, ``total_loss`` and, in training, ``grad_norm``."""
    check_ported(cfg)
    device = torch.device(device)
    down, up, call = mp_caster(cfg.train_bf16)

    def loss(model: FaceTTS, batch: Batch, generator):
        b = batch.to(device)
        parts, _ = call(model, b.x, b.x_len, down(b.y), b.y_len, down(b.spk), cfg.out_size,
                        method="compute_loss", generator=generator)
        return up(parts)

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


# --------------------------------------------------------------------------
# adversarial criteria (reference face_tts_w_discriminator.py:37-54, 168-176)


def _bce(logits, label: float):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, label))


def _disc_loss(loss_type: str, real_logits, fake_logits):
    if loss_type == "hinge":
        return F.relu(1.0 - real_logits).mean() + F.relu(1.0 + fake_logits).mean()
    if loss_type == "mse":
        return 0.5 * ((real_logits - 1.0).square().mean() + fake_logits.square().mean())
    return 0.5 * (_bce(real_logits, 1.0) + _bce(fake_logits, 0.0))


def _gen_adv_loss(loss_type: str, fake_logits):
    if loss_type == "hinge":
        return -fake_logits.mean()
    if loss_type == "mse":
        return (fake_logits - 1.0).square().mean()
    return _bce(fake_logits, 1.0)


def _disc_accuracy(loss_type: str, real_logits, fake_logits):
    if loss_type == "hinge":
        return 0.5 * ((real_logits > 0).float().mean() + (fake_logits < 0).float().mean())
    return 0.5 * ((torch.sigmoid(real_logits) > 0.5).float().mean()
                  + (torch.sigmoid(fake_logits) < 0.5).float().mean())


def _feature_matching(real_fmap, fake_fmap):
    fm = 0.0
    for r, f in zip(real_fmap, fake_fmap):
        fm = fm + (r - f).abs().mean()
    return fm


def _frame_energy(mel):
    """Per-frame log energy of a log-mel: (B, F, T) -> (B, T) (the JAX
    package's on-device stand-in for the reference's librosa RMS)."""
    return torch.log(torch.exp(mel).mean(dim=1) + 1e-8)


def _soft_pitch(mel):
    """Pitch-contour proxy: the softmax-weighted mel-bin centroid per frame,
    (B, F, T) -> (B, T) in bin units (the JAX package's ``_soft_pitch``)."""
    w = torch.softmax(mel, dim=1)
    centers = torch.arange(mel.shape[1], dtype=mel.dtype, device=mel.device)
    return (w * centers[None, :, None]).sum(dim=1)


def _contour_loss(feat_real, feat_fake, y_len):
    """Masked L1 between per-frame contours (B, T)."""
    t = feat_real.shape[-1]
    mask = (torch.arange(t, device=feat_real.device)[None, :] < y_len[:, None]).to(feat_real.dtype)
    return ((feat_real - feat_fake).abs() * mask).sum() / mask.sum().clamp(min=1.0)


def _micro_split(batch: Batch, mb_size: int) -> Tuple[int, List[Batch]]:
    """(B, ...) -> n micro-batches of B / n rows (views); B must be a
    multiple of ``mb_size``, or at most ``mb_size`` (one under-sized
    micro-batch).  Any other B raises: rounding n down would run oversized
    micro-batches past the memory budget the user configured."""
    b = batch.x.shape[0]
    if b <= mb_size:
        n = 1
    elif b % mb_size == 0:
        n = b // mb_size
    else:
        raise ValueError(
            f"per-device batch {b} is not a multiple of micro_batch_size {mb_size}; "
            "pick sizes so B_local % micro_batch_size == 0 (or B_local <= micro_batch_size)")
    rows = b // n
    return n, [Batch(*(a[i * rows:(i + 1) * rows] for a in
                       (batch.x, batch.x_len, batch.y, batch.y_len, batch.spk)))
               for i in range(n)]


# --------------------------------------------------------------------------
# GAN step


def make_gan_loss_fns(cfg: Config):
    """The three per-micro-batch GAN computations (the JAX package's
    ``make_gan_loss_fns``):

    - ``sample_fake(model, mb, generator=None, noise=None)`` -> fake mel
      (B, F, T) f32, no gradient;
    - ``d_loss_fn(disc, y_real, fake, use_r1)`` -> (d_loss, metrics,
      (fake_logits, fake_fmap) detached, for the G phase);
    - ``g_loss_fn(model, disc, mb, fake, train_disc, reuse=None,
      generator=None, offset=None, t=None, z=None, noise=None)`` ->
      (g_loss, metrics); ``noise`` is the resampled fake's under
      ``adv_grad_through_sampler``.

    ``mb`` is a :class:`Batch` of tensors on the model's device.  With
    ``train_bf16`` the G phase runs in mixed precision and so does the D
    phase, as it does alone under ``disc_bf16`` (``train/precision.py``)."""
    if cfg.disc_loss_type not in LOSS_TYPES:
        raise ValueError(f"disc_loss_type={cfg.disc_loss_type!r}: expected one of {LOSS_TYPES}")
    check_ported(cfg.replace(use_gan=1))
    loss_type = cfg.disc_loss_type
    down, up, call = mp_caster(cfg.train_bf16)
    d_down, _, d_call = mp_caster(cfg.disc_bf16 or cfg.train_bf16)
    # both samplers: bf16 with gan_sampler_bf16, else as the G phase
    s_down, _, s_call = mp_caster(cfg.gan_sampler_bf16 or cfg.train_bf16)

    def sample_fake_grad(model: FaceTTS, mb: Batch, generator, noise) -> torch.Tensor:
        """The fake of ``adv_grad_through_sampler``: the sampler of
        :func:`sample_fake` through the live parameters, with gradient
        through the reverse steps into the encoder's ``mu_x`` and the U-Net
        (the ceiled durations carry none, SyncNet is frozen), dropout off
        as in the JAX sampler."""
        was_training = model.training
        model.eval()
        try:
            _, dec, _, _ = s_call(model, mb.x, mb.x_len, cfg.train_fake_timesteps,
                                  mb.y.shape[-1], 1.0, False, s_down(mb.spk), 1.0,
                                  generator=generator, noise=noise)
        finally:
            model.train(was_training)
        return dec.float()

    def sample_fake(model: FaceTTS, mb: Batch, generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """No-grad fake mel (reference @no_grad forward,
        face_tts_w_discriminator.py:163-165): ``train_fake_timesteps``
        deterministic reverse steps at temperature 1 and length_scale 1, at
        the batch's mel bucket.  With ``gan_sampler_bf16`` (the default) the
        model runs as the JAX sampler runs it, with every parameter and
        buffer cast to bfloat16 and flax's dtype promotion
        (``train/precision.py: run``): SyncNet's image stream and the prenet
        compute in bf16, the encoder from its first attention on, ``mu_y``
        and the U-Net (K1 included) in f32 with bf16 weights.  The fake
        returns in f32.  ``noise`` (B, F, T) standard normal replaces the
        draw from ``generator``."""
        with torch.no_grad():
            return sample_fake_grad(model, mb, generator, noise)

    def d_loss_fn(disc: SpectrogramDiscriminator, y_real: torch.Tensor, fake: torch.Tensor,
                  use_r1: bool):
        """Discriminator loss; with ``use_r1`` the real logits and R1's
        input gradient come from one forward (the reference runs a second
        forward for R1, face_tts_w_discriminator.py:191-201), and the loss
        gains ``effective_r1_gamma * 0.5 * r1``.  Under ``disc_bf16`` or
        ``train_bf16`` the forwards, the backward and R1's double backward
        run in bf16; R1 sums its squares in f32, and the logits are cast to
        f32 before the loss and the accuracy."""
        y_in = d_down(y_real.detach())[:, None]
        if use_r1:
            y_in.requires_grad_(True)
            _, real_logits = d_call(disc, y_in)
            (g,) = torch.autograd.grad(real_logits.sum(), y_in, create_graph=True)
            r1 = g.float().square().sum(dim=(1, 2, 3)).mean()
        else:
            _, real_logits = d_call(disc, y_in)
            r1 = torch.zeros((), device=y_real.device)
        fake_fmap, fake_logits = d_call(disc, d_down(fake.detach())[:, None])
        real_logits, fake_logits = real_logits.float(), fake_logits.float()
        d_loss = _disc_loss(loss_type, real_logits, fake_logits)
        acc = _disc_accuracy(loss_type, real_logits, fake_logits)
        if use_r1:
            # lazy R1 (r1_interval > 1) lands on 1/N of the steps at N-fold
            # weight; at interval 1 this is the reference's gamma
            d_loss = d_loss + cfg.effective_r1_gamma * 0.5 * r1
        metrics = {"disc_acc": acc.detach(), "r1_penalty": r1.detach()}
        return d_loss, metrics, (fake_logits.detach(), [f.detach() for f in fake_fmap])

    def g_loss_fn(model: FaceTTS, disc: SpectrogramDiscriminator, mb: Batch,
                  fake: torch.Tensor, train_disc: bool, reuse=None,
                  generator: Optional[torch.Generator] = None, offset=None, t=None, z=None,
                  noise=None):
        """Generator loss: ``lambda_adv * adv`` + the FaceTTS losses at full
        length (``out_size=None``, reference :285-287; ``gan_g_crop=1`` takes
        the 2-second crop) + the opt-in fm / pitch / energy terms.  With the
        no-grad sampler the adversarial, fm, pitch and energy terms are
        values of the fake and carry no generator gradient, so
        ``g_guard_loss`` (the non-finite gate) is the FaceTTS total: a
        saturated discriminator that sends adv to inf does not freeze the
        generator.  Under ``adv_grad_through_sampler`` the phase resamples
        its own fake with gradient (``fake`` and ``reuse`` go unused), the
        adversarial term trains the generator, and the gate is ``g_loss``.
        Dropout follows ``model``'s mode."""
        grad_fake = bool(cfg.adv_grad_through_sampler)
        if grad_fake:
            fake, reuse = sample_fake_grad(model, mb, generator, noise), None
        fake = down(fake)
        zero = torch.zeros((), device=mb.y.device)
        adv, fm, pitch, energy, fake_fmap = zero, zero, zero, zero, None
        if train_disc:
            if reuse is None:
                with torch.set_grad_enabled(grad_fake):
                    fake_fmap, fake_logits = call(disc, fake[:, None])
            else:
                fake_logits, fake_fmap = reuse
            adv = up(_gen_adv_loss(loss_type, fake_logits))
            if cfg.use_fm_loss:
                with torch.no_grad():
                    real_fmap, _ = call(disc, down(mb.y)[:, None])
                fm = up(_feature_matching(real_fmap, fake_fmap))
        y = down(mb.y)
        if cfg.use_pitch_loss:
            pitch = up(_contour_loss(_soft_pitch(y), _soft_pitch(fake), mb.y_len))
        if cfg.use_energy_loss:
            energy = up(_contour_loss(_frame_energy(y), _frame_energy(fake), mb.y_len))
        out_size = cfg.out_size if cfg.gan_g_crop else None
        parts, _ = call(model, mb.x, mb.x_len, y, mb.y_len, down(mb.spk), out_size,
                        method="compute_loss", offset=offset, t=t, z=z, generator=generator)
        parts = up(parts)
        g_loss = (cfg.lambda_adv * adv + parts.dur_loss + parts.prior_loss + parts.diff_loss
                  + parts.spk_loss + cfg.use_fm_loss * fm + cfg.use_pitch_loss * pitch
                  + cfg.use_energy_loss * energy)
        metrics = {"adv_loss": adv, "fm_loss": fm, "pitch_loss": pitch, "energy_loss": energy,
                   "duration_loss": parts.dur_loss, "prior_loss": parts.prior_loss,
                   "diffusion_loss": parts.diff_loss, "spk_loss": parts.spk_loss,
                   "g_loss": g_loss, "g_guard_loss": g_loss if grad_fake else parts.total}
        return g_loss, {k: v.detach() for k, v in metrics.items()}

    return sample_fake, d_loss_fn, g_loss_fn


def _accumulate(acc: Sequence[torch.Tensor], grads, ok: torch.Tensor) -> None:
    """acc += grads where ``ok`` (a 0-d bool on the device), else += 0: a
    micro-batch with a non-finite loss adds zero, not NaN."""
    for a, g in zip(acc, grads):
        if g is not None:
            a.add_(torch.where(ok, g, 0.0))


def make_gan_train_step(cfg: Config, device) -> Tuple[Callable, Callable]:
    """(train_step, val_step) for ``use_gan=1`` on ``device``.

    ``train_step(state, batch, generator, train_disc=True, train_gen=True,
    use_r1=True, draws=None) -> (state, metrics)`` updates the state in
    place and leaves the step's gradients (means over the micro-batches) in
    the parameters' ``.grad``: ``train_disc`` (epoch >= warmup_disc_epochs), ``train_gen``
    (epoch >= freeze_gen_epochs), ``use_r1`` (see ``train/loop.py:
    gan_flags``).  ``draws``, one dict a micro-batch, injects the sampler's
    ``noise``, the G phase's ``offset`` / ``t`` / ``z`` and, under
    ``adv_grad_through_sampler``, its resampled fake's ``g_noise`` in place
    of draws from ``generator`` (tests feed both frameworks the same).  Metrics are
    0-d device tensors, means over the micro-batches.
    ``val_step(state, batch, generator, train_disc=True) -> metrics``."""
    if cfg.micro_batch_size_gen not in (0, cfg.micro_batch_size):
        raise ValueError(
            "micro_batch_size_gen must equal micro_batch_size (or 0 = follow it): the fused "
            "step samples each fake once and shares it between the D and G phases")
    device = torch.device(device)
    sample_fake, d_loss_fn, g_loss_fn = make_gan_loss_fns(cfg)
    loss_type = cfg.disc_loss_type
    d_fn, g_fn = d_loss_fn, g_loss_fn
    if cfg.grad_remat:
        # each phase's forward is recomputed in its backward (the JAX
        # package's jax.checkpoint); checkpoint restores dropout's default
        # generators for the recompute, and the G phase restores its explicit
        # generator itself, so the recompute draws the forward's values and
        # leaves the generator where the forward left it
        def d_fn(*args):
            return checkpoint(d_loss_fn, *args, use_reentrant=False)

        def g_fn(model, disc, mb, fake, train_disc, reuse, generator, **kwargs):
            start = None if generator is None else generator.get_state()

            def g_loss_from_start(*args):
                if start is not None:
                    generator.set_state(start)
                return g_loss_fn(*args, generator, **kwargs)

            return checkpoint(g_loss_from_start, model, disc, mb, fake, train_disc, reuse,
                              use_reentrant=False)

    def grads(state: TrainState, batch: Batch, generator, train_disc: bool, use_r1: bool,
              draws=None):
        """Per micro-batch: fake, D phase, G phase; gradient sums of the
        finite micro-batches over n_micro, and the metrics' means."""
        model, disc = state.model, state.disc
        model.syncnet.requires_grad_(False)  # frozen whole: no video-trunk backward
        d_params = list(disc.parameters())
        g_params = [p for n, p in model.named_parameters() if gan_group(n) != "frozen"]
        d_acc = [torch.zeros_like(p) for p in d_params]
        g_acc = [torch.zeros_like(p) for p in g_params]
        n_micro, micro = _micro_split(batch.to(device), cfg.micro_batch_size)
        zero = torch.zeros((), device=device)
        per_micro = []
        for i, mb in enumerate(micro):
            dr = draws[i] if draws is not None else {}
            fake = sample_fake(model, mb, generator, noise=dr.get("noise"))
            m, reuse = {}, None
            if train_disc:
                d_loss, d_m, reuse = d_fn(disc, mb.y, fake, use_r1)
                ok = torch.isfinite(d_loss)
                _accumulate(d_acc, torch.autograd.grad(d_loss, d_params), ok)
                m.update(d_m, d_loss=torch.where(ok, d_loss.detach(), 0.0),
                         d_nan_skipped=(~ok).float())
            else:
                m.update(d_loss=zero, disc_acc=zero, r1_penalty=zero, d_nan_skipped=zero)
            g_dr = {k: dr[k] for k in ("offset", "t", "z") if k in dr}
            if "g_noise" in dr:
                g_dr["noise"] = dr["g_noise"]
            model.train()
            g_loss, g_m = g_fn(model, disc, mb, fake, train_disc, reuse, generator, **g_dr)
            ok_g = torch.isfinite(g_m["g_guard_loss"])
            _accumulate(g_acc, torch.autograd.grad(g_loss, g_params, allow_unused=True), ok_g)
            m.update(g_m, g_nan_skipped=(~ok_g).float())
            per_micro.append(m)
        inv = 1.0 / n_micro
        torch._foreach_mul_(d_acc + g_acc, inv)
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean() for k in per_micro[0]}
        return d_acc, g_acc, metrics, (d_params, g_params)

    def train_step(state: TrainState, batch: Batch, generator: torch.Generator,
                   train_disc: bool = True, train_gen: bool = True, use_r1: bool = True,
                   draws=None):
        d_grads, g_grads, metrics, (d_params, g_params) = grads(
            state, batch, generator, train_disc, use_r1, draws)
        # the step's gradients stay in .grad, as after a backward
        for p, g in zip(d_params + g_params, d_grads + g_grads):
            p.grad = g
        if train_disc:
            state.disc_optimizer.step()
        if train_gen:
            state.optimizer.step()
        state.step += 1
        return state, metrics

    def val_step(state: TrainState, batch: Batch, generator: torch.Generator,
                 train_disc: bool = True):
        """Fake from the sampler, its adversarial loss, the FaceTTS losses
        at the 2-second crop with dropout off; ``total_loss`` is
        ``lambda_adv * adv_loss`` + the FaceTTS total."""
        b = batch.to(device)
        model = state.model
        fake = sample_fake(model, b, generator)
        model.eval()
        with torch.no_grad():
            adv = (_gen_adv_loss(loss_type, state.disc(fake[:, None])[1]) if train_disc
                   else torch.zeros((), device=device))
            parts, _ = model.compute_loss(b.x, b.x_len, b.y, b.y_len, b.spk, cfg.out_size,
                                          generator=generator)
        metrics = _metrics(parts)
        metrics["total_loss"] = cfg.lambda_adv * adv + parts.total
        metrics["adv_loss"] = adv
        return metrics

    return train_step, val_step

