"""The PyTorch port's GAN training slice against the JAX package, on the CPU.

- the spectrogram discriminator (parity family, weight norm): feature maps
  and logits equal the JAX module's for JAX parameters carried across by
  ``convert.discriminator_state_dict`` (2e-4, the bar of
  tests/test_import.py), which round-trips with ``import_discriminator``;
- ``d_loss_fn`` for hinge, mse and bce, with and without R1, at
  ``r1_interval`` 1 and 4: the loss, R1 and accuracy match
  ``jax.value_and_grad`` of the JAX ``d_loss_fn`` to rtol 1e-4 and the
  gradients to 1e-3 of the largest;
- the G phase: gradients equal ``jax.grad`` of ``lambda_adv * adv +
  compute_loss(out_size=None, deterministic=True).total`` with the draws
  injected (1e-3 of the largest), with the fm / pitch / energy terms off and
  on (their values match the JAX helpers; they carry no gradient);
- ``sample_fake`` with injected noise: f32 equals JAX to max 2e-3 and mean
  2e-4 (tests/test_e2e_parity.py's bars); bf16 against the JAX bf16
  sampler within the bf16 sampler's own distance from f32 (see
  ``test_sample_fake_matches_jax``);
- the two GAN optimizers against optax over three updates (1e-6 of the
  largest parameter), the per-group clip and SyncNet's zero update;
- the whole step through the plain versions: gradients and updates equal
  the JAX pieces composed on the same fakes and draws, the warm-up phase,
  AUTO-4 fake timesteps, the non-finite gate, the loop's R1 schedule and
  ``python -m facegantts_tpu_torch.train`` with the default ``use_gan=1``.

Weights are seeded numpy values carried into the port by
``facegantts_tpu_torch.convert``; torch runs strict f32 (no TF32).  Dims:
the JAX train tests' TINY generator and an 8-channel, 2-layer
discriminator."""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from facegantts_tpu.config import default_config as jax_default_config
from facegantts_tpu.models.discriminator import SpectrogramDiscriminator as JDisc
from facegantts_tpu.models.facetts import FaceTTS as JFaceTTS
from facegantts_tpu.train import optim as joptim
from facegantts_tpu.train import step as jstep
from facegantts_tpu.train.checkpoint import import_discriminator
from facegantts_tpu_torch import convert
from facegantts_tpu_torch.config import default_config
from facegantts_tpu_torch.models.discriminator import SpectrogramDiscriminator
from facegantts_tpu_torch.train import optim as toptim
from facegantts_tpu_torch.train import step as tstep
from facegantts_tpu_torch.train.loop import gan_flags
from facegantts_tpu_torch.train.state import Batch
from test_torch_train import _SMALL, TINY, _jax_draws, _Named, _random_variables
from torch_cpu import torch_threads_started  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# TINY plus the JAX train tests' small discriminator kernel (5, 3), pad 2
GAN = dict(TINY, use_gan="1", disc_base_channels="8", disc_num_layers="2",
           kernel_height="5", kernel_width="3", disc_padding="2", micro_batch_size="2")
B, T_X, T_Y = 4, 8, 32
EST_SCALE = 0.25  # keeps the random-weight reverse ODE finite (tests/test_e2e_parity.py)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread here: the parallel test run starts several
    workers on one host, and these small ops lose more to thread hand-offs
    between oversubscribed cores than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _strict_f32():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _batch(seed=0):
    """Speech-mode batch: the conditioning input is a mel clip."""
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.integers(1, 100, (B, T_X)).astype(np.int32),
        x_len=np.array([8, 6, 5, 7], np.int32),
        y=(rng.standard_normal((B, 128, T_Y)) - 1.0).astype(np.float32),
        y_len=np.array([32, 27, 20, 30], np.int32),
        spk=rng.standard_normal((B, 128, T_Y)).astype(np.float32),
    )


def _rows(batch, lo, hi):
    return {k: v[lo:hi] for k, v in batch.items()}


def _torch_batch(batch) -> Batch:
    return Batch(**{k: torch.from_numpy(v.copy()) for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """JAX models and variables shared by the tests (built once): FaceTTS
    variables from seeded numpy with the decoder scaled by EST_SCALE and
    the durations lengthened, the discriminator from its own init with
    scales off 1."""
    jcfg = jax_default_config(env=GAN)
    jm, jdisc = jstep.build_models(jcfg)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    variables = _random_variables(jm, jax.random.PRNGKey(1), jb["x"], jb["x_len"], jb["y"],
                                  jb["y_len"], jb["spk"], 16, seed=3,
                                  method=JFaceTTS.compute_loss)
    variables["params"]["decoder"] = jax.tree.map(
        lambda a: a * np.float32(EST_SCALE), variables["params"]["decoder"])
    proj = variables["params"]["encoder"]["proj_w"]["proj"]
    proj["bias"] = proj["bias"] + np.float32(1.0)
    dparams = jdisc.init(jax.random.PRNGKey(2), jb["y"][..., None])["params"]
    rng = np.random.default_rng(4)
    dparams = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if "scale" in jax.tree_util.keystr(path) else np.asarray(a)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), dparams)
    return jcfg, jm, jdisc, variables, dparams


def _port(env=None, bf16=True):
    """The port's generator and discriminator with the JAX weights, dropout
    off (p = 0 leaves the modes as the step sets them, with the JAX side's
    deterministic draws)."""
    _, _, _, variables, dparams = _jax_setup()
    cfg = default_config(env=dict(GAN, gan_sampler_bf16=str(int(bf16)), **(env or {})))
    state = tstep.init_state(cfg, "cpu")
    missing, unexpected = state.model.load_state_dict(convert.facetts_state_dict(variables),
                                                      strict=False)
    assert not unexpected and all(k.startswith("syncnet.netcnnimg.") or
                                  k.startswith("syncnet.netfcimg.") for k in missing)
    state.disc.load_state_dict(convert.discriminator_state_dict(dparams))
    for m in state.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return cfg, state


def _close(got, want, scale, frac=1e-3, what=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale, err_msg=what)


# ---------------------------------------------------------------------------
# discriminator


@pytest.mark.parametrize("stride", [1, 2])
def test_discriminator_matches_jax(stride):
    """Published kernel (12, 5), padding 6, at base 8 and 2 layers."""
    jdisc = JDisc(base_channels=8, num_layers=2, stride=stride, multi_speaker=0)
    x = np.random.default_rng(3).standard_normal((2, 128, 24)).astype(np.float32)
    params = jdisc.init(jax.random.PRNGKey(5), jnp.asarray(x)[..., None])["params"]
    rng = np.random.default_rng(6)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                          .astype(np.float32), params)
    jfmap, jlogits = jdisc.apply({"params": params}, jnp.asarray(x)[..., None])

    sd = convert.discriminator_state_dict(params)
    back = import_discriminator(sd, prefix="")
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    disc = SpectrogramDiscriminator(base_channels=8, num_layers=2, stride=stride)
    disc.load_state_dict(sd)
    assert disc.conv_prev.weight_g.shape == (8, 1, 1, 1)  # torch weight_norm's layout
    with torch.no_grad():
        fmap, logits = disc(torch.from_numpy(x)[:, None])
    assert len(fmap) == len(jfmap) == 3
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=2e-4)
    for got, want in zip(fmap, jfmap):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                                   atol=2e-4)


def test_discriminator_refuses_unported():
    """Spectral norm (which the JAX package's GAN step cannot run) and the
    tpu_opt family raise by name; the speaker input is ported
    (tests/test_torch_precision.py) and needs a discriminator built with
    one."""
    with pytest.raises(NotImplementedError, match="spectral.*JAX package's GAN step cannot"):
        SpectrogramDiscriminator(use_spectral_norm=1)
    with pytest.raises(NotImplementedError, match="tpu_opt.*ROADMAP item 18"):
        SpectrogramDiscriminator(family="tpu_opt")
    disc = SpectrogramDiscriminator(base_channels=4, num_layers=1)
    with pytest.raises(ValueError, match="without a speaker input"):
        disc(torch.zeros(1, 1, 16, 8), torch.zeros(1, 4))
    disc = SpectrogramDiscriminator(base_channels=4, num_layers=1, spk_emb_dim=4)
    fmap, logits = disc(torch.zeros(1, 1, 32, 8), torch.ones(1, 4))
    assert len(fmap) == 2 and torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# D phase


@functools.lru_cache(maxsize=None)
def _jax_d(loss_type, interval):
    jcfg, jm, jdisc, _, _ = _jax_setup()
    cfg = jcfg.replace(disc_loss_type=loss_type, r1_interval=interval)
    _, d_loss_fn, _ = jstep.make_gan_loss_fns(cfg, jm, jdisc)
    return jax.jit(jax.value_and_grad(d_loss_fn, has_aux=True), static_argnums=3)


@pytest.mark.parametrize("loss_type, use_r1, interval", [
    (lt, r1, n) for lt in ("hinge", "mse", "bce") for r1, n in ((False, 1), (True, 1), (True, 4))])
def test_d_loss_matches_jax(loss_type, use_r1, interval):
    _, _, _, _, dparams = _jax_setup()
    rng = np.random.default_rng(7)
    y = (rng.standard_normal((2, 128, T_Y)) - 1.0).astype(np.float32)
    fake = (rng.standard_normal((2, 128, T_Y)) * 0.7 - 1.0).astype(np.float32)
    (jloss, (jm, _)), jgrads = _jax_d(loss_type, interval)(dparams, y, fake, use_r1)

    cfg, state = _port(dict(disc_loss_type=loss_type, r1_interval=str(interval)))
    _, d_loss_fn, _ = tstep.make_gan_loss_fns(cfg)
    d_loss, m, (fake_logits, fake_fmap) = d_loss_fn(state.disc, torch.from_numpy(y),
                                                    torch.from_numpy(fake), use_r1)
    assert not fake_logits.requires_grad and len(fake_fmap) == 3
    names = [n for n, _ in state.disc.named_parameters()]
    grads = torch.autograd.grad(d_loss, list(state.disc.parameters()))
    np.testing.assert_allclose(d_loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(m["disc_acc"].item(), float(jm["disc_acc"]), rtol=1e-4)
    np.testing.assert_allclose(m["r1_penalty"].item(), float(jm["r1_penalty"]), rtol=1e-4)
    assert (m["r1_penalty"].item() > 0) == use_r1
    want = convert.discriminator_state_dict(jgrads)
    assert set(want) == set(names)
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for name, g in zip(names, grads):
        _close(g.numpy(), want[name].numpy(), scale, what=name)


# ---------------------------------------------------------------------------
# G phase and the sampler


@functools.lru_cache(maxsize=None)
def _jax_g_fn():
    """value_and_grad of lambda_adv * adv + compute_loss(out_size=None,
    deterministic=True).total, adv a constant (the reused fake logits)."""
    jcfg, jm, _, variables, _ = _jax_setup()

    def g_loss(params, rng, x, x_len, y, y_len, spk, adv):
        parts, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, rng,
                            x, x_len, y, y_len, spk, None, deterministic=True,
                            method=JFaceTTS.compute_loss)
        return jcfg.lambda_adv * adv + parts.total, parts

    return jax.jit(jax.value_and_grad(g_loss, has_aux=True))


def _jax_g(mb, adv, rng):
    _, _, _, variables, _ = _jax_setup()
    (val, parts), grads = _jax_g_fn()(variables["params"], rng, *(jnp.asarray(mb[k]) for k in (
        "x", "x_len", "y", "y_len", "spk")), jnp.float32(adv))
    return float(val), parts, grads


def _gen_grads_close(got, want, frac=1e-3):
    """Encoder and decoder gradients against JAX's; SyncNet has none."""
    scale = max(float(np.abs(v.numpy()).max()) for k, v in want.items()
                if not k.startswith("syncnet."))
    for name, g in got.items():
        if name.startswith("syncnet."):
            assert g is None, name
            continue
        _close(g.numpy(), want[name].numpy(), scale, frac, what=name)


@pytest.mark.parametrize("extras", [False, True])
def test_g_phase_matches_jax(extras):
    """With fm / pitch / energy off and on: those terms are values of the
    no-grad fake (their JAX helpers give the same numbers) and leave the
    gradient that of the FaceTTS losses; ``g_guard_loss`` is their total."""
    env = dict(use_fm_loss="1", use_pitch_loss="1", use_energy_loss="1") if extras else {}
    cfg, state = _port(env)
    jcfg, _, jdisc, _, dparams = _jax_setup()
    mb = _rows(_batch(), 0, 2)
    fake = (np.random.default_rng(8).standard_normal((2, 128, T_Y)) - 1.0).astype(np.float32)
    jfmap, jlogits = jdisc.apply({"params": dparams}, jnp.asarray(fake)[..., None])
    adv = float(jstep._gen_adv_loss(cfg.disc_loss_type, jlogits))
    rng = jax.random.PRNGKey(11)
    _, t, z = _jax_draws(rng, mb, T_Y)
    want_val, jparts, jgrads = _jax_g(mb, adv, rng)
    want = convert.facetts_state_dict({"params": jgrads})

    _, d_loss_fn, g_loss_fn = tstep.make_gan_loss_fns(cfg)
    model = state.model.eval()
    model.syncnet.requires_grad_(False)
    tb = _torch_batch(mb)
    _, _, reuse = d_loss_fn(state.disc, tb.y, torch.from_numpy(fake), False)
    g_loss, m = g_loss_fn(model, state.disc, tb, torch.from_numpy(fake), True, reuse,
                          t=torch.tensor(np.asarray(t)), z=torch.tensor(np.asarray(z)))
    g_loss.backward()

    np.testing.assert_allclose(m["adv_loss"].item(), adv, rtol=1e-4)
    for got, ref in zip((m["duration_loss"], m["prior_loss"], m["diffusion_loss"],
                         m["spk_loss"]), jparts):
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-4)
    parts_total = sum(m[k].item() for k in ("duration_loss", "prior_loss", "diffusion_loss",
                                            "spk_loss"))
    np.testing.assert_allclose(m["g_guard_loss"].item(), parts_total, rtol=1e-6)
    extra = 0.0
    if extras:
        jreal, _ = jdisc.apply({"params": dparams}, jnp.asarray(mb["y"])[..., None])
        y_len = jnp.asarray(mb["y_len"])
        ref = {"fm_loss": jstep._feature_matching(jreal, jfmap),
               "pitch_loss": jstep._contour_loss(jstep._soft_pitch(mb["y"]),
                                                 jstep._soft_pitch(fake), y_len),
               "energy_loss": jstep._contour_loss(jstep._frame_energy(mb["y"]),
                                                  jstep._frame_energy(fake), y_len)}
        for k, v in ref.items():
            assert m[k].item() > 0
            np.testing.assert_allclose(m[k].item(), float(v), rtol=1e-4)
            extra += float(v)
    else:
        assert m["fm_loss"].item() == m["pitch_loss"].item() == m["energy_loss"].item() == 0
    np.testing.assert_allclose(g_loss.item(), want_val + extra, rtol=1e-4)
    _gen_grads_close({n: p.grad for n, p in model.named_parameters()}, want)


def _jax_fake(mb, noise, bf16):
    """The JAX sampler (``make_gan_loss_fns``' sample_fake) with the noise
    injected through ``FaceTTS.__call__(noise=...)``."""
    jcfg, jm, _, variables, _ = _jax_setup()
    cast = ((lambda t: jstep._cast_floats(t, jnp.bfloat16)) if bf16 else (lambda t: t))

    def run(v, x, x_len, spk, n):
        _, dec, _, _ = jm.apply(cast(v), x, x_len, jcfg.train_fake_timesteps, T_Y, 1.0, False,
                                cast(spk), 1.0, jax.random.PRNGKey(0), noise=n)
        return dec.astype(jnp.float32)

    return np.asarray(jax.jit(run)(variables, mb["x"], mb["x_len"], mb["spk"], noise))


def test_sample_fake_matches_jax():
    """f32: the bars of tests/test_e2e_parity.py (max 2e-3, mean 2e-4).

    bf16 (the default): every parameter and buffer cast to bf16 under
    flax's promotion, as the JAX sampler runs (``train/precision.py: run``):
    the encoder from its first attention on, ``mu_y`` and the U-Net compute
    in f32 with bf16 weights, so the fake is f32 values, not bf16 ones (the
    layer-by-layer dtypes: ``tests/test_torch_precision.py``).  It covers
    the same frames as JAX's (the durations' exp and ceil run in f32, as
    XLA computes them).  Measured, the port's bf16 fake lies 2.4e-3 from
    JAX's on average and 0.027 at most, at values up to 42, where JAX's own
    bf16 fake lies 3.4e-3 / 0.030 from its f32 fake: the bars are 5e-3 and
    0.05.  (The all-bf16 sampler this replaced lay 0.021 / 0.46 from JAX's,
    under bars of 0.049 / 1.0 that these replace.)"""
    mb = _rows(_batch(), 0, 3)
    noise = np.random.default_rng(9).standard_normal((3, 128, T_Y)).astype(np.float32)
    want32, want16 = _jax_fake(mb, noise, False), _jax_fake(mb, noise, True)
    got = {}
    for bf16 in (False, True):
        cfg, state = _port(bf16=bf16)
        sample_fake, _, _ = tstep.make_gan_loss_fns(cfg)
        assert cfg.train_fake_timesteps == 2  # AUTO: min(4, timesteps)
        fake = sample_fake(state.model, _torch_batch(mb), noise=torch.from_numpy(noise))
        assert fake.dtype == torch.float32 and fake.shape == (3, 128, T_Y)
        assert not fake.requires_grad and torch.isfinite(fake).all()
        got[bf16] = fake.numpy()
    d = np.abs(got[False] - want32)
    assert d.max() < 2e-3 and d.mean() < 2e-4, (d.max(), d.mean())

    fake16 = got[True]
    assert not np.array_equal(fake16, torch.from_numpy(fake16).bfloat16().float().numpy())
    frames = [(np.abs(f).sum(axis=1) > 0).sum(axis=-1) for f in (fake16, want16)]
    np.testing.assert_array_equal(*frames)
    d = np.abs(fake16 - want16)
    assert d.mean() <= 5e-3 and d.max() <= 0.05, (d.mean(), d.max())


# ---------------------------------------------------------------------------
# optimizers


def test_gan_optimizers_match_optax():
    """Three updates (clipped, clipped, not) of both GAN optimizers against
    optax on the same gradients: per-group clip then Adam for the
    generator (a leaf outside encoder / decoder / syncnet goes with the
    encoder), clip then Adam with the discriminator's betas and eps."""
    env = dict(GAN, learning_rate="1e-2", disc_learning_rate="3e-3", grad_clip="1.0",
               disc_betas_0="0.5", disc_betas_1="0.9", disc_eps="1e-6", gen_eps="1e-7")
    jcfg, cfg = jax_default_config(env=env), default_config(env=env)
    small = {**_SMALL, ("other", "w"): ("other.w", (3,))}
    rng = np.random.default_rng(4)
    flat = {path: rng.standard_normal(shape).astype(np.float32)
            for path, (_, shape) in small.items()}
    params = traverse_util.unflatten_dict(flat)

    def to_port(tree):
        return {small[path][0]: torch.tensor(np.asarray(v))
                for path, v in traverse_util.flatten_dict(tree).items()}

    named = {n: torch.nn.Parameter(v) for n, v in to_port(params).items()}
    disc_named = {"w": torch.nn.Parameter(torch.tensor(rng.standard_normal(6), dtype=torch.float32)),
                  "b": torch.nn.Parameter(torch.tensor(rng.standard_normal(2), dtype=torch.float32))}
    dparams = {k: np.asarray(v.detach()) for k, v in disc_named.items()}
    gtx, dtx = joptim.build_gan_generator_optimizer(jcfg, params), joptim.build_discriminator_optimizer(jcfg)
    gs, ds = gtx.init(params), dtx.init(dparams)
    gopt = toptim.GanGeneratorOptimizer(cfg, _Named(named))
    dopt = toptim.DiscriminatorOptimizer(cfg, _Disc(disc_named))
    assert sorted(gopt.frozen) == sorted(n for n in named if n.startswith("syncnet."))
    assert [len(g) for g in gopt.groups] == [2, 1]  # encoder (other.w too), decoder
    frozen = {n: p.detach().clone() for n, p in named.items() if n.startswith("syncnet.")}
    for scale in (0.5, 0.05, 0.001):  # clipped, clipped, not clipped
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
                             params)
        dgrads = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
                  for k, v in dparams.items()}
        u, gs = gtx.update(grads, gs, params)
        params = optax.apply_updates(params, u)
        u, ds = dtx.update(dgrads, ds, dparams)
        dparams = optax.apply_updates(dparams, u)
        for n, g in to_port(grads).items():
            named[n].grad = g.clone()
        for k, g in dgrads.items():
            disc_named[k].grad = torch.from_numpy(g.copy())
        gopt.step()
        dopt.step()
    # 1e-6 of the largest parameter (O(1) values: a few f32 steps; optax and
    # torch's Adam round the update in another order)
    want_g = to_port(params)
    scale = max(float(v.abs().max()) for v in want_g.values())
    for name, want in want_g.items():
        _close(named[name].detach().numpy(), want.numpy(), scale, 1e-6, what=name)
    scale = max(float(np.abs(v).max()) for v in dparams.values())
    for k, want in dparams.items():
        _close(disc_named[k].detach().numpy(), np.asarray(want), scale, 1e-6, what=k)
    for n, p in frozen.items():
        assert torch.equal(named[n].detach(), p), n


class _Disc:
    def __init__(self, params):
        self.params = params

    def parameters(self):
        return iter(self.params.values())


def test_gan_generator_clip_is_per_group():
    """tests/test_train.py's per-group clip, on the port: an infinite
    encoder gradient does not shrink the decoder's update, and SyncNet's
    update is exactly zero."""
    cfg = default_config(env=dict(GAN, grad_clip="1.0"))
    named = {n: torch.nn.Parameter(torch.ones(4)) for n in ("encoder.w", "decoder.w", "syncnet.w")}
    opt = toptim.GanGeneratorOptimizer(cfg, _Named(named))
    named["encoder.w"].grad = torch.full((4,), float("inf"))
    named["decoder.w"].grad = torch.full((4,), 1e-3)
    named["syncnet.w"].grad = torch.full((4,), 5.0)
    opt.step()
    assert torch.equal(named["syncnet.w"].detach(), torch.ones(4))
    dec_step = (named["decoder.w"].detach() - 1).abs()
    assert torch.isfinite(dec_step).all() and (dec_step > 0.5 * cfg.learning_rate).all()


# ---------------------------------------------------------------------------
# the step


def _clipped(grads, max_norm, group):
    """optax clip_by_global_norm of each group of ``grads`` (by name)."""
    norms = {}
    for n, g in grads.items():
        norms[group(n)] = norms.get(group(n), 0.0) + float((g.double() ** 2).sum())
    return {n: g * (1.0 if norms[group(n)] ** 0.5 < max_norm
                    else max_norm / norms[group(n)] ** 0.5) for n, g in grads.items()}


def _draws(batch, n_micro, seed=10):
    """Per micro-batch: the sampler's noise, and JAX compute_loss's t and z
    for its key (out_size None: no crop draw)."""
    rng = np.random.default_rng(seed)
    rows = B // n_micro
    out, keys = [], []
    for i in range(n_micro):
        mb = _rows(batch, i * rows, (i + 1) * rows)
        key = jax.random.PRNGKey(20 + i)
        _, t, z = _jax_draws(key, mb, T_Y)
        noise = rng.standard_normal((rows, 128, T_Y)).astype(np.float32)
        out.append(dict(noise=torch.from_numpy(noise), t=torch.tensor(np.asarray(t)),
                        z=torch.tensor(np.asarray(z))))
        keys.append(key)
    return out, keys


def test_gan_step_matches_jax_pieces():
    """One step of two micro-batches: the gradients it leaves in ``.grad``
    equal the JAX D and G gradients on the same fakes and draws, averaged
    (1e-3 of the largest), and the updates equal optax's on those (1e-3 of
    the largest update).  Adam's eps is 1 here on both sides: the first
    Adam step is lr * g / (|g| + eps), the sign of g for the default eps,
    which would turn gradients at the level of f32 noise into whole
    updates; with eps 1 an update is a smooth function of its gradient.
    The learning rates are 0.1, so that an update stands well above the
    f32 spacing of the parameter it is read back from."""
    batch = _batch()
    opt = dict(gen_eps=1.0, disc_eps=1.0, learning_rate=0.1, disc_learning_rate=0.1)
    cfg, state = _port({k: str(v) for k, v in opt.items()})
    jcfg, _, _, variables, dparams = _jax_setup()
    jcfg = jcfg.replace(**opt)
    draws, keys = _draws(batch, 2)
    sample_fake, _, _ = tstep.make_gan_loss_fns(cfg)
    fakes = [sample_fake(state.model, _torch_batch(_rows(batch, 2 * i, 2 * i + 2)),
                         noise=draws[i]["noise"]).numpy() for i in range(2)]
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    d_before = {n: p.detach().clone() for n, p in state.disc.named_parameters()}

    train_step, _ = tstep.make_gan_train_step(cfg, "cpu")
    state, metrics = train_step(state, Batch(**batch), None, draws=draws)
    assert state.step == 1
    assert metrics["d_nan_skipped"].item() == metrics["g_nan_skipped"].item() == 0

    jd = _jax_d(cfg.disc_loss_type, 1)
    d_grads, g_grads, d_losses = [], [], []
    for i in range(2):
        mb = _rows(batch, 2 * i, 2 * i + 2)
        (dl, (_, (jlogits, _))), dg = jd(dparams, mb["y"], fakes[i], True)
        d_losses.append(float(dl))
        adv = float(jstep._gen_adv_loss(cfg.disc_loss_type, jlogits))
        d_grads.append(dg)
        g_grads.append(_jax_g(mb, adv, keys[i])[2])
    d_tree, g_tree = (jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) / 2, *grads)
                      for grads in (d_grads, g_grads))
    np.testing.assert_allclose(metrics["d_loss"].item(), np.mean(d_losses), rtol=1e-4)

    # .grad holds what the optimizers were handed, after their clip
    d_mean = _clipped(convert.discriminator_state_dict(d_tree), cfg.grad_clip, lambda n: "d")
    scale = max(float(v.abs().max()) for v in d_mean.values())
    for n, p in state.disc.named_parameters():
        _close(p.grad.numpy(), d_mean[n].numpy(), scale, what=n)
    g_mean = {n: v for n, v in convert.facetts_state_dict({"params": g_tree}).items()
              if not n.startswith("syncnet.")}
    _gen_grads_close({n: p.grad for n, p in state.model.named_parameters()},
                     _clipped(g_mean, cfg.grad_clip, toptim.gan_group))

    def first_update(tx, grads, params):
        return jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[0])(grads, params)

    want_d = convert.discriminator_state_dict(
        first_update(joptim.build_discriminator_optimizer(jcfg), d_tree, dparams))
    params = variables["params"]
    want_g = convert.facetts_state_dict({"params": first_update(
        joptim.build_gan_generator_optimizer(jcfg, params), g_tree, params)})
    for got, want, base in ((dict(state.disc.named_parameters()), want_d, d_before),
                            (dict(state.model.named_parameters()), want_g, before)):
        scale = max(float(v.abs().max()) for v in want.values())
        assert scale > 0
        for n, p in got.items():
            delta = (p.detach() - base[n]).numpy()
            if n.startswith("syncnet."):
                assert not delta.any(), n
                continue
            _close(delta, want[n].numpy(), scale, what=n)



def _fresh(env=None):
    """A state from ``init_state`` (weights from the seed), dropout off."""
    cfg = default_config(env=dict(GAN, **(env or {})))
    state = tstep.init_state(cfg, "cpu")
    for m in state.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return cfg, state


def _params(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def test_gan_step_warmup_leaves_disc_untouched():
    """``train_disc=False`` (the warm-up epochs): D keeps its parameters and
    gets zero gradient, ``adv_loss`` and the D metrics are 0, G trains."""
    cfg, state = _fresh()
    train_step, val_step = tstep.make_gan_train_step(cfg, "cpu")
    d0, g0 = _params(state.disc), _params(state.model)
    gen = torch.Generator().manual_seed(0)
    state, m = train_step(state, Batch(**_batch()), gen, train_disc=False, use_r1=False)
    assert all(torch.equal(p.detach(), d0[n]) for n, p in state.disc.named_parameters())
    assert all(not p.grad.any() for p in state.disc.parameters())
    for k in ("adv_loss", "d_loss", "disc_acc", "r1_penalty", "d_nan_skipped"):
        assert m[k].item() == 0, k
    moved = [n for n, p in state.model.named_parameters() if not torch.equal(p.detach(), g0[n])]
    assert any(n.startswith("encoder.") for n in moved)
    assert any(n.startswith("decoder.") for n in moved)
    assert not any(n.startswith("syncnet.") for n in moved)
    vm = val_step(state, Batch(**_batch()), gen, train_disc=False)
    assert vm["adv_loss"].item() == 0 and np.isfinite(vm["total_loss"].item())
    vm = val_step(state, Batch(**_batch()), gen)
    np.testing.assert_allclose(vm["total_loss"].item(), cfg.lambda_adv * vm["adv_loss"].item()
                               + sum(vm[k].item() for k in tstep.METRICS[:4]), rtol=1e-5)


def test_gan_step_fake_timesteps_leave_generator_identical():
    """tests/test_train.py's AUTO-4 check on the port: with the no-grad
    sampler the fake feeds only D, so the generator's update is identical
    whether the fake takes 4 reverse steps (AUTO) or all 5; D's differs."""
    out = []
    for fake_t in ("-1", "0"):
        cfg, state = _fresh(dict(timesteps="5", disc_fake_timesteps=fake_t))
        assert cfg.train_fake_timesteps == (4 if fake_t == "-1" else 5)
        train_step, _ = tstep.make_gan_train_step(cfg, "cpu")
        state, _ = train_step(state, Batch(**_batch()), torch.Generator().manual_seed(1))
        out.append((_params(state.model), _params(state.disc)))
    (g_a, d_a), (g_b, d_b) = out
    assert all(torch.equal(g_a[n], g_b[n]) for n in g_a)
    assert any(not torch.equal(d_a[n], d_b[n]) for n in d_a)


def test_gan_step_nonfinite_microbatch_adds_zero():
    """A micro-batch whose D and G losses are not finite (NaN mels) adds
    zero gradient, and the sum still divides by the number of
    micro-batches: the step's gradients are half those of the finite
    micro-batch alone, which runs first with the same draws (the clips
    set out of reach, so that ``.grad`` keeps the unclipped sums)."""
    batch = _batch()
    bad = dict(batch, y=batch["y"].copy())
    bad["y"][2:] = np.nan
    grads, metrics = [], []
    for b in (bad, _rows(batch, 0, 2)):
        cfg, state = _fresh(dict(grad_clip="1e30"))
        train_step, _ = tstep.make_gan_train_step(cfg, "cpu")
        state, m = train_step(state, Batch(**b), torch.Generator().manual_seed(2))
        grads.append({n: p.grad for n, p in list(state.disc.named_parameters())
                      + list(state.model.named_parameters()) if p.grad is not None})
        metrics.append(m)
        assert all(torch.isfinite(p).all() for p in state.model.parameters())
        assert all(torch.isfinite(p).all() for p in state.disc.parameters())
    assert metrics[0]["d_nan_skipped"].item() == metrics[0]["g_nan_skipped"].item() == 0.5
    assert metrics[1]["d_nan_skipped"].item() == metrics[1]["g_nan_skipped"].item() == 0
    np.testing.assert_allclose(metrics[0]["d_loss"].item(), metrics[1]["d_loss"].item() / 2,
                               rtol=1e-6)
    assert set(grads[0]) == set(grads[1])
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n] / 2), n


def test_gan_step_refuses_bad_micro_batches():
    with pytest.raises(ValueError, match="micro_batch_size_gen"):
        tstep.make_gan_train_step(default_config(env=dict(GAN, micro_batch_size_gen="3")), "cpu")
    tstep.make_gan_train_step(default_config(env=dict(GAN, micro_batch_size_gen="2")), "cpu")
    tb = _torch_batch(_batch())
    n, micro = tstep._micro_split(tb, 2)
    assert n == 2 and [m.x.shape[0] for m in micro] == [2, 2]
    assert torch.equal(micro[1].y, tb.y[2:])
    n, micro = tstep._micro_split(tb, 8)
    assert n == 1 and micro[0].x.shape[0] == B
    with pytest.raises(ValueError, match="micro_batch_size"):
        tstep._micro_split(tb, 3)


@pytest.mark.parametrize("interval", [1, 4])
def test_loop_use_r1_follows_interval(interval):
    cfg = default_config(env=dict(GAN, r1_interval=str(interval), warmup_disc_epochs="1",
                                  freeze_gen_epochs="2", r1_start_epoch="1"))
    assert cfg.effective_r1_gamma == cfg.r1_gamma * interval
    assert gan_flags(cfg, 0, 0) == {"train_disc": False, "train_gen": False, "use_r1": False}
    flags = [gan_flags(cfg, 2, s) for s in range(8)]
    assert all(f["train_disc"] and f["train_gen"] for f in flags)
    assert [f["use_r1"] for f in flags] == [s % interval == 0 for s in range(8)]
    assert not any(f["use_r1"] for f in (gan_flags(cfg.replace(use_r1_penalty=0), 2, s)
                                         for s in range(8)))


def test_gan_train_entry_point_cpu(tmp_path):
    """``python -m facegantts_tpu_torch.train`` with the Config default
    ``use_gan=1`` (face mode, the sampler in bf16) at TINY widths and short
    buckets: two steps of two micro-batches and the GAN validation."""
    args = [f"{k}={v}" for k, v in GAN.items() if k != "spk_emb"] + [
        "device=cpu", "max_steps=2", "batch_size=4", "num_gpus=1", "log_every_n_steps=1",
        "mel_buckets=64", "text_buckets=32", f"work_dir={tmp_path}"]
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "facegantts_tpu_torch.train", *args],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "use_gan=1" in out.stdout
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train/g_loss" in r]
    assert [r["step"] for r in train] == [1, 2]
    for r in train:
        for k in ("d_loss", "r1_penalty", "disc_acc", "adv_loss", "g_loss", "g_guard_loss",
                  "duration_loss", "prior_loss", "diffusion_loss", "spk_loss"):
            assert np.isfinite(r[f"train/{k}"]), (k, r)
        assert r["train/r1_penalty"] > 0 and r["train/d_nan_skipped"] == 0
    val = [r for r in recs if "val/total_loss" in r]
    assert val and np.isfinite(val[-1]["val/total_loss"]) and np.isfinite(val[-1]["val/adv_loss"])
