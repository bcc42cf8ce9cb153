"""The PyTorch port's training slice against the JAX package, on the CPU.

- MAS: the plain version (``maximum_path_ref``) equals JAX ``maximum_path``
  exactly (ragged lengths, T_x = T_y, length-1 edges, ties);
- ``FaceTTS.compute_loss``: the four parts match ``jax.value_and_grad`` of
  the JAX ``compute_loss(deterministic=True)`` to rtol 1e-4 and the
  gradients to 1e-3 of the largest gradient (sums in another order through
  the encoder, U-Net and SyncNet), in both ``spk_emb`` modes at the JAX
  train tests' TINY dims.  torch cannot reproduce ``jax.random``, so the
  test replays JAX's key splits outside the model and injects the crop
  offset, the diffusion time and the noise;
- the optimizer: schedules, the clip (frozen gradients included) and each
  optimizer match optax over 3 steps to 1e-6 relative on the same gradients;
- ``python -m facegantts_tpu_torch.train device=cpu`` runs at TINY.

Weights are seeded numpy values carried into the port by
``facegantts_tpu_torch.convert``; torch runs strict f32 (no TF32)."""

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
from facegantts_tpu.models.facetts import FaceTTS as JFaceTTS
from facegantts_tpu.ops.mas import maximum_path as jax_maximum_path
from facegantts_tpu.train import optim as joptim
from facegantts_tpu_torch import convert
from facegantts_tpu_torch.config import default_config
from facegantts_tpu_torch.models.facetts import FaceTTS
from facegantts_tpu_torch.ops import kernels
from facegantts_tpu_torch.ops import mas as tmas
from facegantts_tpu_torch.train import optim as toptim
from torch_cpu import torch_threads_started  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the generator part of tests/test_train.py's TINY
TINY = dict(
    n_enc_channels="16", filter_channels="32", filter_channels_dp="16",
    n_enc_layers="1", dec_dim="8", vid_emb_dim="32", timesteps="2",
    learning_rate="1e-4", warmup_steps="0", syncnet_width_mult="0.125",
    spk_emb="speech", use_gan="0",
)
OUT_SIZE = 16  # crop of the parity batch (its mels are 32 frames)


@pytest.fixture(autouse=True)
def _strict_f32():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# MAS: exact


def _mas_case(b, t_x, t_y, tx, ty, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:  # small integers: many equal predecessors, the tie-break decides
        value = rng.integers(-2, 3, (b, t_x, t_y)).astype(np.float32)
    else:
        value = (rng.standard_normal((b, t_x, t_y)) * 3).astype(np.float32)
    mask = ((np.arange(t_x)[None, :, None] < np.asarray(tx)[:, None, None])
            & (np.arange(t_y)[None, None, :] < np.asarray(ty)[:, None, None]))
    return value, mask.astype(np.float32)


MAS_CASES = {
    "ragged": (4, 12, 40, [12, 7, 3, 9], [40, 33, 9, 30], False),
    "tx_eq_ty": (3, 16, 16, [16, 10, 4], [16, 10, 4], False),
    "length_one": (4, 6, 10, [1, 1, 6, 2], [1, 7, 6, 2], False),
    "ties": (3, 10, 30, [10, 8, 5], [30, 21, 5], True),
}


@pytest.mark.parametrize("case", sorted(MAS_CASES))
def test_maximum_path_ref_equals_jax(case):
    b, t_x, t_y, tx, ty, ties = MAS_CASES[case]
    value, mask = _mas_case(b, t_x, t_y, tx, ty, seed=len(case), ties=ties)
    want = np.asarray(jax_maximum_path(jnp.asarray(value), jnp.asarray(mask)))
    before = kernels.LAUNCHES[tmas.NAME]
    got = tmas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask)).numpy()
    assert kernels.LAUNCHES[tmas.NAME] == before  # CPU: the plain version
    np.testing.assert_array_equal(got, want)
    # a monotonic path: one text position per mel frame inside the mask
    np.testing.assert_array_equal(got.sum(1), mask[:, 0, :])


def test_maximum_path_wrapper_refuses_other_devices():
    x = torch.zeros(1, 4, 6, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tmas.maximum_path(x, x)


# ---------------------------------------------------------------------------
# compute_loss: parts and gradients


def _random_variables(module, *args, seed, method=None):
    """Variables of the tree ``init`` would make (traced with eval_shape,
    nothing compiled), filled from seeded numpy at init-like scales;
    BatchNorm statistics off their defaults."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, method=method))
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        name, shape = path[-1], leaf.shape
        if name in ("scale", "gamma"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "mean":
            v = rng.uniform(-0.3, 0.3, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1])) if name != "embedding" else shape[-1]
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        else:
            v = 0.1 * rng.standard_normal(shape)
        out[path] = np.asarray(v, np.float32)
    return traverse_util.unflatten_dict(out)


def _loss_batch(mode, seed=0):
    rng = np.random.default_rng(seed)
    b, t_x, t_y = 3, 8, 32
    spk = (rng.standard_normal((b, 224, 224, 3)) * 0.1 if mode == "face"
           else rng.standard_normal((b, 128, t_y)))
    return dict(
        x=rng.integers(1, 100, (b, t_x)).astype(np.int32),
        x_len=np.array([8, 6, 5], np.int32),
        y=rng.standard_normal((b, 128, t_y)).astype(np.float32),
        y_len=np.array([32, 27, 20], np.int32),
        spk=spk.astype(np.float32),
    )


def _jax_draws(rng, batch, out_size):
    """JAX compute_loss's draws, by its own key splits (facetts.py:296-313,
    diffusion.py:96,167-171)."""
    b, n_feats, t_y = batch["y"].shape
    offset = None
    if out_size < t_y:
        rng, rng_off = jax.random.split(rng)
        u = jax.random.uniform(rng_off, (b,))
        offset = (u * jnp.maximum(jnp.asarray(batch["y_len"]) - out_size, 0)).astype(jnp.int32)
    rng, rng_diff = jax.random.split(rng)
    rng_t, rng_z = jax.random.split(rng_diff)
    t = jax.random.uniform(rng_t, (b,), jnp.float32, minval=1e-5, maxval=1.0 - 1e-5)
    z = jax.random.normal(rng_z, (b, n_feats, min(out_size, t_y)), jnp.float32)
    return offset, t, z


@pytest.mark.parametrize("mode", ["speech", "face"])
def test_compute_loss_matches_jax(mode):
    env = dict(TINY, spk_emb=mode)
    jcfg, cfg = jax_default_config(env=env), default_config(env=env)
    batch = _loss_batch(mode)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JFaceTTS.from_config(jcfg)
    args = (jb["x"], jb["x_len"], jb["y"], jb["y_len"], jb["spk"], OUT_SIZE)
    variables = _random_variables(jm, jax.random.PRNGKey(1), *args, seed=3,
                                  method=JFaceTTS.compute_loss)
    rng = jax.random.PRNGKey(7)

    def loss(params):
        parts, aux = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              rng, *args, deterministic=True, method=JFaceTTS.compute_loss)
        return parts.total, (parts, aux["attn"])

    (_, (jparts, jattn)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])

    model = FaceTTS.from_config(cfg).eval()
    sd = convert.facetts_state_dict(variables)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected
    # speech mode never runs the image stream, so JAX has no variables for it
    absent = () if mode == "face" else ("syncnet.netcnnimg.", "syncnet.netfcimg.")
    assert all(k.startswith(absent) for k in missing) and (mode == "speech") == bool(missing)

    offset, t, z = _jax_draws(rng, batch, OUT_SIZE)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    parts, aux = model.compute_loss(
        tb["x"], tb["x_len"], tb["y"], tb["y_len"], tb["spk"], OUT_SIZE,
        offset=torch.tensor(np.asarray(offset)), t=torch.tensor(np.asarray(t)),
        z=torch.tensor(np.asarray(z)))
    # a near-tie in the log-prior could flip MAS between frameworks: the
    # paths must be identical before the losses mean anything
    np.testing.assert_array_equal(aux["attn"].numpy(), np.asarray(jattn))
    for got, want in zip(parts, jparts):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    parts.total.backward()

    want = convert.facetts_state_dict({"params": jgrads})
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(want) <= set(grads)
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for name, g in grads.items():
        if name not in want:
            assert g is None, name  # the stream the mode never runs
            continue
        got = np.zeros(want[name].shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(got, want[name].numpy(), rtol=0, atol=1e-3 * scale,
                                   err_msg=name)


def test_compute_loss_fused_gn_mish_matches_plain(monkeypatch):
    """With ``fused_gn_mish=1`` the U-Net's GroupNorm -> Mish -> mask goes
    through K1's autograd Function (on the CPU: the plain forward and the
    closed-form backward, ``gn_mish_mask_bwd``): the losses and every
    gradient match the plain modules' (``fused_gn_mish=0``, held to JAX by
    test_compute_loss_matches_jax) on the same weights and draws, to 1e-5
    of the largest gradient (f32 sums in another order)."""
    from facegantts_tpu_torch.ops import gn_mish as tgn

    calls = []
    bwd = tgn.gn_mish_mask_bwd
    monkeypatch.setattr(tgn, "gn_mish_mask_bwd", lambda *a: calls.append(1) or bwd(*a))
    batch = {k: torch.from_numpy(v) for k, v in _loss_batch("speech").items()}
    rng = np.random.default_rng(5)
    b, n_feats, _ = batch["y"].shape
    draws = dict(offset=torch.tensor([5, 11, 4], dtype=torch.int32),
                 t=torch.from_numpy(rng.uniform(0.05, 0.95, b).astype(np.float32)),
                 z=torch.from_numpy(rng.standard_normal((b, n_feats, OUT_SIZE)).astype(np.float32)))
    results = []
    for fused in ("0", "1"):
        torch.manual_seed(0)
        model = FaceTTS.from_config(default_config(env=dict(TINY, fused_gn_mish=fused))).eval()
        if results:
            model.load_state_dict(results[0][2])
        parts, _ = model.compute_loss(batch["x"], batch["x_len"], batch["y"], batch["y_len"],
                                      batch["spk"], OUT_SIZE, **draws)
        parts.total.backward()
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        results.append((parts, grads, model.state_dict()))
    assert len(calls) == 25  # K1 calls of one U-Net evaluation, each with its backward
    (plain, plain_grads, _), (fused, fused_grads, _) = results
    for got, want in zip(fused, plain):
        np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    assert set(fused_grads) == set(plain_grads)
    scale = max(g.abs().max().item() for g in plain_grads.values())
    for name, g in fused_grads.items():
        np.testing.assert_allclose(g.numpy(), plain_grads[name].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


# ---------------------------------------------------------------------------
# optimizer


@pytest.mark.parametrize("sel", ["cosine", "linear", "constant", "1.0", "2.0"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_matches_optax(sel, warmup):
    env = dict(TINY, learning_rate="1e-3", end_lr="1e-5", decay_power=sel,
               warmup_steps=str(warmup), max_steps="12")
    want = joptim.build_schedule(jax_default_config(env=env))
    got = toptim.build_schedule(default_config(env=env))
    # optax evaluates in f32: near the end of the cosine the value keeps
    # fewer digits, so the absolute bar is 1e-6 of the peak rate
    for n in range(16):
        np.testing.assert_allclose(got(n), float(want(n)), rtol=1e-6, atol=1e-9)


def _optimizers_agree(env, params, named, to_port, frozen_prefix):
    """The same gradients through optax and the port's optimizer for 3
    steps (warm-up 2, so step 0 runs at learning rate 0): the norms, the
    clip with the frozen gradients in it, the parameters, the frozen ones."""
    jcfg, cfg = jax_default_config(env=env), default_config(env=env)
    tx = joptim.build_generator_optimizer(jcfg, params)
    opt_state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    opt = toptim.GeneratorOptimizer(cfg, _Named(named))
    frozen = {n: p.detach().clone() for n, p in named.items() if n.startswith(frozen_prefix)}
    if cfg.optim_type != "adam_diff":
        assert frozen and set(frozen) == set(opt.frozen)

    rng = np.random.default_rng(11)
    for scale in (0.5, 0.05, 0.001):  # clipped, clipped, not clipped
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
                             params)
        params, opt_state = update(grads, opt_state, params)
        opt.zero_grad()
        for name, g in to_port(grads).items():
            named[name].grad = g.clone()
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)

    want = to_port(params)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        if cfg.optim_type != "adam_diff" and name in frozen:
            assert torch.equal(p.detach(), frozen[name]), name


class _Named:
    """Stands in for a model: the optimizer reads only named_parameters()."""

    def __init__(self, params):
        self.params = params

    def named_parameters(self):
        return iter(self.params.items())


# a few leaves under the JAX names the partitions look at, and the port's
_SMALL = {
    ("encoder", "emb", "embedding"): ("encoder.emb.weight", (5, 3)),
    ("decoder", "estimator", "mlp_1", "bias"): ("decoder.estimator.mlp.0.bias", (4,)),
    ("syncnet", "aud_c1", "conv", "kernel"): ("syncnet.netcnnaud.0.weight", (3, 2)),
    ("syncnet", "aud_head", "fc1", "bias"): ("syncnet.netfcaud.0.bias", (4,)),
    ("syncnet", "img_c1", "bn", "scale"): ("syncnet.netcnnimg.1.weight", (3,)),
}


@pytest.mark.parametrize("optim_type", ["adam", "adamw", "sgd", "adam_diff"])
def test_optimizer_matches_optax(optim_type):
    env = dict(TINY, optim_type=optim_type, learning_rate="1e-2", warmup_steps="2",
               max_steps="10", grad_clip="1.0")
    rng = np.random.default_rng(4)
    flat = {path: rng.standard_normal(shape).astype(np.float32)
            for path, (_, shape) in _SMALL.items()}

    def to_port(tree):
        return {_SMALL[path][0]: torch.tensor(np.asarray(v))
                for path, v in traverse_util.flatten_dict(tree).items()}

    named = {n: torch.nn.Parameter(v) for n, v in to_port(
        traverse_util.unflatten_dict(flat)).items()}
    _optimizers_agree(env, traverse_util.unflatten_dict(flat), named, to_port,
                      "syncnet.netcnnaud.")


def test_optimizer_full_model_matches_optax():
    """The default optimizer over the whole FaceTTS, gradients carried
    under the port's names by convert.facetts_state_dict: the JAX frozen
    partition (``aud_c*``) is the port's ``syncnet.netcnnaud``."""
    env = dict(TINY, spk_emb="face", learning_rate="1e-2", warmup_steps="2",
               max_steps="10", grad_clip="1.0")
    batch = {k: jnp.asarray(v) for k, v in _loss_batch("face").items()}
    variables = _random_variables(
        JFaceTTS.from_config(jax_default_config(env=env)), jax.random.PRNGKey(1),
        batch["x"], batch["x_len"], batch["y"], batch["y_len"], batch["spk"], OUT_SIZE,
        seed=5, method=JFaceTTS.compute_loss)
    model = FaceTTS.from_config(default_config(env=env))
    model.load_state_dict(convert.facetts_state_dict(variables), strict=True)
    _optimizers_agree(env, variables["params"], dict(model.named_parameters()),
                      lambda tree: convert.facetts_state_dict({"params": tree}),
                      "syncnet.netcnnaud.")


# ---------------------------------------------------------------------------
# entry point


def test_train_entry_point_cpu(tmp_path):
    args = [f"{k}={v}" for k, v in TINY.items()] + [
        "device=cpu", "use_gan=0", "max_steps=2", "batch_size=2", "num_gpus=1",
        "log_every_n_steps=1", f"work_dir={tmp_path}"]
    # one thread, as the test process runs torch: at the host's thread count
    # the subprocess contends with the other test workers for the cores
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "facegantts_tpu_torch.train", *args],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train/total_loss" in r]
    assert [r["step"] for r in train] == [1, 2]
    for r in train:
        for k in ("duration_loss", "prior_loss", "diffusion_loss", "spk_loss", "total_loss",
                  "grad_norm"):
            assert np.isfinite(r[f"train/{k}"]), (k, r)
    val = [r for r in recs if "val/total_loss" in r]
    assert val and np.isfinite(val[-1]["val/total_loss"]) and val[-1]["val/batches"] >= 1


@pytest.mark.parametrize("option, value", [
    ("train_bf16", "1"), ("use_spectral_norm", "1"), ("disc_family", "tpu_opt"),
    ("disc_bf16", "1"), ("adv_grad_through_sampler", "1"), ("grad_remat", "1")])
def test_train_refuses_gan_and_bf16(option, value, tmp_path):
    """The GAN trainer under each of these options: the four the port runs
    (mixed precision, the bf16 D phase, the differentiable sampler, remat)
    take one step of ``train()`` at TINY on the CPU and log finite metrics,
    and ``train_bf16`` also runs the plain step; the spectral-norm and
    ``tpu_opt`` discriminators still raise by name, before anything is
    built (the JAX package's GAN step cannot run spectral norm)."""
    from facegantts_tpu_torch.data.dataset import SyntheticDataset
    from facegantts_tpu_torch.train.loop import train
    from facegantts_tpu_torch.train.step import make_plain_train_step

    env = dict(TINY, use_gan="1", disc_base_channels="8", disc_num_layers="2",
               kernel_height="5", kernel_width="3", disc_padding="2", micro_batch_size="2",
               spk_emb="face", batch_size="4", num_gpus="1", log_every_n_steps="1",
               mel_buckets="64", text_buckets="32", **{option: value})
    if option in ("use_spectral_norm", "disc_family"):
        why = "JAX package's GAN step cannot run" if option == "use_spectral_norm" else (
            "not ported yet")
        with pytest.raises(NotImplementedError, match=f"{option}={value}: .*{why}"):
            train(default_config(env=env), device="cpu")
        return
    kw = dict(n_mels=128, min_frames=40, max_frames=60)
    data = SyntheticDataset(n_items=4, **kw), SyntheticDataset(n_items=4, seed=1, **kw)
    uses = ["1", "0"] if option == "train_bf16" else ["1"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the parallel test run shares the host's cores
    try:
        for use_gan in uses:
            train(default_config(env=dict(env, use_gan=use_gan)), str(tmp_path / use_gan), 1,
                  *data, device="cpu")
    finally:
        torch.set_num_threads(threads)
    for use_gan in uses:
        work = tmp_path / use_gan
        with open(work / "metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        step = [r for r in recs if "train/total_loss" in r or "train/g_loss" in r]
        assert [r["step"] for r in step] == [1]
        vals = {k: v for k, v in step[0].items() if k.startswith("train/")}
        assert vals and all(np.isfinite(v) for v in vals.values()), vals
    if option == "train_bf16":
        make_plain_train_step(default_config(env=dict(TINY, train_bf16="1")), "cpu")
