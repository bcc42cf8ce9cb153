"""The PyTorch port's mixed-precision and GAN options against the JAX
package, on the CPU.

- MAS on a bf16 log-prior: the path of JAX's ``maximum_path``, in bf16;
- ``train_bf16``: the plain step's loss (bf16 parameters and model state
  through ``train/precision.py``, the parts back in f32) against JAX's
  ``down``/``up`` loss with the same draws and dropout off, next to each
  framework's bf16 distance from its own f32 result;
- ``disc_bf16``: ``d_loss_fn`` with and without R1 against JAX's;
- ``adv_grad_through_sampler``: the G phase, which resamples its fake with
  gradient, against ``jax.grad`` of JAX's G loss (sampler in f32: the G
  phase's bar, 1e-3 of the largest gradient; in bf16 a bf16 bar);
- ``grad_remat``: the gradients of both phases equal those without remat,
  with dropout live, R1 on and the draws injected or drawn;
- a whole GAN step and the trainer under each option, master parameters and
  optimizer state f32;
- the discriminator's speaker-embedding input against the JAX module.

Weights are seeded numpy values carried into the port by
``facegantts_tpu_torch.convert``; torch runs strict f32 (no TF32).  JAX runs
its loss pieces jitted (``tests/test_torch_gan.py``'s TINY generator and
small discriminator), not whole steps."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facegantts_tpu.models.discriminator import SpectrogramDiscriminator as JDisc
from facegantts_tpu.models.facetts import FaceTTS as JFaceTTS
from facegantts_tpu.ops.mas import maximum_path as jax_maximum_path
from facegantts_tpu.train import step as jstep
from facegantts_tpu_torch import convert
from facegantts_tpu_torch.config import default_config
from facegantts_tpu_torch.models.discriminator import SpectrogramDiscriminator
from facegantts_tpu_torch.ops import mas as tmas
from facegantts_tpu_torch.train import precision
from facegantts_tpu_torch.train import step as tstep
from facegantts_tpu_torch.train.state import Batch
from test_torch_gan import GAN, T_Y, _batch, _jax_setup, _port, _rows, _torch_batch
from test_torch_train import MAS_CASES, _mas_case
from torch_cpu import torch_threads_started  # noqa: F401

BF16 = torch.bfloat16
OUT = 16  # the plain step's crop here (the batch's mels are 32 frames)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread, as in tests/test_torch_gan.py: the parallel
    test run starts several workers on one host."""
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


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(dtype)


def _max_frac(got, want):
    """max |got - want| over the largest |want|, over the common names."""
    scale = max(float(w.abs().max()) for w in want.values())
    return max(float((got[n].float() - w).abs().max()) for n, w in want.items()) / scale


def _gen_grads(model):
    """The generator's gradients by name, SyncNet's absent (frozen)."""
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
            for n, p in model.named_parameters() if not n.startswith("syncnet.")}


def _want_grads(jgrads):
    return {n: v for n, v in convert.facetts_state_dict({"params": jgrads}).items()
            if not n.startswith("syncnet.")}


# ---------------------------------------------------------------------------
# MAS


@pytest.mark.parametrize("case", sorted(MAS_CASES))
def test_maximum_path_bf16_matches_jax(case):
    """A bf16 log-prior upcasts to f32 on both sides: the same path, in bf16."""
    b, t_x, t_y, tx, ty, ties = MAS_CASES[case]
    value, mask = _mas_case(b, t_x, t_y, tx, ty, seed=len(case) + 1, ties=ties)
    jv = jnp.asarray(value, jnp.bfloat16)
    want = jax_maximum_path(jv, jnp.asarray(mask, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    got = tmas.maximum_path(_t(jv, BF16), torch.from_numpy(mask).to(BF16))
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# train_bf16: the plain step's loss


@contextlib.contextmanager
def _jax_draws_injected(t, z):
    """JAX's ``Diffusion.compute_loss`` draws t and z inside the model;
    while a JAX loss is traced here they are these values instead, in the
    dtype it asks for (the crop offset is still drawn)."""
    uniform, normal = jax.random.uniform, jax.random.normal

    def fake_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if minval == 1e-5:  # Diffusion.compute_loss's t
            return jnp.asarray(t, dtype)
        return uniform(key, shape, dtype, minval, maxval)

    def fake_normal(key, shape=(), dtype=jnp.float32):
        assert tuple(shape) == z.shape
        return jnp.asarray(z, dtype)

    jax.random.uniform, jax.random.normal = fake_uniform, fake_normal
    try:
        yield
    finally:
        jax.random.uniform, jax.random.normal = uniform, normal


def _jax_plain_loss(bf16, inject=None):
    """value_and_grad of the JAX plain step's loss (``loss_fn`` of
    ``make_plain_train_step`` with dropout off) through its ``_mp_caster``;
    also the log-prior and the path of its MAS."""
    import facegantts_tpu.models.facetts as jfacetts

    jcfg, jm, _, variables, _ = _jax_setup()
    down, up = jstep._mp_caster(jcfg.replace(train_bf16=int(bf16)))
    b = {k: jnp.asarray(v) for k, v in _batch().items()}
    rng = jax.random.PRNGKey(7)
    seen = {}

    def recording(value, mask):
        path = mas(value, mask)
        jax.debug.callback(lambda v, a: seen.update(value=np.asarray(v, np.float32),
                                                    path=np.asarray(a, np.float32)), value, path)
        return path

    def loss(params):
        parts, _ = jm.apply({"params": down(params), **down({"batch_stats":
                                                             variables["batch_stats"]})},
                            rng, b["x"], b["x_len"], down(b["y"]), b["y_len"], down(b["spk"]),
                            OUT, deterministic=True, method=JFaceTTS.compute_loss)
        parts = up(parts)
        return parts.total, parts

    mas = jfacetts.maximum_path
    jfacetts.maximum_path = recording
    try:
        with _jax_draws_injected(*inject) if inject else contextlib.nullcontext():
            (_, parts), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                variables["params"])
    finally:
        jfacetts.maximum_path = mas
    return np.array([float(p) for p in parts]), seen, _want_grads(grads)


def _jax_bf16_draws(batch, rng):
    """JAX compute_loss's draws under train_bf16 (t and z in the mels'
    dtype, bf16; the crop offset f32), by its own key splits."""
    b, n_feats, _ = batch["y"].shape
    rng, rng_off = jax.random.split(rng)
    u = jax.random.uniform(rng_off, (b,))
    offset = (u * jnp.maximum(jnp.asarray(batch["y_len"]) - OUT, 0)).astype(jnp.int32)
    _, rng_diff = jax.random.split(rng)
    rng_t, rng_z = jax.random.split(rng_diff)
    t = jax.random.uniform(rng_t, (b,), jnp.bfloat16, minval=1e-5, maxval=1.0 - 1e-5)
    z = jax.random.normal(rng_z, (b, n_feats, OUT), jnp.bfloat16)
    return np.asarray(offset), np.asarray(t.astype(jnp.float32)), np.asarray(
        z.astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _layer_names():
    """JAX module path -> the port's module name, for every layer with
    parameters of the generator: convert's name map, read by marking each
    JAX parameter with its index."""
    _, _, _, variables, _ = _jax_setup()
    leaves, tree = jax.tree_util.tree_flatten_with_path(variables["params"])
    paths = ["/".join(str(k.key) for k in p) for p, _ in leaves]
    marked = jax.tree_util.tree_unflatten(
        tree, [np.full(np.shape(v), i, np.float32) for i, (_, v) in enumerate(leaves)])
    names = {}
    for name, t in convert.facetts_state_dict({"params": marked}).items():
        (i,) = np.unique(np.asarray(t))
        names[paths[int(i)].rsplit("/", 1)[0]] = name.rsplit(".", 1)[0]
    return names


@functools.lru_cache(maxsize=None)
def _jax_layer_dtypes():
    """The dtypes of each JAX layer's outputs in the ``train_bf16`` loss
    (``capture_intermediates``), by module path."""
    jcfg, jm, _, variables, _ = _jax_setup()
    down, _ = jstep._mp_caster(jcfg.replace(train_bf16=1))
    b = {k: jnp.asarray(v) for k, v in _batch().items()}
    _, captured = jm.apply(
        {"params": down(variables["params"]), **down({"batch_stats": variables["batch_stats"]})},
        jax.random.PRNGKey(7), b["x"], b["x_len"], down(b["y"]), b["y_len"], down(b["spk"]), OUT,
        deterministic=True, method=JFaceTTS.compute_loss, capture_intermediates=True,
        mutable=["intermediates"])
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(captured["intermediates"])[0]:
        keys = [str(k.key) for k in path if hasattr(k, "key")]
        out.setdefault("/".join(keys[:keys.index("__call__")]), set()).add(str(v.dtype))
    return out


@contextlib.contextmanager
def _port_layer_dtypes(model):
    """The dtypes of the port's layer outputs while the block runs, by the
    JAX module path of the layer."""
    seen = {}
    modules = dict(model.named_modules())
    hooks = [modules[name].register_forward_hook(
        lambda m, a, out, path=path: seen.setdefault(path, set()).add(
            str(out.dtype).replace("torch.", "")))
        for path, name in _layer_names().items()]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


DUR_HEAD = "encoder.proj_w."  # the duration predictor


def test_train_bf16_loss_matches_jax(monkeypatch):
    """The plain step's ``train_bf16`` loss: bf16 parameters and model
    state, flax's promotion (the encoder from its first attention on and
    the U-Net compute in f32 with bf16 weights, SyncNet's image stream and
    the prenet in bf16), the log-prior in f32 and the parts in f32.

    The log-prior sums f32 products of values that bf16 noise upstream
    moves (torch rounds every bf16 op, XLA keeps fused chains in f32), so
    MAS can turn at a near-tie: the port's log-prior is held to JAX's within
    2^-7 of its largest magnitude (two bf16 steps of the rounded squared
    norms), and the losses are compared on JAX's path, which the port's MAS
    gives exactly from JAX's log-prior (tests/test_torch_train.py).  Bars,
    with each framework's bf16 distance from its own f32 result (same draws)
    printed beside them: each loss part within 5e-3 relative of JAX's;
    every gradient outside the duration predictor within 2^-6 of the largest
    JAX gradient (measured <= 0.0098 over five batches); the duration
    predictor's within 2^-3 (measured <= 0.075: its gradient scales with
    logw - logw_, which that noise moves, as bf16 moves JAX's own gradient
    by 0.057 of the largest here).

    These bars do not tell a bf16 port from one that ignores the option:
    the port's bf16 is no nearer JAX's bf16 than its f32 is (the trunk's
    gradients 0.0055 of the largest either way), because two bf16
    computations that round at different points (torch after every op, XLA
    after every fusion) differ by about as much as either differs from f32.
    So the precision itself is held layer by layer: each of the generator's
    132 layers with parameters (convert's name map) gives its output in the
    dtypes JAX's gives it: bf16 in 27 (the embedding, the prenet, the first
    attention's q, k and v, the U-Net's time and speaker MLPs), bf16 and f32
    in SyncNet's 15 audio layers (called on a bf16 and an f32 mel), f32 in
    the other 90."""
    from facegantts_tpu_torch.models import facetts as tfacetts

    batch = _batch()
    offset, t, z = _jax_bf16_draws(batch, jax.random.PRNGKey(7))
    jparts16, seen16, jg16 = _jax_plain_loss(True)
    jparts32, _, jg32 = _jax_plain_loss(False, inject=(t, z))
    seen = {}

    def jax_path(value, mask):
        seen["value"] = value.float().numpy()
        np.testing.assert_array_equal(tmas.maximum_path(torch.from_numpy(seen16["value"]),
                                                        mask.float()).numpy(), seen16["path"])
        return torch.from_numpy(seen16["path"]).to(value.dtype)

    monkeypatch.setattr(tfacetts, "maximum_path", jax_path)
    cfg, state = _port(dict(train_bf16="1"))
    model = state.model.eval()
    down, up, call = precision.mp_caster(True)
    tb = _torch_batch(batch)
    got = {}
    for bf16 in (True, False):
        model.zero_grad()
        draws = dict(offset=torch.from_numpy(offset), t=_t(t), z=_t(z))
        if bf16:
            draws = {k: down(v) for k, v in draws.items()}
            with _port_layer_dtypes(model) as dtypes:
                parts, _ = call(model, tb.x, tb.x_len, down(tb.y), tb.y_len, down(tb.spk), OUT,
                                method="compute_loss", **draws)
            parts = up(parts)
            value16 = seen["value"]
        else:
            parts, _ = model.compute_loss(tb.x, tb.x_len, tb.y, tb.y_len, tb.spk, OUT, **draws)
        assert all(p.dtype == torch.float32 for p in parts)
        parts.total.backward()
        assert all(p.grad.dtype == torch.float32 for p in model.parameters()
                   if p.grad is not None)
        got[bf16] = np.array([p.item() for p in parts]), _gen_grads(model)
    (parts16, g16), (parts32, g32) = got[True], got[False]
    prior = np.abs(value16 - seen16["value"]).max() / np.abs(seen16["value"]).max()
    rel = np.abs(parts16 - jparts16) / np.abs(jparts16)
    print(f"log-prior: port vs JAX (bf16) {prior:.2e} of the largest")
    print(f"parts: port vs JAX (bf16) {rel}; port bf16 vs f32 "
          f"{np.abs(parts16 - parts32) / np.abs(parts32)}; JAX bf16 vs f32 "
          f"{np.abs(jparts16 - jparts32) / np.abs(jparts32)}")
    trunk = {n for n in jg16 if not n.startswith(DUR_HEAD)}
    head = set(jg16) - trunk
    for name, names, bar in (("trunk", trunk, 2**-6), ("duration head", head, 2**-3)):
        scale = max(float(jg16[n].abs().max()) for n in jg16)
        frac = max(float((g16[n] - jg16[n]).abs().max()) for n in names) / scale
        own = {k: max(float((a[n] - b[n]).abs().max()) for n in names) / scale
               for k, (a, b) in (("port", (g16, g32)), ("JAX", (jg16, jg32)))}
        print(f"{name} grads (of the largest): port vs JAX (bf16) {frac:.4f}; bf16 vs f32: "
              f"port {own['port']:.4f}, JAX {own['JAX']:.4f}")
        assert frac < bar, (name, frac)
    want_dtypes = _jax_layer_dtypes()
    assert len(dtypes) == len(_layer_names()) == 132
    assert {p: want_dtypes[p] for p in dtypes} == dtypes
    assert sum(d == {"bfloat16"} for d in dtypes.values()) == 27
    assert sum(len(d) == 2 for d in dtypes.values()) == 15
    assert dtypes["encoder/prenet/conv_0"] == {"bfloat16"}
    assert prior < 2**-7, prior
    assert rel.max() < 5e-3, rel
    # the f32 loss of the same draws holds JAX's f32 loss to the f32 bars
    np.testing.assert_allclose(parts32, jparts32, rtol=1e-4)
    assert _max_frac(g32, jg32) < 1e-3


def jax_layer_dtypes(fn, *args, **kwargs):
    """Run ``fn`` (it must trace anew) with every flax ``__call__`` recorded:
    the dtypes of each module's outputs, by module path (relative to the
    module that ``apply`` was called on).  Unlike ``capture_intermediates``
    this also sees the modules inside ``nn.scan`` (the sampler's U-Net)."""
    import flax.linen as nn

    seen = {}

    def record(f, a, k, ctx):
        out = f(*a, **k)
        if ctx.method_name == "__call__":
            for leaf in jax.tree.leaves(out):
                if hasattr(leaf, "dtype"):
                    seen.setdefault("/".join(ctx.module.path), set()).add(str(leaf.dtype))
        return out

    with nn.intercept_methods(record):
        out = fn(*args, **kwargs)
    return out, seen


def test_sample_fake_bf16_layer_dtypes_match_jax():
    """The no-grad GAN sampler with ``gan_sampler_bf16`` (the default) gives
    each of the generator's layers with parameters the output dtype that
    JAX's ``sample_fake`` gives it (JAX's U-Net recorded inside its
    ``nn.scan``): bf16 in the 28 layers of SyncNet's image stream, the
    embedding, the prenet, the first attention's q, k and v and the U-Net's
    time and speaker MLPs; f32 in the other 104, K1's chains included.  An
    all-bf16 sampler fails here (every layer bf16)."""
    jcfg, jm, _, variables, _ = _jax_setup()
    mb = _rows(_batch(), 0, 2)
    noise = np.random.default_rng(9).standard_normal((2, 128, T_Y)).astype(np.float32)
    cast = functools.partial(jstep._cast_floats, dtype=jnp.bfloat16)
    # JAX's sample_fake: model.apply of the bf16-cast variables and spk
    _, seen = jax_layer_dtypes(jax.jit(lambda v, spk: jm.apply(
        cast(v), mb["x"], mb["x_len"], jcfg.train_fake_timesteps, T_Y, 1.0, False, cast(spk),
        1.0, jax.random.PRNGKey(0), noise=noise)), variables, jnp.asarray(mb["spk"]))
    want = {p: d for p, d in seen.items() if p in _layer_names()}
    cfg, state = _port()
    assert cfg.gan_sampler_bf16 == 1
    sample_fake, _, _ = tstep.make_gan_loss_fns(cfg)
    with _port_layer_dtypes(state.model) as dtypes:
        fake = sample_fake(state.model, _torch_batch(mb), noise=torch.from_numpy(noise))
    assert fake.dtype == torch.float32
    assert len(want) == len(dtypes) == len(_layer_names()) == 132
    assert dtypes == want
    assert sum(d == {"bfloat16"} for d in dtypes.values()) == 28
    assert dtypes["decoder/estimator/final_conv"] == {"float32"}


# ---------------------------------------------------------------------------
# disc_bf16: the D phase


@functools.lru_cache(maxsize=None)
def _jax_d16(bf16, loss_type):
    jcfg, jm, jdisc, _, _ = _jax_setup()
    cfg = jcfg.replace(disc_bf16=int(bf16), disc_loss_type=loss_type)
    _, d_loss_fn, _ = jstep.make_gan_loss_fns(cfg, jm, jdisc)
    return jax.jit(jax.value_and_grad(d_loss_fn, has_aux=True), static_argnums=3)


@pytest.mark.parametrize("loss_type, use_r1", [("mse", False), ("hinge", True), ("bce", True)])
def test_d_loss_disc_bf16_matches_jax(loss_type, use_r1):
    """``d_loss_fn`` under ``disc_bf16``: the discriminator's parameters and
    both inputs in bf16 (forwards, backward and R1's double backward), R1's
    squares summed in f32, the logits in f32 before the loss and accuracy;
    mse without R1 (hinge's gradient steps where bf16 noise moves a logit
    across the margin), hinge and bce with it.

    Bars, with each framework's bf16 distance from its own f32 printed: the
    loss and R1 within 3e-2 relative of JAX's (measured <= 0.020; bf16
    moves the port's own by <= 0.014, JAX's by <= 0.008), the accuracy
    within 2e-3 (measured 4.3e-4: a logit of the ~2300 that lie within bf16
    noise of 0 sits on the other side); the weight-norm gradients
    (``weight_v``, ``weight_g``) within 2^-4 of the largest JAX gradient
    (measured <= 0.034), the biases' within 2^-4 with R1 (measured 0) and
    2^-2 without (measured 0.22: bf16 moves JAX's own bias gradients by
    0.22 of the largest from its f32 ones, the port's by 0.006, as XLA on
    the CPU sums the bias cotangent less exactly in bf16), and the port's
    bf16 gradients within 2^-4 of its f32 ones (measured <= 0.030).

    The loss and gradient bars do not tell a bf16 port from one that
    ignores the option: the port's bf16 is no nearer JAX's bf16 than its
    f32 is (mse: the loss 0.0135 against 0.0001 of JAX's), because two bf16
    computations that round at different points differ by about as much as
    either differs from f32 (the weight-norm scale of two of ``conv_prev``'s
    eight channels rounds one bf16 step apart, which shifts every logit
    alike).  So the test also holds the dtype of every feature map to
    JAX's."""
    _, _, _, _, dparams = _jax_setup()
    rng = np.random.default_rng(7)
    y = (rng.standard_normal((2, 128, T_Y)) - 1.0).astype(np.float32)
    fake = (rng.standard_normal((2, 128, T_Y)) * 0.7 - 1.0).astype(np.float32)
    out = {}
    for bf16 in (True, False):
        (jloss, (jm, (_, jfmap))), jgrads = _jax_d16(bf16, loss_type)(dparams, y, fake,
                                                                     use_r1)
        cfg, state = _port(dict(disc_bf16=str(int(bf16)), disc_loss_type=loss_type))
        _, d_loss_fn, _ = tstep.make_gan_loss_fns(cfg)
        d_loss, m, (fake_logits, fmap) = d_loss_fn(state.disc, torch.from_numpy(y),
                                                   torch.from_numpy(fake), use_r1)
        assert d_loss.dtype == fake_logits.dtype == torch.float32
        assert [str(f.dtype) for f in fmap] == [f"torch.{f.dtype}" for f in jfmap]
        assert fmap[0].dtype == (BF16 if bf16 else torch.float32)
        names = [n for n, _ in state.disc.named_parameters()]
        grads = torch.autograd.grad(d_loss, list(state.disc.parameters()))
        assert all(g.dtype == torch.float32 for g in grads)
        out[bf16] = (np.array([d_loss.item(), m["r1_penalty"].item(), m["disc_acc"].item()]),
                     dict(zip(names, grads)),
                     np.array([float(jloss), float(jm["r1_penalty"]), float(jm["disc_acc"])]),
                     convert.discriminator_state_dict(jgrads))
    got16, g16, want16, jg16 = out[True]
    got32, g32, want32, jg32 = out[False]
    n = 2 if use_r1 else 1
    rel = np.abs(got16[:n] - want16[:n]) / np.abs(want16[:n])
    frac = _max_frac(g16, jg16)
    scale = max(float(w.abs().max()) for w in jg16.values())
    frac_w, frac_b = (max(float((g16[n] - w).abs().max()) for n, w in jg16.items()
                          if n.endswith(".bias") == bias) / scale for bias in (False, True))
    print(f"loss, r1: port vs JAX (bf16) {rel}; bf16 vs f32: port "
          f"{np.abs(got16[:n] - got32[:n]) / np.abs(got32[:n])}, JAX "
          f"{np.abs(want16[:n] - want32[:n]) / np.abs(want32[:n])}")
    print(f"grads (of the largest): port vs JAX (bf16) {frac:.4f}; bf16 vs f32: port "
          f"{_max_frac(g16, g32):.4f}, JAX {_max_frac(jg16, jg32):.4f}; weights "
          f"{frac_w:.4f}, biases {frac_b:.4f}")
    assert rel.max() < 3e-2, rel
    assert abs(got16[2] - want16[2]) < 2e-3  # a few logits within bf16 noise of 0
    assert frac_w < 2**-4, frac_w
    assert frac_b < (2**-4 if use_r1 else 2**-2), frac_b
    assert _max_frac(g16, g32) < 2**-4


# ---------------------------------------------------------------------------
# adv_grad_through_sampler: the G phase


@functools.lru_cache(maxsize=None)
def _jax_adv_g_fn(bf16):
    """value_and_grad of JAX's G loss under ``adv_grad_through_sampler``
    (``g_loss_fn``: the fake resampled through the live parameters with
    SyncNet stopped, judged by the discriminator, plus the full-length
    FaceTTS losses) with dropout off, which ``g_loss_fn`` keeps on."""
    from facegantts_tpu.train.state import Batch as JBatch

    jcfg, jm, jdisc, variables, dparams = _jax_setup()
    cfg = jcfg.replace(adv_grad_through_sampler=1, gan_sampler_bf16=int(bf16))
    sample_fake, _, _ = jstep.make_gan_loss_fns(cfg, jm, jdisc)
    model_state = {"batch_stats": variables["batch_stats"]}

    def g_loss(params, x, x_len, y, y_len, spk, rng):
        mb = JBatch(x=x, x_len=x_len, y=y, y_len=y_len, spk=spk)
        params = dict(params, syncnet=jax.tree.map(jax.lax.stop_gradient, params["syncnet"]))
        rng, rng_s = jax.random.split(rng)
        fake = sample_fake(params, model_state, mb, rng_s)
        _, logits = jdisc.apply({"params": dparams}, fake[..., None])
        adv = jstep._gen_adv_loss(cfg.disc_loss_type, logits)
        rng, _ = jax.random.split(rng)
        parts, _ = jm.apply({"params": params, **model_state}, rng, x, x_len, y, y_len, spk,
                            None, deterministic=True, method=JFaceTTS.compute_loss)
        return cfg.lambda_adv * adv + parts.total, (parts, adv)

    return jax.jit(jax.value_and_grad(g_loss, has_aux=True))


def _adv_draws(rng, mb):
    """The resampled fake's noise and compute_loss's t, z for ``rng``, by
    the JAX G loss's key splits (f32: the sampler's mu_y is f32 in both
    precisions)."""
    from test_torch_train import _jax_draws

    rng, rng_s = jax.random.split(rng)
    rng_z, _ = jax.random.split(rng_s)
    noise = jax.random.normal(rng_z, mb["y"].shape, jnp.float32)
    rng, _ = jax.random.split(rng)
    _, t, z = _jax_draws(rng, mb, T_Y)
    return {"noise": _t(noise), "t": _t(t), "z": _t(z)}


@pytest.mark.parametrize("bf16", [False, True])
def test_g_phase_adv_grad_matches_jax(bf16):
    """The G phase under ``adv_grad_through_sampler``: the fake resampled
    with gradient through the two reverse steps, judged by the
    discriminator, and the gate on ``g_loss``.  With the f32 sampler the
    adversarial loss and the parts match JAX's to rtol 1e-4 and every
    generator gradient to 1e-3 of the largest (the G phase's bar).  With
    the bf16 sampler (bf16 weights under flax's promotion: the encoder from
    its first attention on and the U-Net run in f32 with bf16 weights, the
    prenet in bf16) the adversarial loss within 1e-3 relative, the parts
    within 1e-4, and every gradient within 2e-3 of the largest (measured
    1.7e-4)."""
    mb = _rows(_batch(), 0, 2)
    rng = jax.random.PRNGKey(11)
    jb = {k: jnp.asarray(v) for k, v in mb.items()}
    _, _, _, variables, _ = _jax_setup()
    (want, (jparts, jadv)), jgrads = _jax_adv_g_fn(bf16)(
        variables["params"], jb["x"], jb["x_len"], jb["y"], jb["y_len"], jb["spk"], rng)
    want_g = _want_grads(jgrads)

    cfg, state = _port(dict(adv_grad_through_sampler="1"), bf16=bf16)
    assert cfg.train_fake_timesteps == cfg.timesteps == 2
    model = state.model.train()
    model.syncnet.requires_grad_(False)
    _, _, g_loss_fn = tstep.make_gan_loss_fns(cfg)
    tb = _torch_batch(mb)
    g_loss, m = g_loss_fn(model, state.disc, tb, torch.full_like(tb.y, float("nan")), True,
                          None, **_adv_draws(rng, mb))
    assert g_loss.requires_grad and m["g_guard_loss"].item() == m["g_loss"].item()
    g_loss.backward()
    got = _gen_grads(model)
    np.testing.assert_allclose(m["adv_loss"].item(), float(jadv), rtol=1e-3 if bf16 else 1e-4)
    for k, ref in zip(("duration_loss", "prior_loss", "diffusion_loss", "spk_loss"), jparts):
        np.testing.assert_allclose(m[k].item(), float(ref), rtol=1e-4)
    frac = _max_frac(got, want_g)
    print(f"bf16={bf16}: g_loss {g_loss.item()} vs {float(want)}; grads {frac:.2e} of the "
          "largest")
    assert frac < (2e-3 if bf16 else 1e-3), frac


# ---------------------------------------------------------------------------
# grad_remat


def _step_grads(env, draws=None, seed=0):
    """One GAN step from the seed's weights with dropout live (the prenet's
    0.5 and enc_dropout), R1 on: every parameter's ``.grad`` and the
    metrics, and the explicit generator's state after the step.  torch's
    default generator (dropout) and the explicit one (the draws) start from
    ``seed``."""
    cfg = default_config(env=dict(GAN, **env))
    state = tstep.init_state(cfg, "cpu")
    train_step, _ = tstep.make_gan_train_step(cfg, "cpu")
    torch.manual_seed(seed)
    generator = torch.Generator().manual_seed(seed)
    state, m = train_step(state, Batch(**_batch()), generator, draws=draws)
    grads = {n: p.grad.clone() for n, p in list(state.model.named_parameters())
             + [("disc." + n, p) for n, p in state.disc.named_parameters()]
             if p.grad is not None}
    return grads, m, generator.get_state()


@pytest.mark.parametrize("adv", [False, True])
@pytest.mark.parametrize("inject", [False, True])
def test_grad_remat_gives_the_gradients_of_no_remat(adv, inject):
    """``grad_remat=1`` recomputes each phase's forward in its backward
    (R1's double backward included) with dropout live: the step's
    gradients equal those of ``grad_remat=0`` to 1e-6 of the largest, with
    the draws injected and drawn from the generator (the checkpointed G
    phase restarts the explicit generator from its state at the forward, so
    the recompute draws the forward's values and the step leaves the
    generator where the unchecked step leaves it), with and without
    ``adv_grad_through_sampler``."""
    env = dict(adv_grad_through_sampler=str(int(adv)), grad_clip="1e30")
    draws = None
    if inject:
        rng = np.random.default_rng(3)
        draws = [{k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                  for k, shape in (("noise", (2, 128, T_Y)), ("g_noise", (2, 128, T_Y)),
                                   ("z", (2, 128, T_Y)))} for _ in range(2)]
        for d in draws:
            d["t"] = torch.from_numpy(rng.uniform(0.05, 0.95, 2).astype(np.float32))
    want, wm, w_gen = _step_grads(env, draws)
    got, gm, g_gen = _step_grads(dict(env, grad_remat="1"), draws)
    assert torch.equal(g_gen, w_gen)
    assert set(got) == set(want)
    scale = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        torch.testing.assert_close(got[n], g, rtol=0, atol=1e-6 * scale, msg=n)
    for k, v in wm.items():
        torch.testing.assert_close(gm[k], v, rtol=1e-6, atol=0, msg=k)
    assert wm["r1_penalty"].item() > 0


def test_grad_remat_step_matches_jax_pieces(monkeypatch):
    """tests/test_torch_gan.py's whole-step check (the gradients and
    updates of two micro-batches against the JAX D and G pieces on the same
    fakes and draws) with ``grad_remat=1``."""
    import test_torch_gan as tgan

    port = tgan._port
    monkeypatch.setattr(tgan, "_port", lambda env=None, bf16=True: port(
        dict(env or {}, grad_remat="1"), bf16))
    tgan.test_gan_step_matches_jax_pieces()


# ---------------------------------------------------------------------------
# the steps under each option


OPTIONS = {"train_bf16": dict(train_bf16="1"), "disc_bf16": dict(disc_bf16="1"),
           "adv_grad_through_sampler": dict(adv_grad_through_sampler="1"),
           "grad_remat": dict(grad_remat="1"),
           "all": dict(train_bf16="1", disc_bf16="1", adv_grad_through_sampler="1",
                       grad_remat="1")}


def _f32_state(state):
    """Master parameters, their gradients and every optimizer tensor f32."""
    for module in (state.model, state.disc):
        for n, p in module.named_parameters():
            assert p.dtype == torch.float32, n
            assert p.grad is None or p.grad.dtype == torch.float32, n
    for opt in (state.optimizer, state.disc_optimizer):
        for st in opt.opt.state.values():
            for k, v in st.items():
                if torch.is_tensor(v) and v.is_floating_point() and v.dim():
                    assert v.dtype == torch.float32, k


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_gan_step_under_option(option):
    """A GAN step of two micro-batches and its validation under each
    option through the plain versions: finite metrics, R1 applied, every
    generator group and the discriminator moved, masters and optimizer
    state f32; ``g_guard_loss`` is ``g_loss`` exactly when the adversarial
    term trains the generator."""
    cfg = default_config(env=dict(GAN, **OPTIONS[option]))
    state = tstep.init_state(cfg, "cpu")
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    d_before = {n: p.detach().clone() for n, p in state.disc.named_parameters()}
    train_step, val_step = tstep.make_gan_train_step(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    state, m = train_step(state, Batch(**_batch()), gen)
    assert all(np.isfinite(v.item()) for v in m.values()), m
    assert m["r1_penalty"].item() > 0 and m["d_nan_skipped"].item() == 0
    assert (m["g_guard_loss"].item() == m["g_loss"].item()) == bool(cfg.adv_grad_through_sampler)
    _f32_state(state)
    moved = {n for n, p in state.model.named_parameters() if not torch.equal(p, before[n])}
    assert any(n.startswith("encoder.") for n in moved) and any(
        n.startswith("decoder.") for n in moved) and not any(
        n.startswith("syncnet.") for n in moved)
    assert all(not torch.equal(p, d_before[n]) for n, p in state.disc.named_parameters())
    vm = val_step(state, Batch(**_batch()), gen)
    assert all(np.isfinite(v.item()) for v in vm.values()), vm


def test_plain_step_train_bf16():
    """The plain step under ``train_bf16``: finite losses and gradient norm
    after two steps; masters, gradients and Adam's moments f32; validation
    in bf16 too, as JAX's ``loss_fn`` casts there as well."""
    from test_torch_train import TINY

    cfg = default_config(env=dict(TINY, train_bf16="1"))
    state = tstep.init_state(cfg, "cpu")
    train_step, val_step = tstep.make_plain_train_step(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    batch = Batch(**_batch())
    for _ in range(2):
        state, m = train_step(state, batch, gen)
        assert all(np.isfinite(v.item()) for v in m.values()), m
        assert all(v.dtype == torch.float32 for v in m.values())
    for n, p in state.model.named_parameters():
        assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32), n
    for st in state.optimizer.opt.state.values():
        assert all(v.dtype == torch.float32 for v in st.values()
                   if torch.is_tensor(v) and v.dim())
    vm = val_step(state, batch, gen)
    assert all(np.isfinite(v.item()) for v in vm.values()), vm


# ---------------------------------------------------------------------------
# the discriminator's speaker-embedding input


def test_discriminator_speaker_input_matches_jax():
    """The weight-normed ``spk_mlp`` Linear, added to every frequency row of
    ``conv_prev``'s channels: with a speaker embedding, feature maps and
    logits equal the JAX module's initialised with one (2e-4, the
    discriminator's bar), through ``convert.discriminator_state_dict``,
    whose ``WeightNorm_i`` numbering ``spk_mlp`` shifts; without one, those
    of the JAX module without the speaker path on the same convolutions."""
    jdisc = JDisc(base_channels=8, num_layers=2, multi_speaker=1)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 128, 24)).astype(np.float32)
    spk = rng.standard_normal((2, 16)).astype(np.float32)
    params = jdisc.init(jax.random.PRNGKey(6), jnp.asarray(x)[..., None], jnp.asarray(spk))[
        "params"]
    assert "spk_mlp" in params and "spk_mlp/kernel/scale" in params["WeightNorm_1"]
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                          .astype(np.float32), params)
    disc = SpectrogramDiscriminator(base_channels=8, num_layers=2, spk_emb_dim=16)
    disc.load_state_dict(convert.discriminator_state_dict(params))
    assert disc.spk_mlp.weight_v.shape == (8, 16) and disc.spk_mlp.weight_g.shape == (8, 1)

    # the same convolutions without the speaker path: WeightNorm_i renumbered
    plain = {k: v for k, v in params.items() if k != "spk_mlp" and not k.startswith("WeightNorm")}
    wn = sorted((k for k in params if k.startswith("WeightNorm")), key=lambda k: int(k[11:]))
    for i, k in enumerate(w for w in wn if w != "WeightNorm_1"):
        plain[f"WeightNorm_{i}"] = params[k]
    for emb, tree in ((spk, params), (None, plain)):
        args = (jnp.asarray(x)[..., None],) + (() if emb is None else (jnp.asarray(emb),))
        jfmap, jlogits = jdisc.apply({"params": tree}, *args)
        with torch.no_grad():
            fmap, logits = disc(torch.from_numpy(x)[:, None],
                                None if emb is None else torch.from_numpy(emb))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=2e-4)
        for got, want in zip(fmap, jfmap):
            np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                                       atol=2e-4)
    with pytest.raises(ValueError, match="spk_emb_dim=0"):
        SpectrogramDiscriminator(base_channels=8, num_layers=1)(
            torch.zeros(1, 1, 16, 8), torch.zeros(1, 16))
