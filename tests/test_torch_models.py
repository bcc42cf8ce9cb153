"""PyTorch port modules against the JAX package at narrow widths.

Each JAX module gets seeded numpy variables of its own tree, which
``facegantts_tpu_torch.convert`` carries into the port's module with
``load_state_dict(strict=True)``; the same numpy inputs then go through both.
Tolerance 1e-4 absolute in f32 (sums in another order over a few layers);
torch runs strict f32 (no TF32).

The round-trip test holds ``convert.py`` to the JAX package's own torch
importers (``train/checkpoint.py``): JAX variables -> port state_dict ->
importers -> the JAX variables, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from facegantts_tpu.train import checkpoint as ck
from facegantts_tpu_torch import convert
from torch_cpu import torch_threads_started  # noqa: F401

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _strict_f32():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _random_variables(module, *args, seed, method=None):
    """Variables of ``module`` with the tree ``init`` would make (traced with
    ``eval_shape``, nothing compiled), filled from a seeded numpy generator
    at init-like scales.  Zero-initialised leaves (Rezero gates, the prenet
    projection, biases) get nonzero values so every path does real work, and
    BatchNorm running statistics are off their defaults so eval-mode BN is a
    real check."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, method=method))
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.tree.map(lambda a: a, shapes))
    out = {}
    for path, leaf in flat.items():
        name, shape = path[-1], leaf.shape
        if name in ("scale", "gamma"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "mean":
            v = rng.uniform(-0.3, 0.3, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) >= 2:  # kernels and tables: fan-in scaled
            fan_in = int(np.prod(shape[:-1])) if name != "embedding" else shape[-1]
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        else:  # biases, gates
            v = 0.1 * rng.standard_normal(shape)
        out[path] = np.asarray(v, np.float32)
    return traverse_util.unflatten_dict(out)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# modules: JAX side, shared by the parity tests and the round trip

ENC = dict(n_vocab=149, n_feats=16, n_channels=32, filter_channels=64, filter_channels_dp=32,
           n_heads=2, n_layers=2, kernel_size=3, p_dropout=0.0, window_size=4, spk_emb_dim=16)
UNET = dict(dim=16, spk_emb_dim=16, n_feats=16)
HIFI = dict(in_channels=16, upsample_initial_channel=32)


@pytest.fixture(scope="module")
def jax_text_encoder():
    from facegantts_tpu.models.text_encoder import TextEncoder

    jm = TextEncoder(**ENC)
    x = jnp.ones((1, 8), jnp.int32)
    return jm, _random_variables(jm, x, jnp.array([8]), jnp.zeros((1, 16)), seed=1)["params"]


@pytest.fixture(scope="module")
def jax_unet_params():
    from facegantts_tpu.models.unet import GradLogPEstimator2d

    f, t = UNET["n_feats"], 8
    jm = GradLogPEstimator2d(**UNET)
    v = _random_variables(jm, jnp.zeros((1, f, t)), jnp.ones((1, 1, t)), jnp.zeros((1, f, t)),
                          jnp.zeros((1,)), jnp.zeros((1, 16)), seed=2)
    return v["params"]


@pytest.fixture(scope="module")
def jax_syncnet():
    from facegantts_tpu.models.syncnet import SyncNet

    jm = SyncNet(n_out=16, width_mult=0.125)
    # __call__ builds both streams (the face path alone would skip the audio one)
    v = _random_variables(jm, jnp.zeros((1, 128, 40, 1)), jnp.zeros((1, 224, 224, 3)), seed=3)
    return jm, v["params"], v["batch_stats"]


@pytest.fixture(scope="module")
def jax_hifigan():
    from facegantts_tpu.models.hifigan import HiFiGANGenerator

    jm = HiFiGANGenerator(**HIFI)
    return jm, _random_variables(jm, jnp.zeros((1, 16, 4)), seed=4)["params"]


@pytest.mark.parametrize("batch", [1, 3])  # JAX picks a gather form at b=1, a skew form else
def test_text_encoder_matches_jax(jax_text_encoder, batch):
    from facegantts_tpu_torch.models.text_encoder import TextEncoder

    jm, params = jax_text_encoder
    rng = np.random.default_rng(batch)
    t = 14
    x = rng.integers(1, 148, (batch, t)).astype(np.int32)
    x_len = np.array([14, 9, 3][:batch], np.int32)
    spk = rng.standard_normal((batch, 16)).astype(np.float32)
    j_mu, j_logw, j_mask = jax.jit(jm.apply)({"params": params}, x, x_len, spk)

    tm = TextEncoder(**ENC).eval()
    tm.load_state_dict(convert.text_encoder_state_dict(params), strict=True)
    with torch.no_grad():
        mu, logw, mask = tm(_t(x).long(), _t(x_len).long(), _t(spk))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(mu.numpy(), np.asarray(j_mu), atol=ATOL)
    np.testing.assert_allclose(logw.numpy(), np.asarray(j_logw), atol=ATOL)


@pytest.mark.parametrize("fused_gn", [0, 1])
def test_unet_matches_jax(jax_unet_params, fused_gn):
    from facegantts_tpu.models.unet import GradLogPEstimator2d as JUnet
    from facegantts_tpu_torch.models.unet import GradLogPEstimator2d

    rng = np.random.default_rng(10 + fused_gn)
    b, f, t = 2, UNET["n_feats"], 24
    x = rng.standard_normal((b, f, t)).astype(np.float32)
    mu = rng.standard_normal((b, f, t)).astype(np.float32)
    mask = np.ones((b, 1, t), np.float32)
    mask[1, :, 17:] = 0
    tt = np.array([0.25, 0.85], np.float32)
    spk = rng.standard_normal((b, 16)).astype(np.float32)
    jm = JUnet(**UNET, fused_gn=fused_gn)
    want = np.asarray(jax.jit(jm.apply)({"params": jax_unet_params}, x, mask, mu, tt, spk))

    tm = GradLogPEstimator2d(**UNET, fused_gn=fused_gn).eval()
    tm.load_state_dict(convert.unet_state_dict(jax_unet_params), strict=True)
    with torch.no_grad():
        got = tm(_t(x), _t(mask), _t(mu), _t(tt), _t(spk)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert not got[1, :, 17:].any()


def test_syncnet_forward_vid_matches_jax(jax_syncnet):
    from facegantts_tpu_torch.models.syncnet import SyncNet

    jm, params, stats = jax_syncnet
    face = np.random.default_rng(5).standard_normal((2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, f: jm.apply(v, f, method=jm.forward_vid))(
        {"params": params, "batch_stats": stats}, face))
    tm = SyncNet(n_out=16, width_mult=0.125).eval()
    tm.load_state_dict(convert.syncnet_state_dict(params, stats), strict=True)
    with torch.no_grad():
        got = tm.forward_vid(_t(face)).numpy()
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_syncnet_audio_stream_matches_jax(jax_syncnet):
    """forward_aud (B, T', n_out) and the 8 forward_perceptual maps, NCHW in
    the port and NHWC in JAX; BatchNorm stays on running statistics even
    after train()."""
    from facegantts_tpu_torch.models.syncnet import SyncNet

    jm, params, stats = jax_syncnet
    mel = np.random.default_rng(6).standard_normal((2, 128, 40)).astype(np.float32)
    v = {"params": params, "batch_stats": stats}
    want_aud = np.asarray(jax.jit(lambda v, m: jm.apply(v, m, method=jm.forward_aud))(
        v, mel[..., None]))
    want_maps = jax.jit(lambda v, m: jm.apply(v, m, method=jm.forward_perceptual))(
        v, mel[..., None])
    tm = SyncNet(n_out=16, width_mult=0.125).train()
    assert not tm.training and not any(m.training for m in tm.modules())
    tm.load_state_dict(convert.syncnet_state_dict(params, stats), strict=True)
    with torch.no_grad():
        got_aud = tm.forward_aud(_t(mel)[:, None]).numpy()
        got_maps = tm.forward_perceptual(_t(mel)[:, None])
    np.testing.assert_allclose(got_aud, want_aud, atol=ATOL)
    assert len(got_maps) == len(want_maps) == 8
    for i, (g, w) in enumerate(zip(got_maps, want_maps)):
        g = g.numpy()
        g = g.transpose(0, 2, 3, 1) if g.ndim == 4 else g.transpose(0, 2, 1)
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, err_msg=f"map {i}")
    assert torch.equal(tm.netcnnaud[1].running_mean,
                       convert.syncnet_state_dict(params, stats)["netcnnaud.1.running_mean"])


def test_hifigan_matches_jax(jax_hifigan):
    from facegantts_tpu_torch.models.hifigan import HiFiGANGenerator

    jm, params = jax_hifigan
    mel = np.random.default_rng(6).standard_normal((2, 16, 10)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, mel))
    tm = HiFiGANGenerator(**HIFI).eval()
    tm.load_state_dict(convert.hifigan_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm(_t(mel)).numpy()
    assert got.shape == (2, 10 * 160)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert tm.margin_frames() == jm.margin_frames()


# ---------------------------------------------------------------------------
# convert.py round trip


def _assert_tree_equal(got, want):
    g = traverse_util.flatten_dict(jax.tree.map(np.asarray, got))
    w = traverse_util.flatten_dict(jax.tree.map(np.asarray, want))
    assert set(g) == set(w), set(g) ^ set(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg="/".join(k))


def test_convert_round_trip_exact(jax_text_encoder, jax_unet_params, jax_syncnet, jax_hifigan):
    """JAX variables -> port state_dict -> JAX importers == the JAX variables."""
    from facegantts_tpu_torch.models.facetts import FaceTTS
    from facegantts_tpu_torch.models.hifigan import HiFiGANGenerator

    _, sp, ss = jax_syncnet
    variables = {
        "params": {"encoder": jax_text_encoder[1],
                   "decoder": {"estimator": jax_unet_params}, "syncnet": sp},
        "batch_stats": {"syncnet": ss},
    }
    sd = convert.facetts_state_dict(variables)
    FaceTTS(n_vocab=149, n_feats=16, n_enc_channels=32, filter_channels=64,
            filter_channels_dp=32, n_heads=2, n_enc_layers=2, enc_kernel=3, enc_dropout=0.0,
            window_size=4, dec_dim=16, beta_min=0.05, beta_max=20.0, pe_scale=1000.0,
            vid_emb_dim=16, syncnet_width_mult=0.125).load_state_dict(sd, strict=True)
    p = variables["params"]
    _assert_tree_equal(ck.import_text_encoder(sd, "encoder."), p["encoder"])
    _assert_tree_equal(ck.import_unet(sd, "decoder.estimator."), p["decoder"]["estimator"])
    got_p, got_s = ck.import_syncnet(sd, "syncnet.")
    _assert_tree_equal(got_p, sp)
    _assert_tree_equal(got_s, ss)

    hp = jax_hifigan[1]
    hsd = convert.hifigan_state_dict(hp)
    HiFiGANGenerator(**HIFI).load_state_dict(hsd, strict=True)
    _assert_tree_equal(ck.import_hifigan_state_dict(hsd), hp)
