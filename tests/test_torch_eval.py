"""The PyTorch port's evaluation slice against the JAX package, on the CPU.

- the mel op (``ops/mel.py``) against JAX's on seeded noise, speech-like
  and loud pure-tone (150, 440, 2000 Hz) waveforms, batch 1 and 3, 1, 2, 57
  and 436 frames, at the Config's STFT and mel settings.  Bars: the linear
  mel within 1e-5 of its frame's largest value, the log-mel within 1e-4
  wherever the mel is above 1e-3 of that value.  Not 1e-4 on every log
  bin: f32 rounding of the DFT sums meets the 1e-9 floor in the near-empty
  bins of a tone.  Measured here (all bins / linear, of the frame's largest
  / log above 1e-3 of it): tone 9.6e-3 / 6.1e-7 / 3.2e-5, speech-like
  6.8e-5 / 9.4e-7 / 6.8e-5, noise 3.3e-6 / 8.7e-7 / 3.3e-6.  Tones anywhere
  from 80 Hz to 6 kHz are held to the formula in float64 instead, where the
  port is as near as JAX is (the two can differ by 2.8e-4 there).  The
  filterbank and the frame count are exact;
- the numpy copies: ``metrics`` (YIN, mel-cepstra, DTW, MCD, LSD, log-F0
  RMSE by YIN and pYIN, the composite), ``pyin``, ``world_log_f0_rmse``,
  the DSP MOS proxy and a linear-head ``.pt`` equal JAX's to 1e-12 on
  seeded voiced and unvoiced signals; a file that only looks like an SSL
  (wav2vec2) MOS checkpoint falls through to its linear head as in JAX;
- ``score_wav_pair`` for each ``f0_protocol`` and the ``evaluate`` CLI's
  ``eval_output.txt``, both packages scoring with one full-width SyncNet
  (a port ``state_dict`` saved as the ``syncnet_ckpt`` file): speaker
  similarity within 1e-5, every other number equal, the file's lines equal
  but for the values (within 1e-5);
- ``retrieval_accuracy``, the band-passes and ``embed_dataset`` against
  JAX's, on a narrow SyncNet with the JAX weights carried across; the
  ``acc_measure`` CLI;
- the bf16 synthesis: every layer of the port's ``use_bf16`` decoder and
  vocoder gives its output in the dtype the JAX package's
  ``_decode_vocode_fn`` gives it (bf16: JAX casts ``mu_x``, the mask and
  the speaker embedding to bf16 itself, so ``mu_y`` and the U-Net are bf16
  there too);
- ``IntrainEvaluator`` at TINY (one sample, buckets (16,) and (64,)): the
  JAX package's keys, finite, ``eval_output.txt`` with the three RANDOM-INIT
  provenance lines, ``sample_0.wav``, and the copy-synthesis of a
  ground-truth mel against JAX's ``stream_vocode`` with the same vocoder
  weights (1e-5, ``tests/test_torch_serve.py``'s bar);
- ``train()`` with ``eval_interval=1`` logs ``eval/*`` at each step and
  ranks a checkpoint on "Composite Metric".

Torch runs on one thread, strict f32 (no TF32)."""

import functools
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from facegantts_tpu.config import default_config as jax_default_config
from facegantts_tpu.evaluation import acc_measure as jacc
from facegantts_tpu.evaluation import evaluate as jevaluate
from facegantts_tpu.evaluation import metrics as jM
from facegantts_tpu.evaluation import pyin as jpyin
from facegantts_tpu.evaluation import utmos as jutmos
from facegantts_tpu.evaluation import world as jworld
from facegantts_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from facegantts_tpu.models.syncnet import SyncNet as JSyncNet
from facegantts_tpu.ops import mel as jmel
from facegantts_tpu.synthesis import Synthesizer as JSynthesizer
from facegantts_tpu.train.checkpoint import import_hifigan_state_dict
from facegantts_tpu_torch import convert
from facegantts_tpu_torch.config import default_config
from facegantts_tpu_torch.data.dataset import SyntheticDataset
from facegantts_tpu_torch.evaluation import acc_measure, evaluate
from facegantts_tpu_torch.evaluation import metrics as M
from facegantts_tpu_torch.evaluation import pyin, ssl_mos, utmos, world
from facegantts_tpu_torch.evaluation.intrain import IntrainEvaluator
from facegantts_tpu_torch.models.hifigan import HiFiGANGenerator
from facegantts_tpu_torch.models.syncnet import SyncNet
from facegantts_tpu_torch.ops import mel
from facegantts_tpu_torch.synthesis import Synthesizer
from test_torch_data import speech_like
from test_torch_precision import _layer_names, _port_layer_dtypes, jax_layer_dtypes
from test_torch_train import TINY
from torch_cpu import torch_threads_started  # noqa: F401

SR = 16000
TONES_HZ = (150.0, 440.0, 2000.0)
EVAL = dict(TINY, spk_emb="face")
# JAX's IntrainEvaluator.run: its keys, in its order
SMALL_VOC = dict(in_channels=128, upsample_initial_channel=32, upsample_rates=(2, 2),
                 upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilations=((1, 3, 5), (1, 3, 5), (1, 3, 5)))
INTRAIN_KEYS = ["Composite Metric", "Speaker Similarity", "F0 RMSE", "MCD", "STFT Distance",
                "UTMOS", "Mel Distance", "Samples"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
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


def _cfgs(**kw):
    env = dict(EVAL, **{k: str(v) for k, v in kw.items()})
    return default_config(env=env), jax_default_config(env=env)


# ---------------------------------------------------------------------------
# the mel op


def _waves(kind, b, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    if kind == "noise":
        y = rng.standard_normal((b, n)) * 0.3
    elif kind == "tone":  # loud pure tones at 150, 440 and 2000 Hz
        y = np.stack([0.95 * np.sin(2 * np.pi * TONES_HZ[i % 3] * t) for i in range(b)])
    elif kind == "random tone":  # 80 Hz to 6 kHz, any phase
        y = np.stack([0.95 * np.sin(2 * np.pi * rng.uniform(80, 6000) * t + rng.uniform(0, 6))
                      for _ in range(b)])
    else:
        y = np.stack([np.resize(speech_like(n / SR + 0.01, seed + i), n) for i in range(b)])
    return y.astype(np.float32)


@pytest.mark.parametrize("frames", [1, 2, 57, 436])
@pytest.mark.parametrize("kind", ["noise", "speech", "tone"])
def test_mel_spectrogram_matches_jax(kind, frames):
    cfg = default_config(env={})
    args = (cfg.n_fft, cfg.n_mels, cfg.sample_rate, cfg.hop_len, cfg.win_len, cfg.f_min,
            cfg.f_max)
    for b, extra in ((1, 0), (3, cfg.hop_len - 1)):
        n = frames * cfg.hop_len + extra
        assert mel.num_mel_frames(n) == frames
        y = _waves(kind, b, n, seed=frames + b)
        got = mel.mel_spectrogram(torch.from_numpy(y), *args)
        assert got.dtype == torch.float32 and got.shape == (b, cfg.n_mels, frames)
        got, want = got.numpy().astype(np.float64), np.asarray(
            jmel.mel_spectrogram(jnp.asarray(y), *args), np.float64)
        lin, wlin = np.exp(got), np.exp(want)
        top = wlin.max(axis=1, keepdims=True)
        assert (np.abs(lin - wlin) <= 1e-5 * top).all(), np.abs(lin - wlin).max()
        live = wlin > 1e-3 * top
        assert live.any(axis=1).all()
        assert np.abs(got - want)[live].max() <= 1e-4, np.abs(got - want)[live].max()
    # numpy input on the CPU, 1-D: one row
    np.testing.assert_array_equal(mel.mel_spectrogram(y[0], *args).numpy(),
                                  mel.mel_spectrogram(torch.from_numpy(y[:1]), *args).numpy())


def test_mel_spectrogram_tones_against_float64():
    """Loud tones anywhere from 80 Hz to 6 kHz, against the formula in
    float64: the port's log-mel is as near it as JAX's.  Measured above 1e-3
    of the frame's largest value: the port 1.2e-4 at most, JAX 2.9e-4 (so
    the two differ by up to 2.8e-4 here, over the 1e-4 bar that the fixed
    tones above meet); the bar is 5e-4, the linear mel's 1e-5 of the
    frame's largest value."""
    cfg = default_config(env={})
    for frames, b in ((57, 1), (57, 3), (436, 1), (436, 3)):
        y = _waves("random tone", b, frames * cfg.hop_len + (b - 1) * 53, seed=frames + b)
        exact = mel.mel_spectrogram_float64(y)
        got = mel.mel_spectrogram(torch.from_numpy(y)).numpy().astype(np.float64)
        want = np.asarray(jmel.mel_spectrogram(jnp.asarray(y)), np.float64)
        top = np.exp(exact).max(axis=1, keepdims=True)
        live = np.exp(exact) > 1e-3 * top
        for out in (got, want):
            assert (np.abs(np.exp(out) - np.exp(exact)) <= 1e-5 * top).all()
            assert np.abs(out - exact)[live].max() <= 5e-4, np.abs(out - exact)[live].max()


def test_mel_constants_exact():
    for args in ((16000, 1024, 128, 0.0, 8000.0), (22050, 512, 80, 50.0, 7600.0)):
        np.testing.assert_array_equal(mel.mel_filterbank(*args), jmel.mel_filterbank(*args))
    np.testing.assert_array_equal(mel._dft_basis(1024, 1024), jmel._dft_basis(1024, 1024))
    f = np.linspace(0, 8000, 97)
    np.testing.assert_array_equal(mel.hz_to_mel_slaney(f), jmel.hz_to_mel_slaney(f))
    np.testing.assert_array_equal(mel.mel_to_hz_slaney(f / 100), jmel.mel_to_hz_slaney(f / 100))
    for n in list(range(0, 2000, 37)) + [69920, 69919]:
        assert mel.num_mel_frames(n) == jmel.num_mel_frames(n)
    # reflect padding past a short signal's ends, as jnp.pad does it
    y = np.random.default_rng(0).standard_normal((2, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        mel.reflect_pad(torch.from_numpy(y), 20).numpy(),
        np.asarray(jnp.pad(y, ((0, 0), (20, 20)), mode="reflect")))


# ---------------------------------------------------------------------------
# the numpy copies


def _eq(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=1e-12)


def _pairs():
    """(reference, generated) pairs: voiced at two pitches; voiced against
    noise (mostly unvoiced)."""
    ref = speech_like(0.45, 20, f0=(100.0, 150.0))
    gen = speech_like(0.5, 21, f0=(120.0, 200.0))
    noise = (np.random.default_rng(22).standard_normal(7000) * 0.05).astype(np.float32)
    return [(ref, gen), (ref, noise)]


@pytest.mark.parametrize("pair", [0, 1])
def test_metrics_match_jax(pair):
    ref, gen = _pairs()[pair]
    for y in (ref, gen):
        _eq(M.yin_f0(y, SR), jM.yin_f0(y, SR))
        _eq(M.mel_cepstra(y, SR), jM.mel_cepstra(y, SR))
        _eq(M.stft_mag(y), jM.stft_mag(y))
        for a, b in zip(pyin(y, SR), jpyin(y, SR)):  # the functions
            _eq(a, b)
    a, b = M.mel_cepstra(gen, SR)[:, 1:], M.mel_cepstra(ref, SR)[:, 1:]
    for p, q in zip(M.dtw_path(a, b), jM.dtw_path(a, b)):
        np.testing.assert_array_equal(p, q)
    _eq(M.mcd(ref, gen, SR), jM.mcd(ref, gen, SR))
    _eq(M.log_spectral_distance(ref, gen), jM.log_spectral_distance(ref, gen))
    for est in ("yin", "pyin"):
        _eq(M.log_f0_rmse(ref, gen, SR, est), jM.log_f0_rmse(ref, gen, SR, est))
    _eq(world.world_log_f0_rmse(ref, gen, SR), jworld.world_log_f0_rmse(ref, gen, SR))
    _eq(utmos.DSPMOSPredictor()(gen, SR), jutmos.DSPMOSPredictor()(gen, SR))
    for v in ((0.9, 0.3, 5.1, 0.7), (0.1, 1.7, 13.0, 2.5), (0.5, 0.0, 3.0, -1.0)):
        assert M.composite_metric(*v) == jM.composite_metric(*v)
    res = {"Composite Metric": 0.123456789, "UTMOS": 3.5}
    assert M.format_eval_output(res) == jM.format_eval_output(res)


def test_mos_head_and_ssl_refusal(tmp_path, capsys):
    """A linear-head ``.pt`` scores as JAX's; a file that only looks like an
    SSL (wav2vec2) checkpoint fails to import and, as in JAX, falls through to
    its linear head, warning by name (a real SSL file gives the SSL model:
    ``tests/test_torch_ssl_mos.py``); a missing file degrades to the DSP
    proxy with JAX's warning."""
    head = tmp_path / "head.pt"
    torch.save({"backbone.weight": torch.ones(3, 3), "backbone.bias": torch.zeros(3),
                "head.weight": torch.tensor([[0.5, -1.0, -0.8, -0.3, 0.9]]),
                "head.bias": torch.tensor([3.1])}, head)
    ours, theirs = utmos.make_mos_predictor(str(head)), jutmos.make_mos_predictor(str(head))
    assert type(ours).__name__ == type(theirs).__name__ == "LinearHeadMOSPredictor"
    for y, _ in _pairs():
        _eq(ours(y, SR), theirs(y, SR))
    ssl = tmp_path / "utmos_strong.pt"
    torch.save({"state_dict": {
        "ssl_model.model.feature_extractor.conv_layers.0.conv.weight": torch.zeros(4, 1, 10),
        "head.weight": torch.zeros(1, 5), "head.bias": torch.zeros(1)}}, ssl)
    assert ssl_mos.looks_like_ssl_checkpoint(
        torch.load(ssl, weights_only=True)["state_dict"])
    capsys.readouterr()
    ours, theirs = utmos.make_mos_predictor(str(ssl)), jutmos.make_mos_predictor(str(ssl))
    assert type(ours).__name__ == type(theirs).__name__ == "LinearHeadMOSPredictor"
    assert capsys.readouterr().out.count("SSL MOS import failed") == 2
    for y, _ in _pairs():
        _eq(ours(y, SR), theirs(y, SR))
    assert isinstance(utmos.make_mos_predictor(str(tmp_path / "none.pt")),
                      utmos.DSPMOSPredictor)
    assert "using DSP proxy" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# score_wav_pair and the evaluate CLI: one full-width SyncNet


@pytest.fixture(scope="module")
def syncnet_file(tmp_path_factory):
    cfg = default_config(env={})
    torch.manual_seed(3)
    model = SyncNet(n_out=cfg.vid_emb_dim, stride=cfg.syncnet_stride)
    with torch.no_grad():  # running statistics away from their initial values
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    path = str(tmp_path_factory.mktemp("syncnet") / "syncnet.pt")
    torch.save({"state_dict": model.state_dict()}, path)
    return path


@pytest.fixture(scope="module")
def syncnet_applies(syncnet_file):
    cfg = default_config(env={}, overrides=dict(syncnet_ckpt=syncnet_file))
    jcfg = jax_default_config(env={}, overrides=dict(syncnet_ckpt=syncnet_file))
    ours, theirs = evaluate.build_syncnet_apply(cfg, "cpu"), jevaluate.build_syncnet_apply(jcfg)
    assert ours.provenance == theirs.provenance == f"pretrained ({syncnet_file})"
    return cfg, jcfg, ours, theirs


@pytest.mark.parametrize("protocol", ["world", "pyin", "yin"])
def test_score_wav_pair_matches_jax(syncnet_applies, protocol):
    cfg, jcfg, ours, theirs = syncnet_applies
    cfg, jcfg = cfg.replace(f0_protocol=protocol), jcfg.replace(f0_protocol=protocol)
    ref, gen = _pairs()[0]
    mos = utmos.DSPMOSPredictor()
    got = evaluate.score_wav_pair(gen, ref, cfg, ours, mos)
    want = jevaluate.score_wav_pair(gen, ref, jcfg, theirs, jutmos.DSPMOSPredictor())
    assert set(got) == set(want) == {"sim", "f0", "mcd", "lsd", "mos"}
    assert abs(got["sim"] - want["sim"]) <= 1e-5, (got["sim"], want["sim"])
    assert -1.0 <= got["sim"] < 1.0
    for k in ("f0", "mcd", "lsd", "mos"):
        assert got[k] == want[k], k
    assert evaluate.backend_provenance(cfg, ours, mos) == jevaluate.backend_provenance(
        jcfg, theirs, jutmos.DSPMOSPredictor())


def _parse(path):
    lines = open(path).read().splitlines()
    head = [ln for ln in lines if ln.startswith("#")]
    vals = dict(re.fullmatch(r"(.+): ([0-9.eE+-]+)", ln).groups() for ln in lines
                if not ln.startswith("#"))
    return lines, head, {k: float(v) for k, v in vals.items()}


def test_evaluate_cli_matches_jax(syncnet_file, tmp_path):
    gen_dir, gt_dir = tmp_path / "gen", tmp_path / "gt"
    ref, gen = _pairs()[0]
    for i, rel in enumerate(["a.wav", "sub/b.wav"]):
        for d, y in ((gen_dir, gen[: 6000 + 1000 * i]), (gt_dir, ref)):
            os.makedirs((d / rel).parent, exist_ok=True)
            wavfile.write(d / rel, SR, (y * 32767).astype(np.int16))
    wavfile.write(gen_dir / "unpaired.wav", SR, (gen * 32767).astype(np.int16))
    common = [f"output_dir={gen_dir}", f"ground_truth_dir={gt_dir}",
              f"syncnet_ckpt={syncnet_file}"]
    res = evaluate.main(common + [f"results_path={tmp_path / 'port'}", "device=cpu"])
    jevaluate.main(common + [f"results_path={tmp_path / 'jax'}"])
    got, want = (_parse(tmp_path / p / "eval_output.txt") for p in ("port", "jax"))
    assert got[1] == want[1] and len(got[1]) == 3 and f"pretrained ({syncnet_file})" in got[1][0]
    assert [ln.split(":")[0] for ln in got[0]] == [ln.split(":")[0] for ln in want[0]]
    assert list(got[2]) == list(want[2]) == list(res) and got[2]["Paired Files"] == 2.0
    for k, v in want[2].items():
        assert abs(got[2][k] - v) <= 1e-5, (k, got[2][k], v)


# ---------------------------------------------------------------------------
# retrieval accuracy


@functools.lru_cache(maxsize=None)
def _narrow_syncnets():
    """A SyncNet of width 1/8: JAX variables and the port's module carrying
    them."""
    jnet = JSyncNet(n_out=32, width_mult=0.125)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(4), jnp.zeros((1, 128, 32, 1)),
                                   jnp.zeros((1, 224, 224, 3)))
    tnet = SyncNet(n_out=32, width_mult=0.125).eval()
    tnet.load_state_dict(convert.syncnet_state_dict(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])))
    return jnet, variables, tnet


def test_retrieval_accuracy_and_embeddings_match_jax():
    jnet, variables, tnet = _narrow_syncnets()
    ds = SyntheticDataset(n_items=6, n_mels=128, seed=5, min_frames=48, max_frames=49)
    jvid = jax.jit(lambda f: jnet.apply(variables, f, method=JSyncNet.forward_vid))
    jaud = jax.jit(lambda m: jnet.apply(variables, m, method=JSyncNet.forward_aud))
    vid, aud = acc_measure.syncnet_embedders(tnet)
    band = (SR, 128, 0.0, 8000.0)
    for kw in ({}, {"band": band}):
        v, f = acc_measure.embed_dataset(ds, vid, aud, limit=5, **kw)
        jv, jf = jacc.embed_dataset(ds, jvid, jaud, limit=5, **kw)
        assert v.shape == jv.shape == (5, 32) and f.shape == jf.shape == (5, 32)
        for a, b in ((v, jv), (f, jf)):
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), np.abs(a - b).max()
        for n_way in (2, 5):
            assert acc_measure.retrieval_accuracy(v, f, n_way, 40, seed=3) == \
                jacc.retrieval_accuracy(v, f, n_way, 40, seed=3)
    m = ds[0]["y"]
    np.testing.assert_array_equal(acc_measure.mel_bandpass(m, *band),
                                  jacc.mel_bandpass(m, *band))
    y = speech_like(0.3, 6)
    _eq(acc_measure.biquad_bandpass(y, SR), jacc.biquad_bandpass(y, SR))
    with pytest.raises(AssertionError):
        acc_measure.retrieval_accuracy(v[:2], f[:2], n_way=5)


def test_acc_measure_cli(monkeypatch, capsys):
    """``main``: the test split (here a synthetic set in its place), the
    full-width SyncNet on the CPU with JAX's random-embedder warning, both
    accuracies in [0, 1], and the band-pass rerun."""
    from facegantts_tpu_torch import data

    monkeypatch.setattr(data, "load_packed", lambda cfg, split: SyntheticDataset(
        n_items=5, n_mels=cfg.n_mels, seed=2, min_frames=40, max_frames=50))
    out = acc_measure.main(["n_way=3", "n_trials=10", "bandpass=1", "device=cpu"])
    assert "random embedder" in capsys.readouterr().out
    for r in (out["results"], out["bandpass"]):
        assert 0 <= r["voice_to_face_acc"] <= 1 and 0 <= r["face_to_voice_acc"] <= 1
        assert r["n_way"] == 3.0 and r["n_trials"] == 10.0


# ---------------------------------------------------------------------------
# bf16 synthesis: layer dtypes


@functools.lru_cache(maxsize=None)
def _small_vocoder():
    """A small HiFi-GAN (the layers of the Config's at a quarter of the
    channels and two upsamplings; 4 samples a frame): JAX params."""
    return JHiFiGAN(**SMALL_VOC).init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 8)))["params"]


@functools.lru_cache(maxsize=None)
def _vocoder_names():
    """JAX HiFi-GAN module path -> the port's module name (convert's map)."""
    params = _small_vocoder()
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    paths = ["/".join(str(k.key) for k in p) for p, _ in leaves]
    marked = jax.tree_util.tree_unflatten(
        tree, [np.full(np.shape(v), i, np.float32) for i, (_, v) in enumerate(leaves)])
    names = {}
    for name, t in convert.hifigan_state_dict(marked).items():
        (i,) = np.unique(np.asarray(t))
        if "/" in paths[int(i)]:  # not the upsampling kernels, raw params of the root
            names[paths[int(i)].rsplit("/", 1)[0]] = name.rsplit(".", 1)[0]
    return names


def test_synthesis_bf16_layer_dtypes_match_jax():
    """``use_bf16`` synthesis: the port's decoder (K1 included) and vocoder
    run in bf16, the encoder in f32, layer by layer as the JAX package's
    ``_encode_fn`` and ``_decode_vocode_fn`` (JAX's U-Net recorded inside
    its ``nn.scan``): every one of the generator's layers that the request
    runs, and the vocoder's, gives its output in JAX's dtype."""
    cfg, jcfg = _cfgs(use_bf16=1)
    cfg = cfg.replace(text_buckets=(16,), mel_buckets=(64,))
    jcfg = jcfg.replace(text_buckets=(16,), mel_buckets=(64,))
    ids = np.arange(1, 11, dtype=np.int32)
    face = np.random.default_rng(0).uniform(0, 255, (224, 224, 3)).astype(np.float32)
    js = JSynthesizer(jcfg, vocoder_params=_small_vocoder())
    js.vocoder = JHiFiGAN(**SMALL_VOC)
    (jwav, _), seen = jax_layer_dtypes(js.synthesize, ids, face, seed=0)
    synth = Synthesizer(cfg, device="cpu")
    synth.vocoder = HiFiGANGenerator(**SMALL_VOC).eval().to(synth.dtype)
    voc = dict(synth.vocoder.named_modules())
    vseen, hooks = {}, []
    for path, name in _vocoder_names().items():
        hooks.append(voc[name].register_forward_hook(
            lambda m, a, out, path=path: vseen.setdefault(path, set()).add(
                str(out.dtype).replace("torch.", ""))))
    try:
        with _port_layer_dtypes(synth.model) as dtypes:
            wav, _ = synth.synthesize(ids, face, seed=0)
    finally:
        for h in hooks:
            h.remove()
    assert wav.dtype == jwav.dtype == np.float32
    want = {p: d for p, d in seen.items() if p in _layer_names()}
    assert dtypes == want
    decoder = {p: d for p, d in dtypes.items() if p.startswith("decoder/")}
    assert len(decoder) == 94 and all(d == {"bfloat16"} for d in decoder.values())
    assert all(d == {"float32"} for p, d in dtypes.items() if p.startswith("encoder/"))
    vwant = {p: d for p, d in seen.items() if p in _vocoder_names()}
    assert len(vwant) == len(_vocoder_names()) == 38 and vseen == vwant
    assert all(d == {"bfloat16"} for d in vseen.values())


# ---------------------------------------------------------------------------
# in-training evaluation


def _eval_cfg(**kw):
    cfg, _ = _cfgs(eval_n_samples=1, **kw)
    return cfg.replace(text_buckets=(16,), mel_buckets=(64,))


def test_intrain_evaluator(tmp_path, capsys):
    from facegantts_tpu_torch.train.step import init_state

    cfg = _eval_cfg(use_bf16=0)  # f32, for the copy-synthesis against JAX
    state = init_state(cfg, "cpu")
    ds = SyntheticDataset(n_items=2, n_mels=cfg.n_mels, min_frames=40, max_frames=48)
    ev = IntrainEvaluator(cfg, ds, str(tmp_path), device="cpu")
    assert "cfg.vocoder_ckpt unset" in capsys.readouterr().out
    assert not ev.vocoder_imported and ev.syncnet_apply.device == torch.device("cpu")
    results = ev.run(state, step=7)
    assert list(results) == INTRAIN_KEYS
    assert all(np.isfinite(v) for v in results.values()) and results["Samples"] == 1.0
    assert -1.0 <= results["Speaker Similarity"] <= 1.0 and 1.0 <= results["UTMOS"] <= 5.0
    step_dir = tmp_path / "step_00000007"
    assert (step_dir / "sample_0.wav").exists()
    text = (step_dir / "eval_output.txt").read_text()
    for backend in ("syncnet: RANDOM-INIT", "mos: DSP calibration proxy",
                    "vocoder: RANDOM-INIT"):
        assert f"# backend {backend}" in text
    assert "# backend f0: world" in text
    m = re.search(r"Composite Metric: ([0-9.eE+-]+)", text)
    assert m and abs(float(m.group(1)) - results["Composite Metric"]) < 1e-6
    # copy-synthesis of a ground-truth mel against JAX's stream_vocode, the
    # vocoder weights carried across
    _, jcfg = _cfgs(use_bf16=0)
    js = JSynthesizer(jcfg, params={}, vocoder_params=import_hifigan_state_dict(
        ev.synth.vocoder.state_dict()))
    gt = np.asarray(ds[0]["y"], np.float32)
    want = np.concatenate([np.asarray(c) for c in js.stream_vocode(jnp.asarray(gt))])
    got = ev._gt_wav(gt)
    assert got.shape == want.shape == (gt.shape[1] * cfg.hop_len,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_train_with_intrain_eval_ranks_on_composite(tmp_path):
    from facegantts_tpu_torch.train import checkpoint as ck
    from facegantts_tpu_torch.train.loop import train

    cfg = _eval_cfg(eval_interval=1, checkpoint_monitor="Composite Metric", f0_protocol="yin",
                    batch_size=2, num_gpus=1, log_every_n_steps=1)
    tr = SyntheticDataset(n_items=4, n_mels=cfg.n_mels, min_frames=40, max_frames=60)
    va = SyntheticDataset(n_items=2, n_mels=cfg.n_mels, min_frames=40, max_frames=48, seed=1)
    state = train(cfg, str(tmp_path), 2, tr, va, device="cpu")
    assert state.step == 2
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert "# backend f0: yin (fast estimator)" in recs[0]["eval_backends"]
    evals = [r for r in recs if "eval/Composite Metric" in r]
    assert [r["step"] for r in evals] == [1, 2]
    for r in evals:
        assert {k[5:] for k in r if k.startswith("eval/")} == set(INTRAIN_KEYS)
        assert all(np.isfinite(v) for v in r.values())
    for step in (1, 2):
        assert (tmp_path / "inference" / f"step_{step:08d}" / "sample_0.wav").exists()
    ranked = {s: json.load(open(tmp_path / "checkpoints" / str(s) / "metrics.json"))
              for s in ck.all_steps(str(tmp_path / "checkpoints"))}
    assert set(ranked) == {1, 2}
    for s, r in zip((1, 2), evals):
        assert r["step"] == s and ranked[s]["Composite Metric"] == pytest.approx(
            r["eval/Composite Metric"])
    best = min(evals, key=lambda r: r["eval/Composite Metric"])["step"]
    assert ck.all_steps(str(tmp_path / "best")) == [best]
