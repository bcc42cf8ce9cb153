"""The PyTorch port's inference slice end to end, on the CPU.

1. ``test_slice_matches_jax``: FaceTTS encode + decode (SyncNet face
   embedding, text encoder, ceiled durations, alignment, 10-step reverse
   diffusion over the U-Net with the K1 chain) at ``test_e2e_parity.py``'s
   reduced ``DIMS`` and reference ``RECIPE``, the same variables carried
   across with ``convert.py`` and the same injected noise on both sides.
2. ``test_golden_mel``: the committed torch-replica golden
   (``tests/golden/e2e_golden.npz``) loaded straight into the port with
   ``load_state_dict``, at the same bars as ``test_golden_mel_regression``.
3. The CPU entry points: ``Synthesizer(device="cpu")`` on the ``test/``
   fixtures, and ``python -m facegantts_tpu_torch.inference``.

Bars (those of ``test_e2e_parity.py``): equal ``y_lengths``, mel max
difference < 2e-3 and mean < 2e-4 over the valid frames, the masked tail
exactly zero.  Torch runs strict f32."""

import os

import jax
import numpy as np
import pytest
import torch

from facegantts_tpu.models.facetts import FaceTTS as JFaceTTS
from facegantts_tpu_torch import convert
from facegantts_tpu_torch.config import default_config
from facegantts_tpu_torch.models.facetts import FaceTTS
from torch_cpu import torch_threads_started  # noqa: F401
from tests.test_e2e_parity import DIMS, EST_SCALE, GOLDEN, RECIPE, Y_MAX, _inputs
from tests.test_torch_models import _random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNC_WIDTH = 0.25  # the composition, not SyncNet's width, is under test here


@pytest.fixture(autouse=True)
def _strict_f32():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _model_kwargs(fused_gn=1):
    return dict(
        n_vocab=DIMS["n_vocab"], n_feats=DIMS["n_feats"], n_enc_channels=DIMS["n_channels"],
        filter_channels=DIMS["filter_channels"], filter_channels_dp=DIMS["filter_channels_dp"],
        n_heads=DIMS["n_heads"], n_enc_layers=DIMS["n_layers"], enc_kernel=DIMS["kernel_size"],
        enc_dropout=0.0, window_size=DIMS["window_size"], dec_dim=DIMS["dec_dim"],
        beta_min=0.05, beta_max=20.0, pe_scale=float(DIMS["pe_scale"]),
        vid_emb_dim=DIMS["spk_emb_dim"], fused_gn=fused_gn,
    )


def _assert_bars(mel, y_len, want_mel, want_ylen):
    np.testing.assert_array_equal(y_len, want_ylen)
    n = int(want_ylen[0])
    d = np.abs(mel[0, :, :n] - want_mel[0, :, :n])
    assert d.max() < 2e-3, f"max |port - reference| = {d.max():.2e}"
    assert d.mean() < 2e-4, f"mean |port - reference| = {d.mean():.2e}"
    assert not mel[0, :, n:].any(), "masked tail is not exactly zero"


def test_slice_matches_jax():
    kw = _model_kwargs()
    jm = JFaceTTS(**{k: v for k, v in kw.items() if k != "fused_gn"},
                  syncnet_width_mult=SYNC_WIDTH, fused_gn=1)
    x, x_len, face, noise = _inputs()
    variables = _random_variables(jm, x, x_len, 2, 16, 1.0, False, face[:1], 1.0,
                                  jax.random.PRNGKey(0), seed=11)
    # keep the 10-step reverse ODE finite at temperature 1.5, as the
    # reduced-width parity test does (same scaled weights on both sides)
    variables["params"]["decoder"] = jax.tree.map(
        lambda a: a * np.float32(EST_SCALE), variables["params"]["decoder"])
    # longer durations, so the alignment covers most of the Y_MAX frames
    proj = variables["params"]["encoder"]["proj_w"]["proj"]
    proj["bias"] = proj["bias"] + np.float32(2.5)

    _, j_mel, _, j_ylen = jax.jit(
        lambda v, x_, xl, f, n: jm.apply(
            v, x_, xl, RECIPE["n_timesteps"], Y_MAX, RECIPE["temperature"], False, f,
            RECIPE["length_scale"], jax.random.PRNGKey(0), False, n)
    )(variables, x, x_len, face, noise)

    tm = FaceTTS(**kw, syncnet_width_mult=SYNC_WIDTH).eval()
    missing, unexpected = tm.load_state_dict(convert.facetts_state_dict(variables), strict=False)
    assert not unexpected
    assert missing and all(k.startswith(("syncnet.netcnnaud.", "syncnet.netfcaud.")) for k in missing)
    with torch.no_grad():
        _, mel, _, y_len = tm(
            torch.from_numpy(x).long(), torch.from_numpy(x_len).long(), RECIPE["n_timesteps"],
            Y_MAX, RECIPE["temperature"], spk=torch.from_numpy(face),
            length_scale=RECIPE["length_scale"], noise=torch.from_numpy(noise))
    mel = mel.numpy()
    assert np.isfinite(mel).all() and 32 <= int(y_len[0]) < Y_MAX
    _assert_bars(mel, y_len.numpy(), np.asarray(j_mel), np.asarray(j_ylen))


@pytest.mark.parametrize("fused_gn", [0, 1])
def test_golden_mel(fused_gn):
    z = np.load(GOLDEN)
    sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd:")}
    tm = FaceTTS(**_model_kwargs(fused_gn)).eval()
    missing, unexpected = tm.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.startswith("syncnet.") for k in missing)  # the golden stores the embedding
    with torch.no_grad():
        _, mel, _, y_len = tm(
            torch.from_numpy(z["x"]).long(), torch.from_numpy(z["x_len"]).long(),
            RECIPE["n_timesteps"], Y_MAX, RECIPE["temperature"], spk=torch.from_numpy(z["spk"]),
            length_scale=RECIPE["length_scale"], spk_is_embedding=True,
            noise=torch.from_numpy(z["noise"]))
    _assert_bars(mel.numpy(), y_len.numpy(), z["mel"], z["y_lengths"])


TINY = dict(n_enc_channels="32", filter_channels="64", filter_channels_dp="32",
            n_enc_layers="2", dec_dim="8", vid_emb_dim="32", syncnet_width_mult="0.125",
            fused_gn_mish="1", timesteps="3", temperature="8")


@pytest.mark.parametrize("use_bf16", ["0", "1"])
def test_synthesizer_cpu(use_bf16):
    from facegantts_tpu_torch.synthesis import Synthesizer, load_face, pick_bucket
    from facegantts_tpu_torch.text.cmudict import default_cmudict

    cfg = default_config(env={}, overrides=dict(TINY, use_bf16=use_bf16))
    synth = Synthesizer(cfg, cmudict=default_cmudict(), device="cpu")
    face = load_face(os.path.join(ROOT, "test", "face.png"))
    with open(os.path.join(ROOT, "test", "text.txt")) as f:
        texts = [ln.strip() for ln in f if ln.strip()]
    wavs = []
    for text in texts + texts[:1]:  # the repeat takes the duration-cache path
        wav, mel = synth.synthesize(text, face)
        assert np.isfinite(wav).all() and np.isfinite(mel).all()
        assert mel.shape[0] == cfg.n_mels and len(wav) == mel.shape[1] * cfg.hop_len
        wavs.append(wav)
    np.testing.assert_array_equal(wavs[0], wavs[-1])
    assert len(synth._ty_cache) == len(texts)

    batch = synth.synthesize_batch(texts, face)
    for one, wav in zip(wavs, batch):
        assert np.isfinite(wav).all() and len(wav) == len(one)
    assert pick_bucket(300, cfg.mel_buckets) == 436 and pick_bucket(900, cfg.mel_buckets) == 900

    # stochastic sampling: per-step noise from the seeded generator
    s1, _ = synth.synthesize(texts[0], face, stoc=True, seed=3)
    s2, _ = synth.synthesize(texts[0], face, stoc=True, seed=3)
    s3, _ = synth.synthesize(texts[0], face, stoc=True, seed=4)
    np.testing.assert_array_equal(s1, s2)
    assert np.isfinite(s1).all() and len(s1) == len(wavs[0]) and not np.array_equal(s1, s3)


def test_synthesize_file_cpu(tmp_path):
    from scipy.io import wavfile

    from facegantts_tpu_torch.synthesis import Synthesizer

    cfg = default_config(env={}, overrides=dict(TINY, use_bf16="0"))
    synth = Synthesizer(cfg, device="cpu")
    paths = synth.synthesize_file(["Hello there.", "A face speaks."],
                                  os.path.join(ROOT, "test", "face.png"), str(tmp_path), tag="t")
    assert [os.path.basename(p) for p in paths] == ["t_sample_0.wav", "t_sample_1.wav"]
    for p in paths:
        sr, data = wavfile.read(p)
        assert sr == cfg.sample_rate and data.dtype == np.int16
        assert len(data) > 0 and len(data) % cfg.hop_len == 0


def test_inference_cli_cpu(tmp_path):
    from facegantts_tpu_torch import inference

    args = [f"{k}={v}" for k, v in TINY.items()] + [
        "device=cpu", "use_custom=1", f"output_dir={tmp_path}",
        f"test_txt={os.path.join(ROOT, 'test', 'text.txt')}",
        f"test_faceimg={os.path.join(ROOT, 'test', 'face.png')}",
    ]
    inference.main(args)
    assert sorted(os.listdir(tmp_path)) == ["face_sample_0.wav", "face_sample_1.wav"]
    with pytest.raises(SystemExit, match="packed dataset"):
        inference.main(args[:-4] + ["use_custom=0"])
