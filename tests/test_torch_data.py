"""The PyTorch port's data slice against the JAX package, on the CPU.

- the numpy copies: ``spectral_gate``, ``fade_out``, ``rbj_coeffs``,
  ``biquad``, ``apply_filter_chain`` (every filter on) and
  ``VoiceFeatureExtractor`` equal the JAX package's to 1e-12 on seeded
  voiced and noisy signals;
- ``pack_split`` on a small LRS2-shaped tree written here (4 clips of 2
  speakers: wav, ``Text:`` line and jpg face; one clip without its face,
  which both skip): text ids, faces, speaker ids and offsets exactly equal
  to the JAX package's shards, the float16 log-mels at the mel op's bars
  (``tests/test_torch_eval.py``) plus one float16 ulp, and the port's
  ``load_packed`` reads both shard formats to the same items.

Torch runs on one thread, the mel op on the CPU."""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from facegantts_tpu.config import default_config as jax_default_config
from facegantts_tpu.data import denoise as jdenoise
from facegantts_tpu.data import filters as jfilters
from facegantts_tpu.data import preprocess as jpre
from facegantts_tpu.feature_extractor import VoiceFeatureExtractor as JVFE
from facegantts_tpu_torch.config import default_config
from facegantts_tpu_torch.data import denoise, filters, preprocess
from facegantts_tpu_torch.data.dataset import SHARD_MEMBERS, load_packed
from facegantts_tpu_torch.feature_extractor import VoiceFeatureExtractor
from torch_cpu import torch_threads_started  # noqa: F401

SR = 16000
TEXTS = ["Text: THE QUICK BROWN FOX", "Text: JUMPS OVER THE LAZY DOG",
         "Text: SHE SELLS SEA SHELLS", "Text: NINETEEN HUNDRED AND TWO"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def speech_like(seconds, seed, f0=(110.0, 180.0)):
    """A seeded speech-like clip in [-1, 1]: voiced harmonic segments with a
    gliding F0 and a vowel-like spectral tilt, separated by pauses, over a
    low noise floor."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    lo, hi = f0
    f = lo + (hi - lo) * (0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1.5, 3.0) * t))
    phase = 2 * np.pi * np.cumsum(f) / SR
    voiced = sum(np.sin(k * phase) / k ** 1.2 for k in range(1, 25))
    gate = (np.sin(2 * np.pi * rng.uniform(2.0, 3.5) * t + rng.uniform(0, 6)) > -0.3)
    y = 0.25 * voiced * gate + 0.01 * rng.standard_normal(n)
    return (y / np.abs(y).max() * 0.8).astype(np.float32)


def _close_1e12(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# numpy copies


@pytest.mark.parametrize("seed", [0, 1])
def test_spectral_gate_and_fade_match_jax(seed):
    y = speech_like(0.8, seed)
    for prop in (0.7, 1.0):
        _close_1e12(denoise.spectral_gate(y, SR, prop_decrease=prop),
                    jdenoise.spectral_gate(y, SR, prop_decrease=prop))
    short = y[:500]  # shorter than n_fft: returned as it is
    _close_1e12(denoise.spectral_gate(short, SR), jdenoise.spectral_gate(short, SR))
    _close_1e12(denoise.fade_out(y, SR), jdenoise.fade_out(y, SR))
    _close_1e12(denoise.fade_out(y[:10], SR, 0.05), jdenoise.fade_out(y[:10], SR, 0.05))


def test_filters_match_jax():
    y = speech_like(0.6, 2)
    for kind in ("highpass", "lowpass", "bandreject"):
        for fc, q in ((70.0, filters.DEFAULT_Q), (4500.0, 1.0), (150.0, 2.5)):
            b, a = filters.rbj_coeffs(kind, SR, fc, q)
            jb, ja = jfilters.rbj_coeffs(kind, SR, fc, q)
            _close_1e12(b, jb)
            _close_1e12(a, ja)
            for clamp in (True, False):
                _close_1e12(filters.biquad(y * 3, b, a, clamp),
                            jfilters.biquad(y * 3, jb, ja, clamp))
    with pytest.raises(ValueError):
        filters.rbj_coeffs("notch", SR, 100.0)
    on = dict(use_bandstop_filter="1", use_highpass_filter="1", use_lowpass_filter="1")
    for env in ({}, on):
        cfg, jcfg = default_config(env=env), jax_default_config(env=env)
        log, jlog = [], []
        _close_1e12(filters.apply_filter_chain(y, SR, cfg, log),
                    jfilters.apply_filter_chain(y, SR, jcfg, jlog))
        assert log == jlog and len(log) == (3 if env else 0)
    _close_1e12(filters.detect_bandstop_freq(y, SR, 1024, 160),
                jfilters.detect_bandstop_freq(y, SR, 1024, 160))


def test_voice_feature_extractor_matches_jax():
    cfg, jcfg = default_config(env={}), jax_default_config(env={})
    ours, theirs = VoiceFeatureExtractor(cfg), JVFE(jcfg)
    dict_cfg = {k: getattr(cfg, k) for k in ("sample_rate", "hop_len", "n_fft", "win_len",
                                             "n_mels", "f_min", "f_max")}
    assert vars(VoiceFeatureExtractor(dict_cfg)) == vars(ours)
    for y in (speech_like(0.5, 3), np.random.default_rng(4).standard_normal(6000) * 0.1):
        for name in ("extract_mel_spectrogram", "extract_f0", "extract_energy"):
            got, want = getattr(ours, name)(y), getattr(theirs, name)(y)
            assert got.shape == want.shape and got.dtype == want.dtype, name
            _close_1e12(got, want)


# ---------------------------------------------------------------------------
# pack_split


def write_lrs2_tree(root):
    """A small LRS2-shaped corpus under ``root``: the filelist, the wavs
    under wav/trainval, the ``Text:`` lines and the jpg faces beside them
    under trainval; the third clip has no face.  Returns the Config
    overrides that point at it."""
    from PIL import Image

    names = ["spk_a/00001", "spk_a/00002", "spk_b/00001", "spk_b/00002"]
    rng = np.random.default_rng(7)
    for i, n in enumerate(names):
        for d in ("wav/trainval", "trainval"):
            os.makedirs(os.path.join(root, d, n.split("/")[0]), exist_ok=True)
        y = speech_like(0.6 + 0.3 * i, 10 + i)
        wavfile.write(os.path.join(root, "wav/trainval", n + ".wav"), SR,
                      (y * 32767).astype(np.int16))
        with open(os.path.join(root, "trainval", n + ".txt"), "w") as f:
            f.write(TEXTS[i] + "\nConf: 4\n")
        if i != 2:
            img = rng.integers(0, 255, (180, 200, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(root, "trainval", n + ".jpg"))
    lst = os.path.join(root, "train.list")
    with open(lst, "w") as f:
        f.write("\n".join(names) + "\n")
    return {"lrs2_path": root, "lrs2_train": lst}


def _members(path):
    if os.path.isdir(path):
        return {m: np.load(os.path.join(path, f"{m}.npy")) for m in SHARD_MEMBERS}
    with np.load(path) as z:
        return {m: z[m] for m in SHARD_MEMBERS}


def _f16_ulp(v):
    """The spacing of float16 numbers at |v| (normal range)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -14)))
    return 2.0 ** (e - 10)


def test_pack_split_matches_jax(tmp_path, capsys):
    over = write_lrs2_tree(str(tmp_path / "lrs2"))
    shards = {}
    for fmt in ("raw", "npz"):
        for pkg, (mk, pack) in {"port": (default_config, preprocess.pack_split),
                                "jax": (jax_default_config, jpre.pack_split)}.items():
            cfg = mk(env={}, overrides=dict(over, packed_data_dir=str(tmp_path / pkg / fmt)))
            kw = {"device": "cpu"} if pkg == "port" else {}
            (shards[(pkg, fmt)],) = pack(cfg, "train", shard_size=8, pack_format=fmt, **kw)
    out = capsys.readouterr().out
    assert out.count("[WARN] no face frame for spk_b/00001, skipping") == 4
    assert shards[("port", "npz")].endswith(".npz") and os.path.isdir(shards[("port", "raw")])
    for fmt in ("raw", "npz"):
        got, want = _members(shards[("port", fmt)]), _members(shards[("jax", fmt)])
        for m in ("text_flat", "text_offsets", "mel_offsets", "faces", "spk_ids"):
            assert got[m].dtype == want[m].dtype, m
            np.testing.assert_array_equal(got[m], want[m], err_msg=m)
        np.testing.assert_array_equal(got["spk_ids"], [0, 0, 1])
        assert got["mel_flat"].dtype == np.float16 and got["mel_flat"].shape == (
            want["mel_flat"].shape)
        a, b = got["mel_flat"].astype(np.float64), want["mel_flat"].astype(np.float64)
        offs = got["mel_offsets"]
        for lo, hi in zip(offs[:-1], offs[1:]):  # per clip; per frame below
            la, lb = np.exp(a[:, lo:hi]), np.exp(b[:, lo:hi])
            top = lb.max(axis=0, keepdims=True)
            ulp = _f16_ulp(b[:, lo:hi])
            # linear: 1e-5 of the frame's largest value, plus the ulp's share
            assert (np.abs(la - lb) <= 1e-5 * top + lb * (np.exp(ulp) - 1)).all()
            live = lb > 1e-3 * top
            assert (np.abs(a[:, lo:hi] - b[:, lo:hi])[live] <= 1e-4 + ulp[live]).all()
    # the port's loader reads both formats, to the same items
    cfg_raw = default_config(env={}, overrides=dict(packed_data_dir=str(tmp_path / "port/raw")))
    cfg_npz = default_config(env={}, overrides=dict(packed_data_dir=str(tmp_path / "port/npz")))
    ds_raw, ds_npz = load_packed(cfg_raw, "train"), load_packed(cfg_npz, "train")
    assert len(ds_raw) == len(ds_npz) == 3 and ds_raw.lengths() == ds_npz.lengths()
    for i in range(3):
        r, z = ds_raw[i], ds_npz[i]
        assert set(r) == set(z)
        for k in r:
            np.testing.assert_array_equal(np.asarray(r[k]), np.asarray(z[k]), err_msg=k)
    assert ds_raw[0]["spk"].shape == (224, 224, 3)


def test_preprocess_cli(tmp_path):
    """``python -m facegantts_tpu_torch.data.preprocess`` arguments through
    ``main``: the split, the shard size, the format and the device."""
    over = write_lrs2_tree(str(tmp_path / "lrs2"))
    argv = [f"{k}={v}" for k, v in over.items()] + [
        f"packed_data_dir={tmp_path / 'packed'}", "split=train", "shard_size=2",
        "pack_format=npz", "device=cpu"]
    paths = preprocess.main(argv)
    assert [os.path.basename(p) for p in paths] == ["train_00000.npz", "train_00001.npz"]
    with pytest.raises(SystemExit):
        preprocess.main([f"{k}={v}" for k, v in over.items()] + ["device=cpu"])
