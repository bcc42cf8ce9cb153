"""The PyTorch port's analysis statistics, weight pins and sweeps
(``evaluation/analysis.py``, ``weights.py``, ``hyperopt.py``) against the
JAX package's, on the CPU:

- ``mos_statistics`` and ``pairwise_wilcoxon`` equal JAX's on seeded
  ratings (paired and unequal lengths, identical systems, three systems);
  every plot is written where matplotlib imports, and with matplotlib
  blocked each plot call raises an ``ImportError`` that names it;
  ``collect_mos_samples`` writes JAX's files, with cv2 and without;
- ``weights``: pin, verify, refusal of an unpinned, altered or unknown
  file, ``load_verified`` through the port's SSL MOS importer, the CLI,
  and every ``ARTIFACTS`` importer resolving to a callable of
  ``facegantts_tpu_torch`` for JAX's four artifacts;
- ``hyperopt``: ``grid_points``, ``random_points`` and ``cem_search``
  (with ``tests/test_aux.py``'s quadratic objective) equal to JAX's for a
  seed, ``sweep`` in each mode, ``read_composite`` on written
  ``eval_output.txt`` files, and ``run_trial``'s command (the port's
  trainer) and its ``inf`` on a failed trial, ``subprocess.run`` patched."""

import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from facegantts_tpu import hyperopt as jhyperopt
from facegantts_tpu import weights as jweights
from facegantts_tpu.evaluation import analysis as janalysis
from facegantts_tpu_torch import hyperopt, weights
from facegantts_tpu_torch.evaluation import analysis, ssl_mos
from torch_cpu import torch_threads_started  # noqa: F401


def _ratings(seed=0):
    rng = np.random.default_rng(seed)
    return {"ours": rng.normal(4.0, 0.3, 40), "baseline": rng.normal(3.0, 0.5, 40),
            "copy": np.round(rng.normal(3.8, 0.4, 37) * 2) / 2, "single": [3.5]}


@pytest.mark.parametrize("systems", [("ours", "baseline"), ("ours", "baseline", "copy"),
                                     ("copy", "single"), ("ours", "ours_again")])
def test_mos_statistics_and_wilcoxon_equal_jax(systems):
    r = _ratings()
    r["ours_again"] = r["ours"]
    ratings = {s: r[s] for s in systems}
    assert analysis.mos_statistics(ratings) == janalysis.mos_statistics(ratings)
    for bonferroni in (True, False):
        got = analysis.pairwise_wilcoxon(ratings, bonferroni)
        assert got == janalysis.pairwise_wilcoxon(ratings, bonferroni)
        assert len(got) == len(systems) * (len(systems) - 1) // 2


def _plots(mod, rng, d):
    """(file name, call writing it) for every plot function of ``mod``, their
    inputs written into ``d``."""
    from PIL import Image

    mel = rng.standard_normal((80, 60))
    log = os.path.join(d, "metrics.jsonl")
    with open(log, "w") as f:
        for i in range(5):
            f.write(json.dumps({"step": i, "train/loss": 1.0 / (i + 1)}) + "\n")
    face = os.path.join(d, "face.png")
    Image.fromarray((rng.random((32, 32, 3)) * 255).astype("uint8")).save(face)
    calls = [
        ("mel.png", lambda p: mod.save_mel_plot(mel, p, title="t")),
        ("spec.png", lambda p: mod.save_spectrogram_db(mel * 10, p, title="t")),
        ("cmp.png", lambda p: mod.save_mel_comparison([("a", mel), ("b", mel + 1)], p)),
        ("progress.png", lambda p: mod.save_epoch_progress([(0, mel), (10, mel * 2)], p)),
        ("faces.pdf", lambda p: mod.save_face_grid_pdf([face, face, face], p, cols=2)),
        ("curves.png", lambda p: mod.plot_training_curves(log, p)),
    ]
    return calls


def test_plots_written(tmp_path):
    pytest.importorskip("matplotlib")
    for name, call in _plots(analysis, np.random.default_rng(0), str(tmp_path)):
        call(str(tmp_path / name))
        assert os.path.getsize(tmp_path / name) > 1000, name


def test_plots_without_matplotlib_raise_by_name(tmp_path, monkeypatch):
    calls = _plots(analysis, np.random.default_rng(0), str(tmp_path))
    for m in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for name, call in calls:
        with pytest.raises(ImportError, match="matplotlib"):
            call(str(tmp_path / name))
        assert not os.path.exists(tmp_path / name)
    # the statistics need no matplotlib
    assert analysis.mos_statistics({"a": [1.0, 2.0]})["a"]["mean"] == 1.5


def _collect_inputs(root):
    out = root / "outputs"
    for spk, clip, n in (("spk1", "00001", 1600), ("spk2", "00002", 16)):
        (out / spk).mkdir(parents=True)
        with wave.open(str(out / spk / f"{clip}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(np.arange(n, dtype=np.int16).tobytes())
    vdir = root / "videos" / "spk1"
    vdir.mkdir(parents=True)
    try:
        import cv2
    except ImportError:
        return out
    vw = cv2.VideoWriter(str(vdir / "00001.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25, (64, 64))
    rng = np.random.default_rng(0)
    for _ in range(10):
        vw.write(rng.integers(0, 255, (64, 64, 3), np.uint8))
    vw.release()
    return out


@pytest.mark.parametrize("with_cv2", [True, False])
def test_collect_mos_samples_equals_jax(tmp_path, monkeypatch, with_cv2):
    out = _collect_inputs(tmp_path)
    if with_cv2:
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
    wavs = [str(out / "spk1" / "00001.wav"), str(out / "spk2" / "00002.wav"), "bare.wav"]
    results = {}
    for tag, mod in (("port", analysis), ("jax", janalysis)):
        target = tmp_path / tag
        faces = mod.collect_mos_samples(wavs, str(tmp_path / "videos"), str(target), seed=3)
        results[tag] = ([os.path.basename(f) for f in faces], sorted(os.listdir(target)),
                        [open(target / f, "rb").read() for f in sorted(os.listdir(target))])
    assert results["port"] == results["jax"]
    assert results["port"][0] == (["spk1_00001_face.png"] if with_cv2 else [])
    assert {"spk1_00001.wav", "spk2_00002.wav"} <= set(results["port"][1])


# ---------------------------------------------------------------------------
# weights


def test_weights_artifacts_resolve_in_the_port():
    assert set(weights.ARTIFACTS) == set(jweights.ARTIFACTS)
    for name, meta in weights.ARTIFACTS.items():
        assert meta["source"] == jweights.ARTIFACTS[name]["source"]
        assert meta["importer"].startswith("facegantts_tpu_torch."), name
        fn = weights._resolve(meta["importer"])
        assert callable(fn) and fn.__module__.startswith("facegantts_tpu_torch."), name
    assert weights._DEFAULT_PINS_PATH == os.path.join(
        os.path.dirname(weights.__file__), "assets", "weight_pins.json")


def test_weights_pin_verify_and_refusals(tmp_path, monkeypatch):
    monkeypatch.setenv("FACEGANTTS_WEIGHT_PINS", str(tmp_path / "pins.json"))
    f = tmp_path / "syncnet.pt"
    f.write_bytes(b"pretend-checkpoint")
    with pytest.raises(RuntimeError,
                       match="(?s)first contact.*python -m facegantts_tpu_torch.weights pin"):
        weights.verify("syncnet", str(f))
    digest = weights.pin("syncnet", str(f))
    assert digest == jweights.sha256_file(str(f)) == weights.verify("syncnet", str(f))
    with open(tmp_path / "pins.json") as fh:
        assert json.load(fh) == {"syncnet": digest}
    f.write_bytes(b"pretend-checkpoint-tampered")
    with pytest.raises(RuntimeError, match="mismatch"):
        weights.verify("syncnet", str(f))
    with pytest.raises(RuntimeError, match="force"):
        weights.pin("syncnet", str(f))
    assert weights.pin("syncnet", str(f), force=True) == weights.verify("syncnet", str(f))
    with pytest.raises(KeyError):
        weights.verify("nonsense", str(f))
    with pytest.raises(KeyError):
        weights.pin("nonsense", str(f))


def test_weights_load_verified_through_the_ssl_importer(tmp_path, monkeypatch):
    """A UTMOS-strong file pinned, then loaded through the port's importer;
    a copy with one byte altered is refused before it is read."""
    monkeypatch.setenv("FACEGANTTS_WEIGHT_PINS", str(tmp_path / "pins.json"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = ssl_mos.UTMOSStrong(hidden=24, layers=1, heads=2, ffn=48, conv_dims=(16, 16),
                                    cond_dim=6, blstm_hidden=10, proj_hidden=32, pos_kernel=16,
                                    pos_groups=2)
    path = tmp_path / "utmos.pt"
    torch.save(ssl_mos.reference_state_dict(model.state_dict()), path)
    weights.pin("utmos22_strong", str(path))
    state, info = weights.load_verified("utmos22_strong", str(path))
    assert info["unmapped"] == [] and set(state) == set(model.state_dict())
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 1
    bad = tmp_path / "utmos_altered.pt"
    bad.write_bytes(bytes(data))
    with pytest.raises(RuntimeError, match="mismatch"):
        weights.load_verified("utmos22_strong", str(bad))


def test_weights_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("FACEGANTTS_WEIGHT_PINS", str(tmp_path / "pins.json"))
    f = tmp_path / "hifigan.pt"
    f.write_bytes(b"vocoder")
    assert weights.main(["list"]) == 0
    out = capsys.readouterr().out
    assert all(n in out for n in weights.ARTIFACTS) and "<unpinned>" in out
    assert weights.main(["pin", "hifigan_16k", str(f)]) == 0
    assert weights.main(["verify", "hifigan_16k", str(f)]) == 0
    out = capsys.readouterr().out
    assert f"OK hifigan_16k {weights.sha256_file(str(f))}" in out
    assert weights.main(["list"]) == 0
    assert weights.sha256_file(str(f)) in capsys.readouterr().out


# ---------------------------------------------------------------------------
# hyperopt

SPEC = {"learning_rate": {"min": 1e-6, "max": 1e-1, "log": True},
        "dropout": {"min": 0.0, "max": 0.5},
        "loss_type": {"choices": ["hinge", "mse"]}}


def _quadratic(params, work_dir):
    """``tests/test_aux.py``'s CEM objective, plus terms for the other keys."""
    return float((np.log(params["learning_rate"]) - np.log(3e-4)) ** 2
                 + (params.get("dropout", 0.1) - 0.1) ** 2
                 + (params.get("loss_type") == "mse"))


def test_grid_and_random_points_equal_jax():
    grid = {"learning_rate": [1e-4, 1e-5], "batch_size": [16, 32, 64], "loss_type": ["hinge"]}
    assert list(hyperopt.grid_points(grid)) == list(jhyperopt.grid_points(grid))
    assert len(list(hyperopt.grid_points(grid))) == 6
    for seed in (0, 7):
        got = list(hyperopt.random_points(SPEC, 9, seed))
        assert got == list(jhyperopt.random_points(SPEC, 9, seed))
        assert len({p["learning_rate"] for p in got}) == 9


@pytest.mark.parametrize("seed", [0, 3])
def test_cem_search_equals_jax(seed, tmp_path):
    kw = dict(generations=4, population=8, seed=seed, run=_quadratic)
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d)
    got = hyperopt.cem_search(SPEC, {"batch_size": 16}, str(tmp_path / "port"), **kw)
    want = jhyperopt.cem_search(SPEC, {"batch_size": 16}, str(tmp_path / "jax"), **kw)
    assert got == want and len(got) == 32
    with open(tmp_path / "port" / "results.json") as f:
        saved = json.load(f)
    assert [r["composite"] for r in saved] == sorted(r["composite"] for r in got)
    best = min(got, key=lambda r: r["composite"])
    assert abs(np.log(best["params"]["learning_rate"]) - np.log(3e-4)) < 1.2


@pytest.mark.parametrize("mode", ["grid", "random", "cem"])
def test_sweep_equals_jax(mode, tmp_path, monkeypatch):
    config = {"fixed": {"use_gan": 0, "max_steps": 2},
              "grid": {"learning_rate": [1e-3, 1e-4, 3e-4]}, "random": SPEC,
              "generations": 2, "population": 3}
    calls = {}
    for tag, mod in (("port", hyperopt), ("jax", jhyperopt)):
        seen = calls[tag] = []

        def run(params, work_dir, _seen=seen, _root=str(tmp_path / tag)):
            _seen.append((params, os.path.relpath(work_dir, _root)))
            return _quadratic(params, work_dir)

        monkeypatch.setattr(mod, "run_trial", run)  # cem_search's default too
        res = mod.sweep(config, out_root=str(tmp_path / tag), max_jobs=2, mode=mode, seed=1)
        with open(tmp_path / tag / "results.json") as f:
            calls[tag].append(json.load(f))
        calls[tag].append(res)
    assert calls["port"] == calls["jax"]
    saved = calls["port"][-2]
    assert [r["composite"] for r in saved] == sorted(r["composite"] for r in saved)
    assert all(p["use_gan"] == 0 for p, _ in calls["port"][:-2])


def _eval_output(path, value, mtime):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# backend mos: utmos-ssl checkpoint (x)\nComposite Metric: {value}\nUTMOS: 3.1\n")
    os.utime(path, (mtime, mtime))


def test_read_composite(tmp_path):
    assert hyperopt.read_composite(str(tmp_path)) == float("inf")
    _eval_output(str(tmp_path / "inference" / "step_00000002" / "eval_output.txt"), 0.75, 1e9)
    _eval_output(str(tmp_path / "inference" / "step_00000004" / "eval_output.txt"), 1.5e-2, 2e9)
    _eval_output(str(tmp_path / "eval" / "eval_output.txt"), 9.0, 1.5e9)
    assert hyperopt.read_composite(str(tmp_path)) == jhyperopt.read_composite(str(tmp_path)) \
        == 1.5e-2
    with open(tmp_path / "inference" / "step_00000004" / "eval_output.txt", "w") as f:
        f.write("no metric\n")
    os.utime(tmp_path / "inference" / "step_00000004" / "eval_output.txt", (3e9, 3e9))
    assert hyperopt.read_composite(str(tmp_path)) == float("inf")


@pytest.mark.parametrize("rc", [0, 1])
def test_run_trial_runs_the_port_trainer(rc, tmp_path, monkeypatch):
    seen = []

    def fake_run(args, env=None, **kw):
        seen.append((args, env))
        if rc == 0:
            _eval_output(os.path.join(tmp_path, "trial", "inference", "step_00000002",
                                      "eval_output.txt"), 0.25, 1e9)
        return subprocess.CompletedProcess(args, rc)

    monkeypatch.setattr(subprocess, "run", fake_run)
    wd = str(tmp_path / "trial")
    got = hyperopt.run_trial({"learning_rate": 1e-4, "use_gan": 0, "device": "cpu"}, wd)
    [(args, env)] = seen
    assert args == [sys.executable, "-m", "facegantts_tpu_torch.train", "learning_rate=0.0001",
                    "use_gan=0", "device=cpu", f"work_dir={wd}"]
    assert env["DYNAMIC_EVAL_PATH"] == os.path.join(wd, "eval")
    assert got == (0.25 if rc == 0 else float("inf"))
