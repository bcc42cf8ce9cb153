"""The PyTorch port's persistence slice against the JAX package, on the CPU.

- ``CheckpointPolicy``: the port's and the JAX (orbax) policy driven
  through one ``save_epoch`` / ``save_step`` / ``snapshot`` sequence keep
  the same steps in ``checkpoints/`` (ranked by the monitor, the worst
  evicted whatever its age), ``last/``, ``best/`` and ``snapshots/``, name
  the same ``best_epoch_<E>_step_<S>`` link and return the same
  improvements;
- save -> restore of a plain and a GAN ``TrainState`` is bitwise (model,
  BatchNorm statistics, discriminator, both optimizers' moments and counts,
  the schedule's position, the step), and one step from the restored and
  from the saved state gives identical losses and parameters; a killed
  save leaves the earlier step restorable;
- ``train()`` resumes from ``<work>/last``: step, epoch and
  ``metrics.jsonl`` continue; the training CLI resumes from a directory and
  warm-starts from a reference file;
- the warm start from a reference-format FaceTTS file
  (``tests/torch_replica.py``'s names, plus ``discriminator.*`` and
  ``feature_extractor.*`` keys and one key of the wrong shape): every key
  that JAX's ``import_facetts`` + ``merge_imported`` carries, taken through
  ``convert.facetts_state_dict``, equals the port's after
  ``merge_state_dict``; the wrong-shaped key keeps its initial value in
  both;
- a bshall HiFi-GAN file (the weight-normed ``_THifi`` of
  ``tests/test_import.py``, as a ``generator`` entry with ``module.`` keys
  and as bare ``generator.`` keys) vocodes within 1e-5 of JAX's
  ``import_hifigan``;
- ``EarlyStopping``, ``MetricLogger`` (JSONL equal to JAX's, TensorBoard
  events written) and ``GracefulShutdown`` (a SIGTERM mid-run checkpoints
  and returns, and the old handler is back).

Dims: the JAX train tests' TINY generator and, for the GAN, the 8-channel
2-layer discriminator of ``tests/test_torch_gan.py``; torch on one
thread."""

import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facegantts_tpu.models.facetts import FaceTTS as JFaceTTS
from facegantts_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from facegantts_tpu.train import checkpoint as jck
from facegantts_tpu.train import loop as jloop
from facegantts_tpu.train.state import TrainState as JTrainState
from facegantts_tpu_torch import convert
from facegantts_tpu_torch.config import default_config
from facegantts_tpu_torch.data.dataset import BucketedLoader, SyntheticDataset
from facegantts_tpu_torch.models.facetts import FaceTTS
from facegantts_tpu_torch.models.hifigan import HiFiGANGenerator
from facegantts_tpu_torch.train import checkpoint as ck
from facegantts_tpu_torch.train import loop
from facegantts_tpu_torch.train.optim import _ClippedAdam
from facegantts_tpu_torch.train.state import Batch, TrainState
from facegantts_tpu_torch.train.step import init_state, make_gan_train_step, make_plain_train_step
from test_torch_e2e import _model_kwargs
from test_torch_gan import GAN, _batch
from test_torch_models import _random_variables
from test_torch_serve import SMALL_VOC
from test_torch_train import TINY
from torch_cpu import torch_threads_started  # noqa: F401
from tests.test_e2e_parity import DIMS, _inputs
from tests.test_import import _THifi
from tests.torch_replica import TFaceTTS

PLAIN = dict(TINY, warmup_steps="2")  # the learning rate moves with the count


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the retention policy against orbax's


def _steps(path):
    return sorted(int(d) for d in os.listdir(path) if d.isdigit()) if os.path.isdir(path) else []


def _layout(work):
    snaps = os.path.join(work, "snapshots")
    links = {f: os.readlink(os.path.join(work, f)) for f in os.listdir(work)
             if os.path.islink(os.path.join(work, f))}
    return {
        "top": _steps(os.path.join(work, "checkpoints")),
        "last": _steps(os.path.join(work, "last")),
        "best": _steps(os.path.join(work, "best")),
        "snapshots": {d: _steps(os.path.join(snaps, d)) for d in sorted(os.listdir(snaps))}
        if os.path.isdir(snaps) else {},
        "links": links,
        "entries": sorted(os.listdir(work)),
    }


# (op, step, epoch, total_loss): a ranked save, its snapshot skipped
# ("epoch_nosnap"), a periodic save (also repeated, also older), a snapshot
SEQUENCE = [("epoch", 10, 0, 5.0), ("step", 15), ("epoch", 20, 1, 1.0), ("epoch", 30, 2, 3.0),
            ("step", 35), ("epoch", 40, 3, 9.0), ("step", 35), ("step", 33),
            ("epoch_nosnap", 50, 4, 0.5), ("snapshot", 55, 4), ("epoch", 60, 5, 0.7),
            ("step", 60)]


def _port_state(step):
    model = torch.nn.Linear(3, 1)
    with torch.no_grad():
        model.weight.fill_(float(step))
    return TrainState(step=step, model=model, optimizer=_ClippedAdam([list(model.parameters())],
                                                                      1.0, 1e-3))


def _jax_state(step):
    return JTrainState(step=jnp.asarray(step, jnp.int32), params={"w": jnp.full(3, float(step))},
                       opt_state={"mu": {"w": jnp.zeros(3)}}, model_state={})


@pytest.mark.parametrize("keep_top_k", [1, 2, 3])
def test_policy_matches_jax(tmp_path, keep_top_k):
    works = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    port = ck.CheckpointPolicy(works["port"], keep_top_k=keep_top_k, snapshot_epochs=(0, 4))
    got, want = [], []
    with jck.CheckpointPolicy(works["jax"], keep_top_k=keep_top_k, snapshot_epochs=(0, 4)) as jax_pol:
        for op, step, *rest in SEQUENCE:
            for pol, mk, out in ((port, _port_state, got), (jax_pol, _jax_state, want)):
                if op.startswith("epoch"):
                    out.append(pol.save_epoch(mk(step), step, rest[0], {"total_loss": rest[1]},
                                              with_snapshot=op == "epoch"))
                elif op == "step":
                    pol.save_step(mk(step), step)
                else:
                    pol.snapshot(mk(step), step, rest[0])
                out.append(pol.best_name)
    assert got == want
    assert _layout(works["port"]) == _layout(works["jax"])
    assert _layout(works["port"])["links"] == {"best_epoch_4_step_50": "best/50"}
    best = ck.restore_checkpoint(os.path.join(works["port"], "best"), _port_state(0))
    assert best.step == 50 and float(best.model.weight.detach()[0, 0]) == 50.0


# ---------------------------------------------------------------------------
# save -> restore


def _gan_batch():
    return Batch(**_batch())


def _plain_batch():
    b = _batch()
    return Batch(**{k: v[:2] for k, v in b.items()})


def _state_and_step(kind, seed_shift=0):
    env = dict(GAN) if kind == "gan" else dict(PLAIN)
    cfg = default_config(env=env)
    state = init_state(cfg.replace(seed=cfg.seed + seed_shift), "cpu")
    make = make_gan_train_step if kind == "gan" else make_plain_train_step
    return cfg, state, make(cfg, "cpu")[0], (_gan_batch if kind == "gan" else _plain_batch)


def _flat(obj, prefix=""):
    """Every leaf of a (nested) state_dict, by path."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(obj, (list, tuple)):
        out = {}
        for i, v in enumerate(obj):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix: obj}


def _assert_same_state(a, b):
    assert a.step == b.step
    pairs = [(a.model.state_dict(), b.model.state_dict()),
             (a.optimizer.state_dict(), b.optimizer.state_dict())]
    if a.disc is not None:
        pairs += [(a.disc.state_dict(), b.disc.state_dict()),
                  (a.disc_optimizer.state_dict(), b.disc_optimizer.state_dict())]
    for x, y in pairs:
        fx, fy = _flat(x), _flat(y)
        assert fx.keys() == fy.keys()
        for k, v in fx.items():
            if isinstance(v, torch.Tensor):
                assert v.dtype == fy[k].dtype and torch.equal(v, fy[k]), k
            else:
                assert v == fy[k], k


def _one_step(train_step, state, batch):
    torch.manual_seed(3)  # dropout
    state, m = train_step(state, batch, torch.Generator().manual_seed(4))
    return {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("kind", ["plain", "gan"])
def test_round_trip_is_bitwise_and_steps_alike(tmp_path, kind):
    cfg, state, train_step, batch = _state_and_step(kind)
    _one_step(train_step, state, batch())  # moments and counts off zero
    state.model.syncnet.netcnnaud[1].running_mean.add_(0.25)  # BN statistics travel too
    d = str(tmp_path / "ckpt")
    ck.save_checkpoint(d, state, step=state.step)
    assert ck.all_steps(d) == [1]

    _, fresh, _, _ = _state_and_step(kind, seed_shift=1)
    assert not torch.equal(next(fresh.model.parameters()), next(state.model.parameters()))
    assert ck.restore_checkpoint(d, fresh) is fresh
    _assert_same_state(state, fresh)
    sd = ck.restore_generator_state_dict(d)
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in sd.items())
    if kind == "plain":
        assert fresh.optimizer.count == state.optimizer.count == 1

    m_saved = _one_step(train_step, state, batch())
    m_restored = _one_step(train_step, fresh, batch())
    assert m_saved == m_restored
    _assert_same_state(state, fresh)
    if kind == "plain":  # the schedule went on from the same position
        assert [g["lr"] for g in fresh.optimizer.opt.param_groups] == \
            [g["lr"] for g in state.optimizer.opt.param_groups]
        assert fresh.optimizer.opt.param_groups[0]["lr"] > 0


def test_restore_edges_and_killed_save(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    assert ck.restore_checkpoint(d, _port_state(0)) is None
    assert ck.restore_generator_state_dict(d) is None
    os.makedirs(os.path.join(d, "7"))  # a numbered directory without a checkpoint
    assert ck.latest_step(d) is None and ck.restore_checkpoint(d, _port_state(0)) is None
    for s in (1, 2, 3):
        ck.save_checkpoint(d, _port_state(s), step=s, keep=2)
    assert ck.all_steps(d) == [2, 3]
    assert ck.restore_checkpoint(d, _port_state(0), step=2).step == 2
    assert ck.restore_checkpoint(d, _port_state(0)).step == 3

    def killed(obj, f, *a, **k):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(ck.torch, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        ck.save_checkpoint(d, _port_state(4), step=4, keep=2)
    monkeypatch.undo()
    assert ck.all_steps(d) == [2, 3] and sorted(os.listdir(d)) == ["2", "3", "7"]
    assert ck.restore_checkpoint(d, _port_state(0)).step == 3

    _, gan_state, _, _ = _state_and_step("gan")
    ck.save_checkpoint(str(tmp_path / "gan"), gan_state, step=5)
    _, plain_state, _, _ = _state_and_step("plain")
    with pytest.raises(ValueError, match="use_gan differs"):
        ck.restore_checkpoint(str(tmp_path / "gan"), plain_state)


# ---------------------------------------------------------------------------
# the loop: resume, shutdown, early stopping, metrics


def _datasets():
    kw = dict(n_mels=128, min_frames=90, max_frames=130)
    return SyntheticDataset(n_items=10, **kw), SyntheticDataset(n_items=8, seed=1, **kw)


def _loop_cfg(**kw):
    return default_config(env=dict(PLAIN, batch_size="2", num_gpus="1", log_every_n_steps="1",
                                   **{k: str(v) for k, v in kw.items()}))


def test_train_resumes_step_epoch_and_metrics(tmp_path, monkeypatch):
    train_ds, val_ds = _datasets()
    cfg = _loop_cfg(save_step=2)
    n_batches = len(BucketedLoader(train_ds, cfg, 2))
    assert n_batches >= 2
    epochs = []
    orig_epoch = BucketedLoader.epoch

    def epoch(self, e=0):
        if self.shuffle:
            epochs.append(e)
        return orig_epoch(self, e)

    monkeypatch.setattr(BucketedLoader, "epoch", epoch)
    work = str(tmp_path / "run")
    first = n_batches + 1  # into epoch 1
    state = loop.train(cfg, work, first, train_ds, val_ds, device="cpu")
    assert state.step == first and epochs == [0, 1]
    assert ck.all_steps(os.path.join(work, "last")) == [first]
    assert ck.all_steps(os.path.join(work, "checkpoints"))  # ranked at epoch ends
    assert ck.all_steps(os.path.join(work, "snapshots", "epoch_0")) == [n_batches]
    saved = ck.restore_generator_state_dict(os.path.join(work, "last"))

    epochs.clear()
    resumed = loop.train(cfg.replace(resume_from=os.path.join(work, "last")), work, first + 2,
                         train_ds, val_ds, device="cpu")
    assert resumed.step == first + 2
    assert epochs == [first // n_batches]  # the epoch it stopped in, from its start
    assert ck.all_steps(os.path.join(work, "last")) == [first + 2]
    with open(os.path.join(work, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "train/total_loss" in r] == list(range(1, first + 3))
    assert any("val/total_loss" in r and r["step"] == first + 2 for r in recs)
    # the resumed run started from the checkpoint, not from its own init
    fresh = init_state(cfg, "cpu").model.state_dict()
    name = "encoder.proj_m.bias"
    assert not torch.equal(saved[name], fresh[name])


def test_train_cli_resumes_and_warm_starts(tmp_path, capsys):
    from facegantts_tpu_torch.train import __main__ as train_main

    args = [f"{k}={v}" for k, v in PLAIN.items()] + [
        "device=cpu", "batch_size=2", "num_gpus=1", "log_every_n_steps=1"]
    work = tmp_path / "a"
    train_main.main(args + ["max_steps=1", f"work_dir={work}"])
    train_main.main(args + ["max_steps=2", f"work_dir={work}", f"resume_from={work / 'last'}"])
    with open(work / "metrics.jsonl") as f:
        assert [r["step"] for r in map(json.loads, f) if "train/total_loss" in r] == [1, 2]
    assert ck.all_steps(str(work / "last")) == [2]

    cfg = default_config(env=PLAIN)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(123)
        donor = FaceTTS.from_config(cfg).state_dict()
    torch.save({"state_dict": dict(donor, **{"discriminator.conv_prev.bias": torch.ones(3)}),
                "epoch": 9}, tmp_path / "ref.ckpt")
    capsys.readouterr()
    train_main.main(args + ["max_steps=1", f"work_dir={tmp_path / 'b'}",
                            f"resume_from={tmp_path / 'ref.ckpt'}"])
    assert f"warm-starting generator from {tmp_path / 'ref.ckpt'}" in capsys.readouterr().out
    train_main.main(args + ["max_steps=1", f"work_dir={tmp_path / 'c'}",
                            f"resume_from={tmp_path / 'nothing.pt'}"])
    assert "not found; training from scratch" in capsys.readouterr().out


def test_graceful_shutdown_checkpoints_and_returns(tmp_path, monkeypatch):
    assert threading.current_thread() is threading.main_thread()
    orig = loop.make_plain_train_step

    def make(cfg, device):
        train_step, val_step = orig(cfg, device)

        def step(state, b, gen, **kw):
            out = train_step(state, b, gen, **kw)
            if state.step == 2:
                signal.raise_signal(signal.SIGTERM)
            return out

        return step, val_step

    monkeypatch.setattr(loop, "make_plain_train_step", make)
    before = signal.getsignal(signal.SIGTERM)
    train_ds, val_ds = _datasets()
    work = str(tmp_path / "run")
    state = loop.train(_loop_cfg(), work, 50, train_ds, val_ds, device="cpu")
    assert state.step == 2
    assert ck.all_steps(os.path.join(work, "last")) == [2]
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("values", [
    [1.0, 0.5, 0.5, 0.499, 0.5], [3.0, 2.0, 1.0, 0.0, -1.0], [1.0, 1.0, 1.0, 1.0, 0.9, 1.0]])
def test_early_stopping_matches_jax(values):
    port, ref = loop.EarlyStopping(2, 0.01), jloop.EarlyStopping(2, 0.01)
    assert [port.update(v) for v in values] == [ref.update(v) for v in values]
    assert (port.best, port.bad) == (ref.best, ref.bad)


def test_metric_logger_matches_jax(tmp_path):
    port, ref = loop.MetricLogger(str(tmp_path / "port")), jloop.MetricLogger(str(tmp_path / "jax"))
    for lg in (port, ref):
        lg.log(1, {"total_loss": 1.5, "grad_norm": np.float32(0.25)})
        lg.log(2, {"total_loss": 1.25}, prefix="val")
        lg.log_audio(2, "eval/sample_0", np.zeros(160, np.float32), 16000)
    port.close()
    ref._f.close()
    with open(port.path) as a, open(ref.path) as b:
        assert a.read() == b.read()
    assert port.tb is not None  # tensorboard is installed here
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "port"))


# ---------------------------------------------------------------------------
# reference weights


WRONG = "encoder.proj_m.bias"


def test_warm_start_matches_jax_import(tmp_path):
    torch.manual_seed(0)
    sd = TFaceTTS(**DIMS).state_dict()
    good = {k: v.clone() for k, v in sd.items()}
    sd[WRONG] = torch.randn(sd[WRONG].shape[0] + 3)
    sd["discriminator.conv_prev.weight_v"] = torch.randn(4, 1, 3, 3)
    sd["feature_extractor.fc.weight"] = torch.randn(2, 2)
    path = str(tmp_path / "facetts.ckpt")
    torch.save({"state_dict": sd, "epoch": 3, "hyper_parameters": {"lr": 1e-4}}, path)

    # JAX: import_facetts + merge_imported into seeded variables
    kw = _model_kwargs()
    jm = JFaceTTS(**{k: v for k, v in kw.items() if k != "fused_gn"}, syncnet_width_mult=1.0,
                  fused_gn=1)
    x, x_len, face, _ = _inputs()
    variables = _random_variables(jm, x, x_len, 2, 16, 1.0, False, face[:1], 1.0,
                                  jax.random.PRNGKey(0), seed=11)
    params, stats = jck.import_facetts(path)
    merged = {"params": jck.merge_imported(variables["params"], params),
              "batch_stats": jck.merge_imported(variables["batch_stats"], stats)}
    want, jax_init = convert.facetts_state_dict(merged), convert.facetts_state_dict(variables)

    # the port: merge_state_dict into a fresh model
    loaded = ck.load_facetts_state_dict(path)
    assert not any(k.startswith(("discriminator", "feature_extractor")) for k in loaded)
    torch.manual_seed(1)
    model = FaceTTS(**kw, syncnet_width_mult=1.0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    copied = ck.merge_state_dict(model, loaded)
    got = model.state_dict()
    assert WRONG not in copied and set(copied) == set(good) - {WRONG}

    carried = [k for k in want if k != WRONG]
    assert len(carried) > 100 and set(want) <= set(got)
    for k in carried:
        assert torch.equal(want[k], good[k]), k  # JAX carried the file's value
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_array_equal(want[WRONG].numpy(), jax_init[WRONG].numpy())
    assert torch.equal(got[WRONG], init[WRONG])
    # what JAX does not hold (the SyncNet audio stream) loads too, by name
    aud = [k for k in got if k.startswith("syncnet.netcnnaud.")]
    assert aud and all(torch.equal(got[k], good[k]) for k in aud)

    # warm_start: the generator from the file, the optimizer untouched
    cfg = default_config(env=PLAIN)
    state = init_state(cfg, "cpu")
    donor = {k: v + 1 for k, v in state.model.state_dict().items() if v.is_floating_point()}
    torch.save(dict(donor, **{"discriminator.x": torch.ones(1)}), tmp_path / "port.pt")
    loop.warm_start(cfg.replace(resume_from=str(tmp_path / "port.pt")), state)
    assert all(torch.equal(state.model.state_dict()[k], v) for k, v in donor.items())


@pytest.mark.parametrize("layout", ["generator_entry", "prefixed"])
def test_hifigan_file_matches_jax_import(tmp_path, layout):
    torch.manual_seed(2)
    tnet = _THifi().eval()
    sd = tnet.state_dict()
    assert any(k.endswith(".weight_g") for k in sd) and "ups.0.weight_v" in sd
    if layout == "generator_entry":
        raw = {"generator": {f"module.{k}": v for k, v in sd.items()}, "steps": 100}
    else:
        raw = {f"generator.{k}": v for k, v in sd.items()}
    path = str(tmp_path / "hifigan.pt")
    torch.save(raw, path)

    voc = HiFiGANGenerator(**SMALL_VOC).eval()
    voc.load_state_dict(ck.load_hifigan_state_dict(path))
    mel = torch.randn(2, 16, 20)
    with torch.no_grad():
        got, ref = voc(mel).numpy(), tnet(mel).numpy()
    jwav = JHiFiGAN(**SMALL_VOC).apply({"params": jck.import_hifigan(path)}, jnp.asarray(mel.numpy()))
    np.testing.assert_allclose(got, np.asarray(jwav), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
