"""The PyTorch port's tooling against the JAX package, on the CPU:
profiling (``utils/profiling.py``), the FLOP audit (``utils/flops.py``), the
benchmark entry point (``bench.py``) and checkpoint migration
(``migrate_checkpoint.py``).

- ``StepTimer`` gives JAX's statistics on the same injected clock;
  ``StepProfiler`` opens and closes its trace at the steps JAX's does, does
  nothing without a directory, and ``train()`` with ``profile_dir`` writes
  a trace holding the loop's spans.
- FLOPs: at the full U-Net width (``dec_dim`` 64; B 2, 64 frames) a U-Net
  evaluation counts 0.95 to 1 of the JAX audit's (XLA's cost model also
  counts elementwise work: 0.979 here, 0.959 at B 16, 436 frames) and the
  D phase's gradient 0.99 to 1 (convolutions: 0.9965); ``step`` composes
  as JAX's, and one real step counts ``step`` less the discriminator
  forward on the fake that the step reuses, exactly.
- The bench's functions run at tiny widths on the CPU; its entry point
  without a card exits non-zero and prints no metric line; no figure set on
  or for the TPU appears in it.
- ``torch2port`` of a replica ``.pt`` restores to the generator weights
  that JAX's ``torch_to_orbax`` writes (carried across by ``convert.py``);
  ``fix-lightning`` as ``tests/test_aux.py`` tests JAX's.
"""

import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from facegantts_tpu_torch.config import default_config
from torch_cpu import torch_threads_started  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_train.py's TINY, with the face conditioning
TINY = dict(n_enc_channels="16", filter_channels="32", filter_channels_dp="16",
            n_enc_layers="1", dec_dim="8", vid_emb_dim="32", timesteps="2",
            syncnet_width_mult="0.125", spk_emb="face", use_gan="0")
GAN_TINY = dict(TINY, micro_batch_size="2", disc_base_channels="8", disc_num_layers="2")


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


# --------------------------------------------------------------------------
# profiling


def test_step_timer_matches_jax(monkeypatch):
    import time

    from facegantts_tpu.utils.profiling import StepTimer as JStepTimer
    from facegantts_tpu_torch.utils.profiling import StepTimer

    stamps = np.cumsum(np.random.default_rng(0).uniform(0.01, 0.3, 40)).tolist()
    stats = []
    for cls in (JStepTimer, StepTimer):
        clock = iter(stamps)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = cls(window=7)
        assert timer.stats() == {}
        for _ in range(20):
            timer.tic()
            timer.toc()
        stats.append(timer.stats())
    assert stats[0] == stats[1] and set(stats[1]) == {
        "step_time_median_s", "step_time_p90_s", "steps_per_sec"}


def test_step_profiler_window_matches_jax(monkeypatch, tmp_path):
    """Where the trace opens and closes, step by step, against JAX's
    ``StepProfiler`` (its ``jax.profiler`` calls recorded); no trace
    without a directory; the trace file once the window has closed."""
    import jax

    from facegantts_tpu.utils.profiling import StepProfiler as JStepProfiler
    from facegantts_tpu_torch.utils.profiling import StepProfiler

    events = []
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: events.append("start"))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: events.append("stop"))
    steps = [0, 1, 2, 3, 4, 5, 6]
    want = []
    jp = JStepProfiler(str(tmp_path / "jax"), 2, 3)
    for s in steps:
        jp.step(s)
        want.append(jp._active)
    jp.close()

    prof = StepProfiler(str(tmp_path / "port"), 2, 3)
    got = []
    for s in steps:
        prof.step(s)
        got.append(prof.active)
        torch.ones(4).sum()  # something to trace
    prof.close()
    assert got == want == [False, False, True, True, True, False, False]
    assert events == ["start", "stop"]
    assert glob.glob(str(tmp_path / "port" / "*.pt.trace.json"))

    off = StepProfiler("", 0, 3)
    for s in steps:
        off.step(s)
        assert not off.active
    off.close()


def test_train_writes_a_trace(tmp_path):
    from facegantts_tpu_torch.data.dataset import SyntheticDataset
    from facegantts_tpu_torch.train.loop import train

    cfg = default_config(env={}, overrides=dict(
        TINY, batch_size="2", num_gpus="1", log_every_n_steps="1", eval_interval="0",
        profile_dir=str(tmp_path / "prof"), profile_start_step="1", profile_num_steps="1"))
    kw = dict(n_mels=128, min_frames=40, max_frames=60)
    data = SyntheticDataset(n_items=4, **kw), SyntheticDataset(n_items=2, seed=1, **kw)
    train(cfg, str(tmp_path / "work"), max_steps=3, train_ds=data[0], val_ds=data[1],
          device="cpu")
    traces = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "train_step" in names


# --------------------------------------------------------------------------
# FLOPs


def test_gan_step_flops_against_jax():
    import jax
    import jax.numpy as jnp

    from facegantts_tpu.config import default_config as jax_config
    from facegantts_tpu.models.unet import GradLogPEstimator2d
    from facegantts_tpu.train.step import build_models, make_gan_loss_fns
    from facegantts_tpu.utils.flops import _flops
    from facegantts_tpu_torch.utils.flops import N_MICRO, gan_step_flops

    over = dict(GAN_TINY, dec_dim="64", timesteps="10")
    ty, tx, mb = 64, 16, 2
    got = gan_step_flops(default_config(env={}, overrides=over), ty, tx, device="cpu")

    # JAX's gan_step_flops, its unet_eval and d_grad pieces as it lowers them
    cfg = jax_config(env={}, overrides=over)
    unet = GradLogPEstimator2d(dim=cfg.dec_dim, multi_spks=1, spk_emb_dim=cfg.vid_emb_dim,
                               n_feats=cfg.n_mels, pe_scale=1000.0)
    x_t, mask = jnp.zeros((mb, cfg.n_mels, ty)), jnp.ones((mb, 1, ty))
    args = (x_t, mask, x_t, jnp.full((mb,), 0.5), jnp.zeros((mb, cfg.vid_emb_dim)))
    params = jax.eval_shape(lambda: unet.init(jax.random.PRNGKey(0), *args))["params"]
    j_unet = _flops(lambda p, *a: unet.apply({"params": p}, *a), params, *args)
    model, disc = build_models(cfg)
    _, d_loss_fn, _ = make_gan_loss_fns(cfg, model, disc)
    dp = jax.eval_shape(lambda: disc.init(jax.random.PRNGKey(0), x_t[..., None]))["params"]
    j_d = _flops(lambda p, y, f: jax.grad(lambda p_: d_loss_fn(p_, y, f, True)[0])(p),
                 dp, x_t, x_t)

    assert 0.95 <= got["unet_eval"] / j_unet <= 1.0, got["unet_eval"] / j_unet
    assert 0.99 <= got["d_grad"] / j_d <= 1.0, got["d_grad"] / j_d
    t = cfg.train_fake_timesteps
    assert got["sampler"] == got["prologue"] + t * got["unet_eval"] and got["prologue"] > 0
    assert got["step"] == N_MICRO * (got["sampler"] + got["d_grad"] + got["g_grad"])
    assert got["step_measured"] == got["step"] - N_MICRO * got["disc_fake"] > 0


# --------------------------------------------------------------------------
# the bench


def test_bench_functions_cpu():
    from facegantts_tpu_torch import bench

    cfg = default_config(env={}, overrides=dict(GAN_TINY, use_bf16="0", text_buckets="16,32",
                                                mel_buckets="64,128"))
    rtf = bench.bench_inference(cfg, "cpu", n_iters=2)
    sps, sec, flops, mfu = bench.bench_gan_step(cfg, "cpu", n_iters=1, bucket=(16, 64))
    agg, per = bench.bench_bucket_mix(cfg, "cpu", n_iters=1,
                                      mix=((16, 64, 0.6), (32, 128, 0.4)))
    ups = bench.bench_batch_throughput(cfg, "cpu", batch=2, n_iters=1)
    for v in (rtf, sps, sec, flops, mfu, agg, ups):
        assert np.isfinite(v) and v > 0
    assert sps == pytest.approx(4 / sec) and len(per) == 2
    assert agg == pytest.approx(1 / sum(f / s for _, _, f, s in per))


def test_bench_without_card_prints_no_metric(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "facegantts_tpu_torch.bench"],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


def test_bench_holds_no_tpu_figure():
    with open(os.path.join(ROOT, "facegantts_tpu_torch", "bench.py")) as f:
        src = f.read()
    for word in ("V5E", "v5e", "197e12", "PRIOR_ROUND", "vs_prior_round", "RTF_REGRESSION",
                 "probe_backend", "compile_probe", "0.05 /"):
        assert word not in src, word
    assert not re.findall(r"(?<![a-z])tpu(?!_opt|_torch)", src, re.IGNORECASE)


def test_entry_points_without_card_raise(monkeypatch, tmp_path):
    from facegantts_tpu_torch import export, migrate_checkpoint
    from facegantts_tpu_torch.utils import flops

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "ref.pt"
    torch.save({"state_dict": {}}, src)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.main([f"out_dir={tmp_path / 'b'}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        migrate_checkpoint.main([f"src={src}", f"dst={tmp_path / 'd'}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flops.main([])
    assert not os.path.exists(tmp_path / "b") and not os.path.exists(tmp_path / "d")


# --------------------------------------------------------------------------
# checkpoint migration


def test_torch2port_matches_jax_torch_to_orbax(tmp_path):
    from facegantts_tpu.config import default_config as jax_config
    from facegantts_tpu.migrate_checkpoint import torch_to_orbax
    from facegantts_tpu.train.checkpoint import restore_generator_variables
    from facegantts_tpu_torch import convert
    from facegantts_tpu_torch.migrate_checkpoint import main
    from facegantts_tpu_torch.train import checkpoint as ck
    from tests.test_e2e_parity import DIMS, _stable_torch_replica

    replica = _stable_torch_replica(DIMS)
    sd = replica.state_dict()
    src = tmp_path / "reference.pt"
    torch.save({"state_dict": {**sd, "discriminator.conv.weight": torch.ones(2)}}, src)
    over = dict(n_enc_channels=str(DIMS["n_channels"]),
                filter_channels=str(DIMS["filter_channels"]),
                filter_channels_dp=str(DIMS["filter_channels_dp"]),
                n_enc_layers=str(DIMS["n_layers"]), dec_dim=str(DIMS["dec_dim"]),
                vid_emb_dim=str(DIMS["spk_emb_dim"]), syncnet_width_mult="0.125",
                spk_emb="face", use_gan="0")
    torch_to_orbax(str(src), str(tmp_path / "jax"), jax_config(env={}, overrides=over))
    main([f"src={src}", f"dst={tmp_path / 'port'}", "device=cpu",
          *(f"{k}={v}" for k, v in over.items())])

    state = ck.restore_generator_state_dict(str(tmp_path / "port"))
    want = convert.facetts_state_dict(restore_generator_variables(str(tmp_path / "jax")))
    assert set(state) == set(want)
    # the file's tensors (SyncNet's at another width stay each side's own
    # initialisation, as in both importers)
    from_file = [k for k in sd if k in state and state[k].shape == sd[k].shape]
    assert set(from_file) >= {k for k in state if not k.startswith("syncnet.")}
    for k in from_file:
        assert torch.equal(state[k], sd[k].float()), k
        assert torch.equal(want[k], sd[k].float()), k
    # a port checkpoint directory at step 0 that the trainer resumes
    payload = torch.load(tmp_path / "port" / "0" / ck.CKPT_FILE, weights_only=True)
    assert payload["step"] == 0 and "disc" not in payload


def test_fix_lightning_version(tmp_path):
    from facegantts_tpu_torch.migrate_checkpoint import main

    src, dst = tmp_path / "old.ckpt", tmp_path / "new.ckpt"
    torch.save({"state_dict": {}}, str(src))
    main([f"src={src}", f"dst={dst}", "mode=fix-lightning"])
    out = torch.load(str(dst), weights_only=False)
    assert "pytorch-lightning_version" in out
