#!/usr/bin/env python3
"""Drive the PyTorch port (facegantts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on a failed check (the script then exits
non-zero and prints no result line):

1. set-up: the card's name and power limit (nvidia-smi), the build of every
   hand-written kernel from ``facegantts_tpu_torch/csrc`` (seconds, ptxas).
2. the main path at the full published width (Config defaults: encoder
   192/768/6 layers, U-Net dec_dim 64, SyncNet width 1.0, HiFi-GAN 512),
   random weights from a seed, ``fused_gn_mish=1``, T=10 Euler steps,
   temperature 8 (at 1.5 a randomly initialised full-width reverse ODE
   overflows): four requests through ``Synthesizer.synthesize`` (the
   ``test/`` sentences and face, one repeated for the duration cache) and
   one ``synthesize_batch`` call, in bf16 and in f32.  Every waveform must
   be finite and ``n_frames * hop`` long, and every kernel's launch count
   (zeroed just before, read just after) must show the path went through it:
   K1 launches 25 times per U-Net evaluation, 250 per utterance.
3. every kernel against its plain torch version on the card, at the shapes
   the main path gave it plus the Ty=436 bucket's shapes at batch 1 and 4,
   in f32 (max abs error <= 1e-4) and bf16 (<= 0.05), TF32 off; median
   times of the kernel, the plain version and a library yardstick, and the
   bound (bytes over 3.35 TB/s vs operations over 67 TFLOP/s, H100 SXM).
4. one f32 utterance decoded with the kernel (``fused_gn_mish=1``) and with
   plain torch ops (``fused_gn_mish=0``), same weights, same injected noise,
   TF32 off: the mel difference is bounded.
5. where one bf16 request's device time goes (``torch.profiler``).
6. the training path: ``train/loop.train`` with the plain FaceTTS step
   (``use_gan=0``) at the Config defaults (published widths),
   ``fused_gn_mish=1``, f32 with PyTorch's TF32 defaults, on
   ``SyntheticDataset`` (seed 0) at batch 64 (the reference recipe's 256
   over 4 GPUs), 5 steps and the validation pass.  Every loss and
   ``grad_norm`` is finite, the encoder moved, the frozen SyncNet audio trunk
   is bit-identical, and with the counts zeroed just before: K1 launched 25
   times and MAS once per loss evaluation.  Step times, peak memory, buckets,
   and a ``torch.profiler`` breakdown of one warm step.
7. K2's only consumer (``FusedGroupNorm``, forward and backward at the five
   training U-Net shapes) and the probe entry point (P1, P2), each with its
   counts zeroed just before.
8. MAS (exactly equal paths: on the first training step's own log-prior
   and mask, at B=64 and every (text, mel) bucket the steps ran, and at the
   top buckets T_x 256, T_y 656 and 872), K1's forward kernel plus its
   recomputed backward (1e-4), K2 (sums to 1e-5 relative, GroupNorm to
   1e-4) and P1, P2 (exactly equal) against their plain versions, with
   times, bounds and library times.

Then a ``{"kernels": [...]}`` line and, last, the device line.
"""

import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
K1_PER_EVAL = 25  # K1 launches per parity U-Net evaluation
# K1 shapes (B, C, F, T) of one U-Net evaluation at the Ty=436 bucket, with
# their launch counts (unet.py: 5 at full resolution, 8 at /2, 12 at /4)
K1_EVAL_436 = [((1, 64, 128, 436), 5), ((1, 128, 64, 218), 4), ((1, 64, 64, 218), 4),
               ((1, 256, 32, 109), 8), ((1, 128, 32, 109), 4)]
K1_OPS_PER_ELEM = 13  # stats 3 + normalise 2 + mish 7 (exp counted once) + mask 1
PATH_KERNELS = ("gn_mish_mask",)  # wrapper names (kernels.LAUNCHES keys) on the path
TRAIN_PATH_KERNELS = ("gn_mish_mask", "maximum_path")
SM_CLOCK_HZ = 1.98e9  # H100 SXM maximum SM clock
DEP_STEP_CYCLES = 8  # one dependent f32 add and max: ~4 cycles each
TRAIN_STEPS = 5
# the reference recipe: batch_size 256 over num_gpus 4 -> 64 per card
TRAIN_OVERRIDES = dict(use_gan=0, fused_gn_mish=1, batch_size=256, num_gpus=4,
                       log_every_n_steps=1)
# K1 (and K2) shapes (B, C, F, T) of one U-Net evaluation in training: the
# 128-frame crop at batch 64, with launch counts as K1_EVAL_436
K1_TRAIN = [((64, 64, 128, 128), 5), ((64, 128, 64, 64), 4), ((64, 64, 64, 64), 4),
            ((64, 256, 32, 32), 8), ((64, 128, 32, 32), 4)]
MAS_SHAPES = [(64, 256, 656), (64, 256, 872)]  # (B, T_x, T_y): top text and mel buckets


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=50, reps=7):
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_profile(fn, n=1):
    """Run ``fn`` ``n`` times under torch.profiler; returns
    ({kernel name: device us per run}, wall us per run).  Empty when the
    profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6 / n
    per = collections.Counter()
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0:
            per[e.key] += e.self_device_time_total / n
    return per, wall


class strict_f32:
    """TF32 off for convolutions and matmuls inside the block."""

    def __enter__(self):
        import torch

        self.prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.prev


def k1_bound(shape, dtype_bytes):
    """(least ms, "bytes" or "operations") for one K1 call at ``shape``."""
    b, c, f, t = shape
    n = b * c * f * t
    moved = 2 * n * dtype_bytes + 2 * c * 4 + b * 4  # x, y, scale, bias, lens
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, n * K1_OPS_PER_ELEM / F32_FLOPS_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def k1_check(shape, dtype, gen, profile_device=False):
    """K1 against its plain version at one shape; returns errors and times."""
    import torch
    import torch.nn.functional as F

    from facegantts_tpu_torch.ops.gn_mish import gn_mish_mask, gn_mish_mask_ref

    b, c, f, t = shape
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    scale = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1
    bias = torch.randn(c, generator=gen, device="cuda")
    lens = torch.tensor([t - 3, t, t // 2, 1][:b] if b > 1 else [t - 3],
                        dtype=torch.int32, device="cuda")
    got = gn_mish_mask(x, scale, bias, lens)
    want = gn_mish_mask_ref(x, scale, bias, lens)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 0.05
    if not err <= tol:
        raise AssertionError(f"K1 {shape} {dtype}: max abs err {err:.3e} > {tol}")
    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None]).to(dtype)[:, None, None, :]

    def library():
        return F.mish(F.group_norm(x, 8, scale.to(dtype), bias.to(dtype), 1e-5)) * mask

    bound_ms, bound_by = k1_bound(shape, x.element_size())
    out = {
        "err": err,
        "ms": time_ms(lambda: gn_mish_mask(x, scale, bias, lens)),
        "plain_ms": time_ms(lambda: gn_mish_mask_ref(x, scale, bias, lens)),
        "library_ms": time_ms(library),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    if profile_device:  # device time alone, without the host's launch gaps
        for key, fn in (("dev_us", lambda: gn_mish_mask(x, scale, bias, lens)),
                        ("plain_dev_us", lambda: gn_mish_mask_ref(x, scale, bias, lens)),
                        ("library_dev_us", library)):
            # the profiler now and then returns no device events: retry,
            # then leave the number out ("not measured") rather than 0
            for _ in range(3):
                out[key] = sum(device_profile(fn, n=20)[0].values()) or None
                if out[key]:
                    break
    return out


def bound(n_bytes, n_ops=0.0, chain_s=0.0):
    """(least ms, "bytes" or "operations"): bytes over the HBM rate against
    operations over the f32 rate or, where longer, a chain of dependent
    steps (an operations bound too)."""
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_ops = max(n_ops / F32_FLOPS_PER_S, chain_s)
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def train_phase(work_dir):
    """The training path: ``train/loop.train`` on synthetic data for
    TRAIN_STEPS steps at the per-card batch of the reference recipe, then
    its validation pass (4 batches).  Returns what it measured, the final
    state and the first step's MAS inputs; raises on a failed check."""
    import shutil

    import torch

    from facegantts_tpu_torch.config import default_config
    from facegantts_tpu_torch.data.dataset import BucketedLoader, SyntheticDataset
    from facegantts_tpu_torch.models import facetts as facetts_mod
    from facegantts_tpu_torch.ops import gn_mish, kernels, mas
    from facegantts_tpu_torch.train.loop import train
    from facegantts_tpu_torch.train.step import init_state

    cfg = default_config(env={}, overrides=TRAIN_OVERRIDES)
    # 1024 items give 11 full batches of 64 in epoch 0; 512 give 4
    train_ds = SyntheticDataset(n_items=1024, n_mels=cfg.n_mels, seed=0)
    val_ds = SyntheticDataset(n_items=512, n_mels=cfg.n_mels, seed=1)
    buckets = [k for k, _ in BucketedLoader(train_ds, cfg, cfg.per_gpu_batchsize)
               ._epoch_plan(0)[:TRAIN_STEPS]]
    init = dict(init_state(cfg, "cpu").model.named_parameters())  # same seed, same weights
    mas_inputs = []  # the first step's (log-prior, mask), to check MAS on
    orig = facetts_mod.maximum_path

    def recording(value, mask):
        if not mas_inputs:
            mas_inputs.append((value.clone(), mask.clone()))
        return orig(value, mask)

    shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    facetts_mod.maximum_path = recording
    try:
        kernels.LAUNCHES.clear()
        t0 = time.perf_counter()
        state = train(cfg, work_dir, TRAIN_STEPS, train_ds, val_ds, device="cuda")
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        facetts_mod.maximum_path = orig
    peak = torch.cuda.max_memory_allocated()

    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "train/total_loss" in r]
    vals = [r for r in recs if "val/total_loss" in r]
    if [r["step"] for r in steps] != list(range(1, TRAIN_STEPS + 1)):
        raise AssertionError(f"[train] logged steps {[r['step'] for r in steps]}")
    for r in steps + vals:
        bad = [k for k, v in r.items() if k != "step" and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"[train] non-finite {bad} at step {r['step']}")
    if not vals:
        raise AssertionError("[train] the validation pass ran no batch")
    forwards = TRAIN_STEPS + sum(int(r["val/batches"]) for r in vals)
    want = {gn_mish.NAME: K1_PER_EVAL * forwards * cfg.fused_gn_mish, mas.NAME: forwards}
    for k, n in want.items():
        if launches.get(k, 0) != n:
            raise AssertionError(f"[train] {k} launched {launches.get(k, 0)} times, "
                                 f"want {n} ({forwards} loss evaluations)")
    final = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    if all(torch.equal(final[n], p) for n, p in init.items() if n.startswith("encoder.")):
        raise AssertionError("[train] no encoder parameter moved")
    trunk = [n for n in init if n.startswith("syncnet.netcnnaud.")]
    if not trunk or not all(torch.equal(final[n], init[n]) for n in trunk):
        raise AssertionError("[train] the frozen SyncNet audio trunk moved")
    return {
        "cfg": cfg, "steps": steps, "vals": vals, "launches": launches, "wall_s": wall,
        "step_ms": [1e3 / r["train/steps_per_sec"] for r in steps], "peak_bytes": peak,
        "buckets": buckets, "forwards": forwards, "state": state, "mas_inputs": mas_inputs[0],
    }


def train_profile(cfg, state, n=2):
    """Device time of ``n`` warm training steps of ``state`` on one batch by
    kernel name, and the unprofiled wall time of one step."""
    import torch

    from facegantts_tpu_torch.data.dataset import BucketedLoader, SyntheticDataset
    from facegantts_tpu_torch.train.step import make_plain_train_step

    ds = SyntheticDataset(n_items=1024, n_mels=cfg.n_mels, seed=0)
    batch = next(BucketedLoader(ds, cfg, cfg.per_gpu_batchsize).epoch(0))
    step, _ = make_plain_train_step(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def one():
        step(state, batch, gen)

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for _ in range(3):  # the profiler now and then returns no device events
        per, _ = device_profile(one, n=n)
        if per:
            break
    return per, wall, (batch.x.shape[1], batch.y.shape[2])


def mas_inputs(shape, gen):
    """A (B, T_x, T_y) log-prior and mask with ragged lengths, the first
    item full size and every text no longer than its mel."""
    import torch

    b, t_x, t_y = shape
    cpu = torch.Generator().manual_seed(b * t_x + t_y)
    tx = torch.randint(t_x // 4, t_x + 1, (b,), generator=cpu)
    ty = torch.maximum(tx, torch.randint(t_y // 3, t_y + 1, (b,), generator=cpu))
    tx[0], ty[0] = t_x, t_y
    value = torch.randn(shape, generator=gen, device="cuda") * 10
    mask = ((torch.arange(t_x)[None, :, None] < tx[:, None, None])
            & (torch.arange(t_y)[None, None, :] < ty[:, None, None])).float().cuda()
    return value, mask


def mas_check(value, mask):
    """The MAS kernel against its plain version on one (B, T_x, T_y)
    log-prior and mask: exactly equal paths."""
    import torch

    from facegantts_tpu_torch.ops.mas import maximum_path, maximum_path_ref

    b, t_x, t_y = value.shape
    got = maximum_path(value, mask)
    want = maximum_path_ref(value, mask)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"[MAS] {tuple(value.shape)}: kernel and plain paths differ at "
                             f"{int((got != want).sum())} cells")
    # The path depends on value and mask only inside the feasibility band
    # max(0, tx + y - ty) <= x <= min(tx - 1, y) (outside it the DP writes
    # -1e9 whatever the input), tx * (ty - tx + 1) cells per item.  Least
    # bytes: both read there, the mask's first column and row for the
    # lengths, the path written whole.  Below that, T_y dependent column steps.
    tx = mask[:, :, 0].sum(-1).long().clamp(min=1)
    ty = mask[:, 0, :].sum(-1).long().clamp(min=1)
    band = int((tx * (ty - tx + 1).clamp(min=0)).sum())
    n_bytes = 4 * (2 * band + b * (t_x + t_y) + b * t_x * t_y)
    bound_ms, bound_by = bound(n_bytes, chain_s=t_y * DEP_STEP_CYCLES / SM_CLOCK_HZ)
    return {
        "err": 0.0,
        "ms": time_ms(lambda: maximum_path(value, mask), iters=20, reps=5),
        "plain_ms": time_ms(lambda: maximum_path_ref(value, mask), iters=1, reps=3),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def k1_backward_check(shape, gen):
    """K1's forward kernel plus its recomputed backward against autograd of
    the plain chain, one upstream gradient for both."""
    import torch
    import torch.nn.functional as F

    from facegantts_tpu_torch.ops.gn_mish import gn_mish_mask, gn_mish_mask_ref

    b, c, f, t = shape
    x = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
    scale = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1
    bias = torch.randn(c, generator=gen, device="cuda")
    lens = torch.tensor([(t - 3, t, t // 2, 1)[i % 4] for i in range(b)], dtype=torch.int32,
                        device="cuda")
    w = torch.randn(shape, generator=gen, device="cuda")
    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None]).float()[:, None, None, :]

    def run(fn):
        args = [v.detach().requires_grad_() for v in (x, scale, bias)]
        y = fn(*args, lens)
        y.backward(w)
        return [y.detach()] + [v.grad for v in args]

    def library(*args):
        return F.mish(F.group_norm(args[0], 8, args[1], args[2], 1e-5)) * mask

    got, want = run(gn_mish_mask), run(gn_mish_mask_ref)
    torch.cuda.synchronize()
    err_y = (got[0] - want[0]).abs().max().item()
    err_g = max((g - v).abs().max().item() / max(1.0, v.abs().max().item())
                for g, v in zip(got[1:], want[1:]))
    if not (err_y <= 1e-4 and err_g <= 1e-4):
        raise AssertionError(f"[K1 bwd] {shape}: forward err {err_y:.3e}, gradient err "
                             f"{err_g:.3e} (bar 1e-4)")
    n = b * c * f * t
    # forward: x in, y out; backward: x and the gradient in, dx out
    bound_ms, bound_by = bound(5 * n * 4, n_ops=3 * n * K1_OPS_PER_ELEM)
    return {
        "err": err_y, "grad_err": err_g,
        "ms": time_ms(lambda: run(gn_mish_mask), iters=5, reps=3),
        "plain_ms": time_ms(lambda: run(gn_mish_mask_ref), iters=5, reps=3),
        "library_ms": time_ms(lambda: run(library), iters=5, reps=3),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def k2_check(shape, gen):
    """K2 (per-channel sum and sum of squares) against its plain version,
    and the GroupNorm built on it against the plain two-pass GroupNorm."""
    import torch

    from facegantts_tpu_torch.ops import groupnorm as gnorm

    b, c, f, t = shape
    x = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
    scale = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1
    bias = torch.randn(c, generator=gen, device="cuda")
    got, want = gnorm.channel_sums(x), gnorm.channel_sums_ref(x)
    y, y_ref = gnorm.group_norm(x, scale, bias, 8, 1e-5), gnorm.group_norm_ref(x, scale, bias, 8, 1e-5)
    torch.cuda.synchronize()
    # f32 sums of F*T values in another order: relative 1e-5 of the sum
    err = ((got - want).abs() / (want.abs() + 1.0)).max().item()
    err_y = (y - y_ref).abs().max().item()
    if not (err <= 1e-5 and err_y <= 1e-4):
        raise AssertionError(f"[K2] {shape}: sums rel err {err:.3e}, GroupNorm err {err_y:.3e}")
    bound_ms, bound_by = bound(b * c * f * t * 4 + b * 2 * c * 4, n_ops=3 * b * c * f * t)
    return {
        "err": (got - want).abs().max().item(), "rel_err": err, "gn_err": err_y,
        "ms": time_ms(lambda: gnorm.channel_sums(x), iters=20, reps=5),
        "plain_ms": time_ms(lambda: gnorm.channel_sums_ref(x), iters=20, reps=5),
        "library_ms": time_ms(lambda: torch.var_mean(x, dim=(2, 3), correction=0),
                              iters=20, reps=5),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def probe_checks(gen):
    """P1 and P2 against their plain versions at the probe shapes."""
    import torch

    from facegantts_tpu_torch import probe

    x = torch.randn(probe.P1_SHAPE, generator=gen, device="cuda")
    v = torch.randn(probe.P2_SHAPE, generator=gen, device="cuda")
    one = torch.ones((), device="cuda")
    out = {}
    # the plain P2 is a Python loop of 256 steps: fewer calls to time it
    for name, fn, ref, arg, plain_iters in (
            (probe.P1_NAME, probe.probe_trivial, probe.probe_trivial_ref, x, 50),
            (probe.P2_NAME, probe.probe_dp_loop, probe.probe_dp_loop_ref, v, 5)):
        got, want = fn(arg), ref(arg)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[probe] {name}: kernel and plain version differ")
        out[name] = {"err": 0.0, "ms": time_ms(lambda: fn(arg)),
                     "plain_ms": time_ms(lambda: ref(arg), iters=plain_iters)}
    n1 = x.numel()
    out[probe.P1_NAME]["bound_ms"], out[probe.P1_NAME]["bound_by"] = bound(8 * n1, n_ops=2 * n1)
    out[probe.P1_NAME]["library_ms"] = time_ms(lambda: torch.add(one, x, alpha=2.0))
    t_y = v.shape[0]
    out[probe.P2_NAME]["bound_ms"], out[probe.P2_NAME]["bound_by"] = bound(
        8 * v.numel(), n_ops=2 * v.numel(), chain_s=t_y * DEP_STEP_CYCLES / SM_CLOCK_HZ)
    out[probe.P2_NAME]["library_ms"] = None
    return out


def fmt_us(v):
    return "not measured" if v is None else f"{v:.1f} us"


def main() -> int:
    try:
        import torch

        from facegantts_tpu_torch.config import default_config
        from facegantts_tpu_torch.models import unet as unet_mod
        from facegantts_tpu_torch.models.facetts import FaceTTS
        from facegantts_tpu_torch.ops import gn_mish, kernels
        from facegantts_tpu_torch.synthesis import Synthesizer, load_face, pick_bucket
        from facegantts_tpu_torch.text.cmudict import default_cmudict
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only", file=sys.stderr)
        return 1

    # ---- 1. set-up ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[setup] {smi}")
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"[setup] device {name} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = kernels.build()
    log(f"[setup] built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for k, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[setup] {k} ptxas: {line.strip()}")

    # ---- 2. the main path at full width -------------------------------------
    face = load_face(os.path.join(ROOT, "test", "face.png"))
    with open(os.path.join(ROOT, "test", "text.txt")) as f:
        texts = [ln.strip() for ln in f if ln.strip()]
    requests = [texts[0], texts[1], texts[0], texts[1]]
    cmu = default_cmudict()
    seen = collections.Counter()  # (shape, dtype) of every K1 call on the path
    orig = unet_mod.gn_mish_mask

    def recording(x, *a, **k):
        seen[(tuple(x.shape), x.dtype)] += 1
        return orig(x, *a, **k)

    path_launches = collections.Counter()
    latency = {}  # (precision, request index) -> ms
    synths = {}
    unet_mod.gn_mish_mask = recording
    try:
        for bf16 in (1, 0):
            cfg = default_config(env={}, overrides=dict(
                fused_gn_mish=1, use_bf16=bf16, timesteps=10, temperature=8.0))
            synth = Synthesizer(cfg, cmudict=cmu, seed=0, device="cuda")
            synths[bf16] = synth
            tag = "bf16" if bf16 else "f32"
            for i, text in enumerate(requests):
                kernels.LAUNCHES.clear()
                t1 = time.perf_counter()
                wav, mel = synth.synthesize(text, face)
                ms = (time.perf_counter() - t1) * 1e3
                got = dict(kernels.LAUNCHES)
                path_launches.update(got)
                latency[(tag, i)] = ms
                n_frames = mel.shape[1]
                if not (np.isfinite(wav).all() and np.isfinite(mel).all()):
                    raise AssertionError(f"[path {tag}] request {i}: non-finite output")
                if len(wav) != n_frames * cfg.hop_len:
                    raise AssertionError(f"[path {tag}] request {i}: {len(wav)} samples "
                                         f"for {n_frames} frames")
                want = K1_PER_EVAL * cfg.timesteps
                if got.get(gn_mish.NAME, 0) != want:
                    raise AssertionError(f"[path {tag}] request {i}: K1 launched "
                                         f"{got.get(gn_mish.NAME, 0)} times, want {want}")
                log(f"[path {tag}] request {i}: {ms:.1f} ms, {n_frames} frames "
                    f"(bucket {pick_bucket(n_frames, cfg.mel_buckets)}), "
                    f"{len(wav) / cfg.sample_rate:.2f} s audio, launches {got}")
            kernels.LAUNCHES.clear()
            t1 = time.perf_counter()
            wavs = synth.synthesize_batch(texts + texts[:1], face)
            ms = (time.perf_counter() - t1) * 1e3
            got = dict(kernels.LAUNCHES)
            path_launches.update(got)
            n = got.get(gn_mish.NAME, 0)
            if n == 0 or n % (K1_PER_EVAL * cfg.timesteps) or n > K1_PER_EVAL * cfg.timesteps * len(wavs):
                raise AssertionError(f"[path {tag}] batch: K1 launched {n} times")
            for w in wavs:
                if not (np.isfinite(w).all() and len(w) % cfg.hop_len == 0 and len(w)):
                    raise AssertionError(f"[path {tag}] batch: bad waveform")
            log(f"[path {tag}] batch of {len(wavs)}: {ms:.1f} ms, "
                f"{n // (K1_PER_EVAL * cfg.timesteps)} decode group(s), launches {got}")
    finally:
        unet_mod.gn_mish_mask = orig
    for name_, count in sorted(path_launches.items()):
        log(f"[path] {name_}: {count} launches")
    if sum(seen.values()) != path_launches[gn_mish.NAME]:
        raise AssertionError("K1 calls on the path and kernel launches disagree")
    for kernel in PATH_KERNELS:
        if not path_launches[kernel]:
            raise AssertionError(f"kernel {kernel} never launched on the main path")

    # ---- 3. kernels against their plain versions -----------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    eval_shapes = {s for s, _ in K1_EVAL_436}
    shapes = set(eval_shapes)
    shapes |= {(4, *s[1:]) for s, _ in K1_EVAL_436}
    shapes |= {s for s, _ in seen}
    results = {}
    with strict_f32():
        for dtype in (torch.float32, torch.bfloat16):
            for shape in sorted(shapes):
                r = k1_check(shape, dtype, gen, profile_device=shape in eval_shapes)
                results[(shape, dtype)] = r
                dev = ""
                if "dev_us" in r:
                    dev = (f" | device only: kernel {fmt_us(r['dev_us'])} plain "
                           f"{fmt_us(r['plain_dev_us'])} library {fmt_us(r['library_dev_us'])}")
                log(f"[K1] {tuple(shape)} {str(dtype)[6:]}: max_abs_err {r['err']:.3e} "
                    f"kernel {r['ms'] * 1e3:.1f} us plain {r['plain_ms'] * 1e3:.1f} us "
                    f"library {r['library_ms'] * 1e3:.1f} us bound {r['bound_ms'] * 1e3:.2f} us{dev}")
    per_eval = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = {k: sum(results[(s, dtype)][k] * n for s, n in K1_EVAL_436)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        per_eval[dtype] = tot
        dev = {}
        for k in ("dev_us", "plain_dev_us", "library_dev_us"):
            vals = [(results[(s, dtype)][k], n) for s, n in K1_EVAL_436]
            dev[k] = None if any(v is None for v, _ in vals) else sum(v * n for v, n in vals)
        log(f"[K1] one U-Net eval at Ty=436, B=1, {str(dtype)[6:]} ({K1_PER_EVAL} launches): "
            f"kernel {tot['ms'] * 1e3:.1f} us plain {tot['plain_ms'] * 1e3:.1f} us "
            f"library {tot['library_ms'] * 1e3:.1f} us bound {tot['bound_ms'] * 1e3:.1f} us | "
            f"device only: kernel {fmt_us(dev['dev_us'])} plain {fmt_us(dev['plain_dev_us'])} "
            f"library {fmt_us(dev['library_dev_us'])}")

    # ---- 4. kernel vs plain chain through the whole decoder -----------------
    synth = synths[0]
    cfg = synth.cfg
    plain = FaceTTS.from_config(cfg.replace(fused_gn_mish=0)).eval().cuda()
    plain.load_state_dict(synth.model.state_dict())
    ids = synth.encode_text(texts[0])
    x = torch.as_tensor(ids[None], dtype=torch.long, device="cuda")
    x_len = torch.tensor([len(ids)], device="cuda")
    face_t = synth.prepare_face(face)
    with strict_f32(), torch.inference_mode():
        enc = synth.model.encode(x, x_len, face_t, cfg.length_scale)
        ty = pick_bucket(int(math.ceil(float(enc[3][0]))), cfg.mel_buckets)
        noise = torch.randn((1, cfg.n_feats, ty), generator=torch.Generator().manual_seed(1))
        mels = []
        for model in (synth.model, plain):
            _, mel, _, y_len = model.decode(*enc, cfg.timesteps, ty, 8.0, noise=noise)
            mels.append(mel[0, :, : int(y_len[0])].float())
    if not all(torch.isfinite(m).all() for m in mels):
        raise AssertionError("[decoder] non-finite mel")
    d = (mels[0] - mels[1]).abs()
    scale = max(1.0, mels[1].abs().max().item())
    # f32 sums in another order inside GroupNorm, carried through 10 steps:
    # the bar of the published-width JAX/torch parity test
    tol_max, tol_mean = 3e-5 * scale + 2e-3, 3e-6 * scale + 2e-4
    log(f"[decoder] kernel vs plain chain, f32, Ty={ty}: max {d.max().item():.3e} "
        f"(bar {tol_max:.2e}) mean {d.mean().item():.3e} (bar {tol_mean:.2e}) |mel| <= {scale:.1f}")
    if not (d.max().item() < tol_max and d.mean().item() < tol_mean):
        raise AssertionError("[decoder] kernel and plain chain disagree")

    # ---- 5. where one request's time goes (bf16, duration cache warm) ---------
    synth = synths[1]
    for _ in range(3):  # the profiler now and then returns no device events
        per, wall = device_profile(lambda: synth.synthesize(texts[0], face), n=3)
        busy = sum(per.values())
        if busy:
            break
    if busy == 0:
        log("[profile] the profiler saw no device time: not measured")
    else:
        k1 = sum(v for k, v in per.items() if "gn_stats_kernel" in k or "gn_apply_kernel" in k)
        plain_wall = latency[("bf16", 2)] * 1e3  # same request, unprofiled
        log(f"[profile] bf16 request (text 0, cached): device busy {busy / 1e3:.1f} ms of "
            f"{plain_wall / 1e3:.1f} ms unprofiled wall ({100 * busy / plain_wall:.1f}% busy, "
            f"{100 - 100 * busy / plain_wall:.1f}% idle; {wall / 1e3:.1f} ms under the profiler); "
            f"K1 {k1 / 1e3:.2f} ms ({100 * k1 / busy:.1f}% of device time)")
        for k, v in per.most_common(10):
            log(f"[profile]   {v / 1e3:8.3f} ms  {k[:110]}")

    # ---- 6. the training path at full width ----------------------------------
    tr = train_phase(os.path.join(ROOT, "runs", "chip_smoke_train"))
    cfg_t = tr["cfg"]
    for r, ms in zip(tr["steps"], tr["step_ms"]):
        log(f"[train] step {r['step']}: {ms:.1f} ms " + " ".join(
            f"{k[6:]}={v:.4f}" for k, v in r.items() if k.startswith("train/")
            and k != "train/steps_per_sec"))
    for r in tr["vals"]:
        log(f"[train] val after step {r['step']}: " + " ".join(
            f"{k[4:]}={v:.4f}" for k, v in r.items() if k.startswith("val/")))
    warm = statistics.median(tr["step_ms"][1:])
    log(f"[train] batch {cfg_t.per_gpu_batchsize} (batch_size {cfg_t.batch_size} over "
        f"num_gpus {cfg_t.num_gpus}), crop {cfg_t.out_size} frames, f32 with TF32 at "
        f"PyTorch's defaults (cudnn {torch.backends.cudnn.allow_tf32}, matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}); (text, mel) buckets of the steps "
        f"{tr['buckets']}")
    log(f"[train] first step {tr['step_ms'][0]:.1f} ms, warm step {warm:.1f} ms (median of "
        f"steps 2-{TRAIN_STEPS}); peak memory {tr['peak_bytes'] / 2**30:.2f} GiB; "
        f"{tr['forwards']} loss evaluations in {tr['wall_s']:.1f} s; launches {tr['launches']}")
    for kernel in TRAIN_PATH_KERNELS:
        if not tr["launches"].get(kernel):
            raise AssertionError(f"kernel {kernel} never launched on the training path")
    per, wall, shape = train_profile(cfg_t, tr["state"])
    busy = sum(per.values())
    if busy == 0:
        log("[train profile] the profiler saw no device time: not measured")
    else:
        k1 = sum(v for k, v in per.items() if "gn_stats_kernel" in k or "gn_apply_kernel" in k)
        mas_us = sum(v for k, v in per.items() if "mas_kernel" in k)
        log(f"[train profile] one warm step, (text, mel) bucket {shape}: device busy "
            f"{busy / 1e3:.1f} ms of {wall:.1f} ms unprofiled wall ({100 * busy / 1e3 / wall:.1f}% "
            f"busy); K1 forward {k1 / 1e3:.2f} ms, MAS {mas_us / 1e3:.3f} ms")
        for k, v in per.most_common(12):
            log(f"[train profile]   {v / 1e3:8.3f} ms  {k[:110]}")
    del tr["state"]

    # ---- 7. FusedGroupNorm (K2's only consumer) and the probe (P1, P2) ---------
    from facegantts_tpu_torch import probe
    from facegantts_tpu_torch.models.unet import FusedGroupNorm
    from facegantts_tpu_torch.ops import groupnorm as gnorm
    from facegantts_tpu_torch.ops import mas as mas_mod

    gen = torch.Generator(device="cuda").manual_seed(1)
    kernels.LAUNCHES.clear()
    for shape, _ in K1_TRAIN:
        norm = FusedGroupNorm(shape[1]).cuda()
        x = torch.randn(shape, generator=gen, device="cuda", requires_grad=True)
        norm(x).square().mean().backward()
        if not torch.isfinite(x.grad).all():
            raise AssertionError(f"[FusedGroupNorm] {shape}: non-finite gradient")
    gn_launches = dict(kernels.LAUNCHES)
    kernels.LAUNCHES.clear()
    probe_ms = probe.run("cuda")
    probe_launches = dict(kernels.LAUNCHES)
    log(f"[FusedGroupNorm] forward + backward at the {len(K1_TRAIN)} training U-Net shapes: "
        f"launches {gn_launches}")
    log(f"[probe] python -m facegantts_tpu_torch.probe: P1 {probe_ms[probe.P1_NAME]:.3f} ms, "
        f"P2 {probe_ms[probe.P2_NAME]:.3f} ms (host clock, median of 10); launches "
        f"{probe_launches}")
    if gn_launches.get(gnorm.NAME) != len(K1_TRAIN):
        raise AssertionError(f"[FusedGroupNorm] K2 launched {gn_launches}")
    if not (probe_launches.get(probe.P1_NAME) and probe_launches.get(probe.P2_NAME)):
        raise AssertionError(f"[probe] launches {probe_launches}")

    # ---- 8. the new kernels against their plain versions ---------------------
    checks = {}
    # the first training step's own inputs, then ragged random ones at every
    # (text, mel) bucket the steps ran (T_x sets the threads per block) and
    # at the top buckets
    mas_cases = [("step 1's log-prior", tr.pop("mas_inputs"))]
    for shape in sorted({(cfg_t.per_gpu_batchsize, *k) for k in tr["buckets"]}) + MAS_SHAPES:
        mas_cases.append(("ragged random", mas_inputs(shape, gen)))
    with strict_f32():
        for label, (value, mask) in mas_cases:
            r = checks[("mas", label, tuple(value.shape))] = mas_check(value, mask)
            log(f"[MAS] {label} {tuple(value.shape)}: paths exactly equal; kernel "
                f"{r['ms'] * 1e3:.1f} us plain {r['plain_ms'] * 1e3:.1f} us bound "
                f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
        del mas_cases
        for shape, _ in K1_TRAIN:
            r = checks[("k1_bwd", shape)] = k1_backward_check(shape, gen)
            log(f"[K1 bwd] {shape} f32: forward max_abs_err {r['err']:.3e}, gradients "
                f"{r['grad_err']:.3e} of the largest (bar 1e-4); forward + backward: kernel "
                f"{r['ms'] * 1e3:.1f} us plain {r['plain_ms'] * 1e3:.1f} us library "
                f"{r['library_ms'] * 1e3:.1f} us bound {r['bound_ms'] * 1e3:.2f} us")
        for shape, _ in K1_TRAIN:
            r = checks[("k2", shape)] = k2_check(shape, gen)
            log(f"[K2] {shape} f32: sums max_abs_err {r['err']:.3e} (relative {r['rel_err']:.2e}, "
                f"bar 1e-5), GroupNorm {r['gn_err']:.3e} (bar 1e-4); kernel {r['ms'] * 1e3:.1f} us "
                f"plain {r['plain_ms'] * 1e3:.1f} us library {r['library_ms'] * 1e3:.1f} us "
                f"bound {r['bound_ms'] * 1e3:.2f} us")
        probes = probe_checks(gen)
        for k, r in probes.items():
            lib = "—" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.1f} us"
            log(f"[probe] {k}: exactly equal; kernel {r['ms'] * 1e3:.1f} us plain "
                f"{r['plain_ms'] * 1e3:.1f} us library {lib} bound {r['bound_ms'] * 1e3:.3f} us "
                f"({r['bound_by']})")
    bwd = {k: sum(checks[("k1_bwd", s)][k] * n for s, n in K1_TRAIN)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"[K1 bwd] one training U-Net evaluation ({K1_PER_EVAL} launches, B=64, 128 frames), "
        f"forward + backward: kernel {bwd['ms']:.3f} ms plain {bwd['plain_ms']:.3f} ms "
        f"library {bwd['library_ms']:.3f} ms bound {bwd['bound_ms']:.3f} ms")

    # ---- lines -----------------------------------------------------------------
    f32 = per_eval[torch.float32]
    k1_err = max(r["err"] for (s, dt), r in results.items() if dt == torch.float32)
    mas_big = checks[("mas", "ragged random", MAS_SHAPES[-1])]
    k2 = {k: sum(checks[("k2", s)][k] for s, _ in K1_TRAIN)
          for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"[lines] kernels line: {gn_mish.NAME} times are one U-Net evaluation's {K1_PER_EVAL} "
        f"K1 launches at Ty=436, B=1, f32 (per-shape lines above), max_abs_err over every f32 "
        f"shape, launches on the inference ({path_launches[gn_mish.NAME]}) and training "
        f"({tr['launches'][gn_mish.NAME]}) paths; {mas_mod.NAME} at {MAS_SHAPES[-1]}, "
        f"launches on the training path; {gnorm.NAME} summed over the {len(K1_TRAIN)} "
        f"training U-Net shapes, launches in the FusedGroupNorm run; probes at their shapes, "
        f"launches in the probe run")

    def entry(name, source, replaces, launches, r, err):
        return {"name": name, "route": "cuda", "source": f"facegantts_tpu_torch/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    k1_by = collections.Counter(r["bound_by"] for r in results.values()).most_common(1)[0][0]
    log(smi)
    log(json.dumps({"kernels": [
        entry(gn_mish.NAME, "csrc/gn_mish.cu", "facegantts_tpu/ops/gn_mish.py:119",
              path_launches[gn_mish.NAME] + tr["launches"][gn_mish.NAME],
              dict(f32, bound_by=k1_by), k1_err),
        entry(mas_mod.NAME, "csrc/mas.cu", "facegantts_tpu/ops/mas.py:38",
              tr["launches"][mas_mod.NAME], mas_big, 0.0),
        entry(gnorm.NAME, "csrc/groupnorm.cu", "facegantts_tpu/ops/groupnorm.py:72",
              gn_launches[gnorm.NAME], dict(k2, bound_by=collections.Counter(
                  checks[("k2", s)]["bound_by"] for s, _ in K1_TRAIN).most_common(1)[0][0]),
              max(checks[("k2", s)]["err"] for s, _ in K1_TRAIN)),
        entry(probe.P1_NAME, "csrc/probe.cu", "scripts/pallas_probe.py:16",
              probe_launches[probe.P1_NAME], probes[probe.P1_NAME], 0.0),
        entry(probe.P2_NAME, "csrc/probe.cu", "scripts/pallas_probe.py:36",
              probe_launches[probe.P2_NAME], probes[probe.P2_NAME], 0.0),
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
