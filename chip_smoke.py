#!/usr/bin/env python3
"""Drive the PyTorch port (facegantts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--old-k1=DIR] [--old-step=FILE]

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
3. ``fused_gn_mish`` 0 against 1 in turns (0, 1, 1, 0): warm bf16 request
   latency, and training step time and peak memory over 3 steps a turn,
   run next to phase 2's requests, before the profiled phases.
4. K1's forward kernel against its plain torch version on the card, at the
   shapes the main path gave it plus the Ty=436 bucket's shapes at batch 1
   and 4 and the Ty=872 bucket's at batch 1 (whose full-resolution slab
   streams through shared memory in f32), in f32 (max abs error <= 1e-4)
   and bf16 (<= 0.05), TF32 off, with the launch plan of each shape; median
   times of the kernel, the plain version and a library yardstick, and the
   bound (bytes over 3.35 TB/s vs operations over 67 TFLOP/s, H100 SXM).
5. one f32 utterance decoded with the kernel (``fused_gn_mish=1``) and with
   plain torch ops (``fused_gn_mish=0``), same weights, same injected noise,
   TF32 off: the mel difference is bounded.
6. where one bf16 request's device time goes (``torch.profiler``), and that
   each K1 call is one device kernel, ``gn_mish_fwd_kernel``.
7. the training path: ``train/loop.train`` with the plain FaceTTS step
   (``use_gan=0``) at the Config defaults (published widths),
   ``fused_gn_mish=1``, f32 with PyTorch's TF32 defaults, on
   ``SyntheticDataset`` (seed 0) at batch 64 (the reference recipe's 256
   over 4 GPUs), 5 steps and the validation pass.  Every loss and
   ``grad_norm`` is finite, the encoder moved, the frozen SyncNet audio trunk
   is bit-identical, and with the counts zeroed just before: K1's forward
   launched 25 times and MAS once per loss evaluation, K1's backward 25
   times per training step (validation runs no backward).  Step times, peak
   memory, buckets, and a ``torch.profiler`` breakdown of one warm step.
8. the GAN path: ``train/loop.train`` at the Config defaults with
   ``use_gan=1`` (published widths, hinge loss, R1 gamma 15 on every step,
   batch 64 in micro-batches of 16, the fake sampler in bf16 at AUTO-4
   steps, the G phase over the whole mel bucket), ``fused_gn_mish=1``, on
   ``SyntheticDataset`` (seed 0), 4 steps and the GAN validation; every
   metric finite, R1 applied, no micro-batch skipped, SyncNet unchanged,
   the discriminator, encoder and decoder moved, and with the counts zeroed
   just before: per step 500 K1 forwards (none in bf16: the bf16 sampler
   runs the U-Net in f32 with bf16 weights, as the JAX package's does), 100
   K1 backwards and 4 MAS launches, per validation batch 125 K1 forwards
   and one MAS.  Then 6 steps on one batch with R1 on and off in turns
   (each step's launches asserted alone), step times and peak memory, a
   ``torch.profiler`` breakdown of one warm R1 step, with ``--old-step=FILE``
   (an earlier ``train/step.py``, e.g. ``git show
   <rev>:facegantts_tpu_torch/train/step.py`` into a git-ignored file) that
   step's no-grad sampler against this one on one micro-batch in turns
   (card time; device time by part and K1's calls by dtype, profiled), and
   K1 (f32 forward at the five B=16 Ty=436 U-Net shapes, the sampler's;
   f32 forward and backward through the
   autograd Function at those and at (16, 64, 128, 872), with the device
   time alone of the backward and of the forward + backward pair through
   ``backward()`` beside the library pair's) and MAS (the step's own
   log-prior, (16, 256, 436), (16, 256, 872)) against their plain versions.
9. K2's only consumer (``FusedGroupNorm``, forward and backward at the five
   training U-Net shapes) and the probe entry point (P1, P2), each with its
   counts zeroed just before.
10. MAS (exactly equal paths: on the first training step's own log-prior
   and mask, at B=64 and every (text, mel) bucket the steps ran, and at the
   top buckets T_x 256, T_y 656 and 872), K1's forward and backward kernels
   at the five training shapes (against autograd of the plain chain and the
   backward kernel against ``gn_mish_mask_bwd_ref``, 1e-4 of the largest),
   K2 (sums to 1e-5 relative, GroupNorm to 1e-4) and P1, P2 (exactly equal)
   against their plain versions, with times, bounds and library times; for
   MAS, P1, P2 and K1's backward also the device time alone
   (``torch.profiler``), for P2 its cycles a column, and for P1 the card
   time timed in turns with ``torch.add``'s and the host time of a call
   beside ``torch.add``'s.  K1's backward also where its units and channels
   fall unevenly (T of 1, 3, 32, 109; lengths 0, 1, T; views at an odd
   offset; the streaming (1, 64, 128, 872) slab) in f32 and bf16, and P2
   exactly at T_x 1 to 1024, T_y 1 to 256, B 1 and 8 and with a NaN.
11. with ``--old-k1=DIR`` (an earlier ``gn_mish.py`` and ``gn_mish.cu``,
   e.g. ``git show <rev>:facegantts_tpu_torch/ops/gn_mish.py`` and
   ``.../csrc/gn_mish.cu`` into a git-ignored directory; built beside the
   port's kernels): its backward and this one at the 11 backward shapes of
   the GAN and plain steps, card times in turns and device times alone,
   and the sums per U-Net evaluation.
12. persistence and serving, from the GAN ``TrainState`` that phase 8
   leaves (Config widths, batch 64): ``CheckpointPolicy`` saves it
   (``save_step``, then ``save_epoch`` with a val loss; ms and bytes) and it
   is restored into a fresh state (ms): model, discriminator, both
   optimizers' moments and counts and the step bitwise equal; one R1 step
   from each, same batch and draws, losses within 1e-5 relative, each 500
   K1 forwards (none in bf16), 100 backwards and 4 MAS launches; ``train``
   with ``resume_from=<work>/last`` two steps on (logged steps, ``last/``,
   launches, no K1 call in bf16); then in bf16 and f32 a Synthesizer from
   ``restore_generator_state_dict`` and a bshall vocoder file with weight
   norm (``load_hifigan_state_dict``) against ``update_params`` on a random
   one (the same waveform), 250 K1 launches a request, warm latency;
   ``stream_vocode`` of 256- and 872-frame mels against one vocoder call
   (equal in f32, within 0.05 in bf16), time to first audio and to the whole
   waveform; the HTTP server on 127.0.0.1 (``/health`` says gpu,
   ``/synthesize`` equals the direct call, ``/synthesize_stream`` within 1
   LSB (f32) or 0.05 (bf16) of it away from the last margin, latency over
   HTTP against the direct call in turns).  bf16 runs PyTorch's defaults;
   f32 runs with TF32 off and cuDNN's deterministic algorithms, the setting
   in which an f32 result does not depend on the algorithm cuDNN picks for
   a shape (with the default TF32 convolutions the f32 chunks' difference
   from one call is printed too).  The checks of the phase are collected
   and it fails at its end if any did.
13. the training options, each through ``train/loop.train`` at the Config
   widths on ``SyntheticDataset`` (seed 0), batch 64, ``fused_gn_mish=1``,
   for OPT_STEPS steps and one validation batch, with every metric finite,
   masters and optimizer state f32, and the launches asserted, counts
   zeroed just before and read just after (K1's forwards and backwards by
   dtype, MAS; ``option_counts`` derives them from the code):
   ``train_bf16`` in the plain step (then against f32 in turns on one
   batch: step ms, peak memory); ``disc_bf16`` in the GAN step (then 0 and
   1 in turns with R1 on and off: step ms, peak memory, ``d_loss`` and
   ``r1_penalty``; the D phase's ms a micro-batch; a ``torch.profiler``
   breakdown of one warm ``disc_bf16=1`` R1 step with its sm80-generation
   kernels counted); ``train_bf16`` in the GAN step;
   ``adv_grad_through_sampler`` in micro-batches of 8 (at the Config's 16
   the step does not fit the card's memory; step ms, peak memory, the gate
   on ``g_loss``);
   ``grad_remat`` (then 0 and 1 in turns: step ms, peak
   memory).  Then K1's bf16 backward kernel at the five plain-crop and the
   five B=16 Ty=436 shapes against ``gn_mish_mask_bwd_ref`` (the bars of
   ``k1_bwd_case``), with card and device times, the plain version's and
   the bound.
14. the data and evaluation path: a small LRS2-shaped corpus written under
   ``runs/chip_smoke_corpus`` (train 64, val 8 and test 8 clips over 8
   speakers, 1.2-5.6 s of voiced harmonic segments at F0 90-250 Hz with
   noise and pauses, a ``Text:`` line and the ``test/`` face as jpg each),
   packed by ``data.preprocess.main`` with the mel op on the card (every
   clip's mel held to the formula in float64 with TF32 off; ms a clip by
   part); ``train/loop.train`` on the shards at the Config widths with
   ``use_gan=0``, batch 16, two steps and the in-training evaluation at the
   second (the Config's four items, WORLD F0, bf16 synthesis): its rows in
   ``metrics.jsonl`` finite, ``eval_output.txt`` with its provenance and
   keys, the four samples written, and with the counts zeroed just before
   the evaluation 250 bf16 K1 forwards an item and no MAS; its time by
   part; then the ``evaluate`` CLI over those samples against the corpus
   wavs of the val clips and the ``acc_measure`` CLI on the test split
   (n_way 5, 100 trials).
15. the UTMOS-strong SSL MOS model (``evaluation/ssl_mos.py``) at the
   wav2vec2 BASE widths, random weights from seed 15, under
   ``runs/chip_smoke_mos``: (a) written as a HuggingFace-named file
   (positional conv in ``parametrizations``) and a fairseq-named one
   (``weight_g`` / ``weight_v``), each loaded by ``make_mos_predictor`` into
   the port's ``SSLMOSPredictor`` on the card, both giving one MOS; (b) the
   card against the port on the CPU in strict f32 at 1, 4 and 10 s of
   harmonic audio (MOS within 1e-5, features within 1e-4), the MOS shift
   under PyTorch's TF32 defaults and with every norm at torch's 1e-5; (c)
   warm ms a call, device time and launches by part, peak memory, the
   bound; (d) the ``evaluate`` CLI over phase 14's samples with
   ``mos_ckpt=`` the HF file and YIN F0 (its report names ``utmos-ssl``); (e)
   ``mos_statistics`` and ``pairwise_wilcoxon`` on the SSL MOS of phase 14's
   synthesized and copy-synthesized items, every plot written where
   matplotlib imports (each raising an ``ImportError`` that names it where
   it does not); (f) the HF file pinned in a pins file of the work
   directory and loaded by ``weights.load_verified``, a copy with one byte
   altered refused; (g) ``python -m facegantts_tpu_torch.hyperopt`` over two
   learning rates on phase 14's corpus (``use_gan=0``, batch 16, 2 steps,
   the evaluation of 1 item at step 2 scored by the HF file), each trial a
   trainer process on the card with a finite composite, ``results.json``
   sorted, each trial's kernel launches read from its last line.
16. the tooling slice, at the Config widths, under ``runs/chip_smoke_tooling``:
   (a) the (text, mel) bucket pair the first test sentence lands in
   (random weights, seed 0, temperature 8): in bf16 exported by
   ``export.export_bundle`` in the process; in f32 written as a
   reference-named file, migrated by ``python -m
   facegantts_tpu_torch.migrate_checkpoint`` (``use_gan=0``; also
   ``mode=fix-lightning``) and exported by ``python -m
   facegantts_tpu_torch.export`` from the migrated directory; each loaded by
   ``load_bundle`` and held to ``Synthesizer.synthesize`` with the same seed
   (wav within 1e-5, mel within 5e-4; bitwise equality printed), 250 K1
   launches a loaded call, export and load seconds, a loaded call against a
   live one in turns; then K1 on the live bf16 path called directly and
   through its registered op ``facegantts::gn_mish_mask`` in turns, and the
   host time of one K1 call each way; (b) ``python -m
   facegantts_tpu_torch.bench`` (``BENCH_TRAIN=1``): its four metric lines
   finite and positive, ``inference_rtf`` last,
   ``0 < mfu_parity < 1``, its launches read from its last stderr line; (c)
   ``train()`` (``use_gan=0``, batch 64) with a ``profile_dir`` and a
   two-step window: one trace file naming K1's forward and backward
   kernels, MAS's and the loop's ``train_step`` span; (d) ``python -m
   facegantts_tpu_torch.utils.flops`` (run beside (a)'s bf16 export, as the
   f32 CLIs are; nothing is timed while they run): the parts at the bench's
   shape, one real step counting the composed step less the two
   discriminator forwards on the fake that it reuses.

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
# the same at the top mel bucket, Ty=872: the full-resolution slab is 3.57 MB
# in f32, more than a cluster's shared memory, so the forward streams
K1_EVAL_872 = [((1, 64, 128, 872), 5), ((1, 128, 64, 436), 4), ((1, 64, 64, 436), 4),
               ((1, 256, 32, 218), 8), ((1, 128, 32, 218), 4)]
K1_OPS_PER_ELEM = 13  # stats 3 + normalise 2 + mish 7 (exp counted once) + mask 1
# backward: normalise 2 + affine 2 + mish' 10 (exp once) + dz 1 + sums 3 + dx 3
K1_BWD_OPS_PER_ELEM = 21
K1_FWD_KERNEL, K1_BWD_KERNEL = "gn_mish_fwd_kernel", "gn_mish_bwd_kernel"  # csrc names
MAS_KERNEL, P1_KERNEL = "mas_kernel", "affine_kernel"  # csrc names (profiler keys hold them)
P2_KERNEL = "dp_loop_kernel"
PATH_KERNELS = ("gn_mish_mask",)  # wrapper names (kernels.LAUNCHES keys) on the path
TRAIN_PATH_KERNELS = ("gn_mish_mask", "gn_mish_mask_bwd", "maximum_path")
AB_ORDER = (0, 1, 1, 0)  # fused_gn_mish in turns
AB_REQUESTS, AB_STEPS = 3, 3  # per turn: warm bf16 requests, training steps
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
# the GAN step at the Config defaults (use_gan=1, hinge, R1 gamma 15, micro-batch
# 16, bf16 sampler at AUTO-4 steps, full-length G phase) on the same batch
GAN_STEPS = 4
GAN_OVERRIDES = dict(TRAIN_OVERRIDES, use_gan=1)
GAN_PATH_KERNELS = ("gn_mish_mask", "gn_mish_mask_bwd", "maximum_path")
GAN_TURNS = (1, 0, 0, 1, 1, 0)  # use_r1 of the extra steps, in turns, on one batch
# K1 shapes of one U-Net evaluation in a GAN micro-batch (B=16) at the 436 and
# 872 buckets (the G phase sees the whole bucket), launch counts as K1_EVAL_436
K1_GAN_436 = [((16, *s[1:]), n) for s, n in K1_EVAL_436]
K1_GAN_872 = [((16, *s[1:]), n) for s, n in K1_EVAL_872]
MAS_GAN_SHAPES = [(16, 256, 436), (16, 256, 872)]
# the K1 backward's shapes: a GAN eval's (B=16, 436), the streaming 872 slab,
# a plain step's eval (B=64, 128 frames), with launches per eval (0: none)
K1_BWD_SHAPES = K1_GAN_436 + [(K1_GAN_872[0][0], 0)] + K1_TRAIN
# phase 13: steps of each option's loop run, and the option off / on in turns
OPT_STEPS = 2
OPT_TURNS = (0, 1, 1, 0)
# the plain step (~0.3 s) is host-bound, so its steps vary more: ten pairs
PLAIN_TURNS = OPT_TURNS * 5
# adv_grad_through_sampler keeps the activations of T=10 U-Net evaluations
# of a micro-batch for its backward: at the Config's 16 the step runs out of
# the card's 80 GB (torch.OutOfMemoryError with 76.84 GiB allocated when a
# 218 MiB allocation failed, H100 80GB HBM3 at 700 W; PERF.md §6, phase 13's
# table); 8, the largest divisor of the batch of 64 that fits, is used
ADV_MICRO = 8
P2_SHAPES = [(t_y, b, t_x) for t_x in (1, 31, 33, 100, 128, 1024) for t_y in (1, 17, 256)
             for b in (1, 8)]


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=50, reps=7):
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after a warm-up call."""
    return time_ms_turns([fn], iters, reps)[0]


def time_ms_turns(fns, iters=50, reps=7):
    """``time_ms`` of each of ``fns``, their repetitions taken in turns (one
    of each, then again), so that all see the same host: medians, in order."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / iters)
    return [statistics.median(ts) for ts in times]


def device_profile(fn, n=1):
    """Run ``fn`` ``n`` times under torch.profiler; returns
    ({kernel name: device us per run}, wall us per run, {kernel name:
    launches per run}).  Empty when the profiler sees no device activity."""
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
    per, count = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0:
            per[e.key] += e.self_device_time_total / n
            count[e.key] += e.count / n
    return per, wall, count


def kernel_sum(table, name):
    """Sum of ``table``'s values over the kernels whose name holds ``name``."""
    return sum(v for k, v in table.items() if name in k)


def profiled_us(fn, name="", n=20):
    """Device time of one call of ``fn`` in the kernels whose name holds
    ``name`` (all: ""), from torch.profiler over ``n`` calls: each kernel's
    mean time a launch times its launches a call (rounded), so that an event
    the profiler drops or carries over does not move the result; None where
    it saw none ("not measured")."""
    for _ in range(3):  # the profiler now and then returns no device events
        per, _, count = device_profile(fn, n=n)
        us = sum(per[k] / count[k] * max(1, round(count[k])) for k in per
                 if name in k and count[k] > 0)
        if us:
            return us
    return None


def host_us(fn, n=2000):
    """Host time of one call of ``fn``: ``n`` back-to-back calls on the host
    clock, not waiting for the card (which keeps up when the host sets the
    pace), after a warm-up."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / n


class cudnn_mode:
    """cuDNN's TF32 and deterministic switches inside the block (matmuls
    without TF32, PyTorch's default)."""

    def __init__(self, tf32: bool, deterministic: bool):
        self.want = (tf32, deterministic)

    def __enter__(self):
        import torch

        b = torch.backends
        self.prev = b.cudnn.allow_tf32, b.cudnn.deterministic, b.cuda.matmul.allow_tf32
        b.cudnn.allow_tf32, b.cudnn.deterministic = self.want
        b.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        b = torch.backends
        b.cudnn.allow_tf32, b.cudnn.deterministic, b.cuda.matmul.allow_tf32 = self.prev


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
    moved = 2 * n * dtype_bytes + 2 * c * 4 + b * 4 + b * 8 * 8  # x, y, scale, bias, lens, stats
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
    lens = torch.tensor([(t - 3, t, t // 2, 1)[i % 4] for i in range(b)] if b > 1 else [t - 3],
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
            out[key] = profiled_us(fn)
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
    # validation runs no backward
    want = {gn_mish.NAME: K1_PER_EVAL * forwards * cfg.fused_gn_mish,
            gn_mish.BWD_NAME: K1_PER_EVAL * TRAIN_STEPS * cfg.fused_gn_mish, mas.NAME: forwards}
    for k, n in want.items():
        if launches.get(k, 0) != n:
            raise AssertionError(f"[train] {k} launched {launches.get(k, 0)} times, "
                                 f"want {n} ({forwards} loss evaluations, {TRAIN_STEPS} "
                                 f"backward passes)")
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
        per, _, count = device_profile(one, n=n)
        if per:
            break
    return per, wall, (batch.x.shape[1], batch.y.shape[2]), count


def disc_forward_flops(cfg, b, f, t):
    """Multiply-add operations (x2) of one discriminator forward on a
    (b, 1, f, t) input: ``conv_prev`` and the ladder ((kh, kw), padding
    (1, disc_padding), time stride on the ladder), then the two 3x3 convs."""
    kh, kw, c, pad = cfg.kernel_height, cfg.kernel_width, cfg.disc_base_channels, cfg.disc_padding
    flops, c_in = 0, 1
    for i in range(cfg.disc_num_layers + 1):
        stride = 1 if i == 0 else cfg.disc_stride
        f, t = f + 2 - kh + 1, (t + 2 * pad - kw) // stride + 1
        flops += 2 * b * c * c_in * kh * kw * f * t
        c_in = c
    return flops + 2 * b * (c + 1) * c * 9 * f * t


def check_gan_defaults(cfg):
    """The GAN phase runs the Config defaults of the GAN step."""
    want = dict(use_gan=1, disc_family="parity", use_spectral_norm=0, disc_loss_type="hinge",
                use_r1_penalty=1, r1_gamma=15.0, r1_interval=1, micro_batch_size=16,
                gan_sampler_bf16=1, disc_fake_timesteps=-1, gan_g_crop=0, disc_base_channels=64,
                disc_num_layers=5, kernel_height=12, kernel_width=5, disc_padding=6)
    bad = {k: getattr(cfg, k) for k, v in want.items() if getattr(cfg, k) != v}
    if bad or cfg.train_fake_timesteps != 4 or cfg.per_gpu_batchsize != 64:
        raise AssertionError(f"[GAN] not the Config defaults: {bad}")


def gan_phase(work_dir, old_step=None):
    """The GAN path: ``train/loop.train`` at the Config defaults with
    ``use_gan=1`` (published widths, batch 64 in 4 micro-batches of 16, R1 on
    every step) for GAN_STEPS steps and its GAN validation, then GAN_TURNS
    extra steps on one batch with R1 on and off in turns (each step's
    launches counted alone), then one warm R1 step under ``torch.profiler``.
    Returns what it measured; raises on a failed check."""
    import shutil

    import torch

    from facegantts_tpu_torch.config import default_config
    from facegantts_tpu_torch.data.dataset import BucketedLoader, SyntheticDataset
    from facegantts_tpu_torch.models import facetts as facetts_mod
    from facegantts_tpu_torch.models import unet as unet_mod
    from facegantts_tpu_torch.ops import gn_mish, kernels, mas
    from facegantts_tpu_torch.train.loop import train
    from facegantts_tpu_torch.train.step import (
        _micro_split,
        init_state,
        make_gan_loss_fns,
        make_gan_train_step,
    )

    cfg = default_config(env={}, overrides=GAN_OVERRIDES)
    check_gan_defaults(cfg)
    n_micro = cfg.per_gpu_batchsize // cfg.micro_batch_size
    fwd_step = n_micro * K1_PER_EVAL * (cfg.train_fake_timesteps + 1)
    bf16_step = 0  # the bf16 sampler's U-Net computes in f32 (train/precision.py)
    bwd_step, mas_step = n_micro * K1_PER_EVAL, n_micro
    train_ds = SyntheticDataset(n_items=1024, n_mels=cfg.n_mels, seed=0)
    val_ds = SyntheticDataset(n_items=512, n_mels=cfg.n_mels, seed=1)
    loader = BucketedLoader(train_ds, cfg, cfg.per_gpu_batchsize)
    buckets = [k for k, _ in loader._epoch_plan(0)[:GAN_STEPS]]
    init = init_state(cfg, "cpu")  # same seed, same weights
    init_g = {n: p.detach().clone() for n, p in init.model.named_parameters()}
    init_d = {n: p.detach().clone() for n, p in init.disc.named_parameters()}
    del init

    k1_dtypes = collections.Counter()  # dtype of every K1 call
    mas_seen = []  # the first G phase's (log-prior, mask), to check MAS on
    orig_k1, orig_mas = unet_mod.gn_mish_mask, facetts_mod.maximum_path

    def k1_recording(x, *a, **k):
        k1_dtypes[x.dtype] += 1
        return orig_k1(x, *a, **k)

    def mas_recording(value, mask):
        if not mas_seen:
            mas_seen.append((value.clone(), mask.clone()))
        return orig_mas(value, mask)

    shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    unet_mod.gn_mish_mask, facetts_mod.maximum_path = k1_recording, mas_recording
    try:
        kernels.LAUNCHES.clear()
        t0 = time.perf_counter()
        state = train(cfg, work_dir, GAN_STEPS, train_ds, val_ds, device="cuda")
        wall = time.perf_counter() - t0
        launches, dtypes = dict(kernels.LAUNCHES), dict(k1_dtypes)
    finally:
        unet_mod.gn_mish_mask, facetts_mod.maximum_path = orig_k1, orig_mas
    peak = torch.cuda.max_memory_allocated()

    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "train/g_loss" in r]
    vals = [r for r in recs if "val/total_loss" in r]
    if [r["step"] for r in steps] != list(range(1, GAN_STEPS + 1)):
        raise AssertionError(f"[GAN] logged steps {[r['step'] for r in steps]}")
    for r in steps + vals:
        bad = [k for k, v in r.items() if k != "step" and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"[GAN] non-finite {bad} at step {r['step']}")
    for r in steps:
        if not (r["train/r1_penalty"] > 0 and r["train/d_nan_skipped"] == 0
                and r["train/g_nan_skipped"] == 0 and 0 <= r["train/disc_acc"] <= 1):
            raise AssertionError(f"[GAN] step {r['step']}: {r}")
    if not vals:
        raise AssertionError("[GAN] the validation pass ran no batch")
    n_val = sum(int(r["val/batches"]) for r in vals)
    # a validation batch: the bf16 sampler (whole batch) and one f32 loss evaluation
    want = {gn_mish.NAME: GAN_STEPS * fwd_step + n_val * K1_PER_EVAL * (cfg.train_fake_timesteps + 1),
            gn_mish.BWD_NAME: GAN_STEPS * bwd_step, mas.NAME: GAN_STEPS * mas_step + n_val}
    want_bf16 = 0
    for k, n in want.items():
        if launches.get(k, 0) != n:
            raise AssertionError(f"[GAN] {k} launched {launches.get(k, 0)} times, want {n}")
    if dtypes.get(torch.bfloat16, 0) != want_bf16 or sum(dtypes.values()) != want[gn_mish.NAME]:
        raise AssertionError(f"[GAN] K1 calls by dtype {dtypes}, want {want_bf16} in bf16")
    final_g = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    final_d = {n: p.detach().cpu() for n, p in state.disc.named_parameters()}
    sync = [n for n in init_g if n.startswith("syncnet.")]
    if not sync or not all(torch.equal(final_g[n], init_g[n]) for n in sync):
        raise AssertionError("[GAN] a SyncNet parameter moved")
    if all(torch.equal(final_d[n], p) for n, p in init_d.items()):
        raise AssertionError("[GAN] no discriminator parameter moved")
    for part in ("encoder.", "decoder."):
        if all(torch.equal(final_g[n], p) for n, p in init_g.items() if n.startswith(part)):
            raise AssertionError(f"[GAN] no {part[:-1]} parameter moved")
    del final_g, final_d, init_g, init_d

    # R1 on and off in turns on one batch, each step's launches counted alone
    train_step, _ = make_gan_train_step(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = next(loader.epoch(0))
    turns = {1: [], 0: []}
    peaks = {1: [], 0: []}
    for use_r1 in GAN_TURNS:
        k1_dtypes.clear()
        unet_mod.gn_mish_mask = k1_recording
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.LAUNCHES.clear()
        try:
            t1 = time.perf_counter()
            _, metrics = train_step(state, batch, gen, use_r1=bool(use_r1))
            loss = float(metrics["g_loss"])  # synchronises
            ms = (time.perf_counter() - t1) * 1e3
        finally:
            unet_mod.gn_mish_mask = orig_k1
        got = dict(kernels.LAUNCHES)
        want_step = {gn_mish.NAME: fwd_step, gn_mish.BWD_NAME: bwd_step, mas.NAME: mas_step}
        if any(got.get(k, 0) != n for k, n in want_step.items()) or \
                k1_dtypes.get(torch.bfloat16, 0) != bf16_step:
            raise AssertionError(f"[GAN] one step launched {got} (K1 by dtype {dict(k1_dtypes)}), "
                                 f"want {want_step} with {bf16_step} bf16 forwards")
        if not math.isfinite(loss) or (float(metrics["r1_penalty"]) > 0) != bool(use_r1):
            raise AssertionError(f"[GAN] use_r1={use_r1}: g_loss {loss}, "
                                 f"r1_penalty {float(metrics['r1_penalty'])}")
        turns[use_r1].append(ms)
        peaks[use_r1].append(torch.cuda.max_memory_allocated())
    step_launches = got

    # one micro-batch of that batch by part, warm: the sampler, the D phase
    # with and without R1 (forward, loss, gradients), the G phase
    sample_fake, d_loss_fn, g_loss_fn = make_gan_loss_fns(cfg)
    mb = _micro_split(batch.to("cuda"), cfg.micro_batch_size)[1][0]
    d_params = list(state.disc.parameters())
    g_params = [p for n, p in state.model.named_parameters() if not n.startswith("syncnet.")]
    fake = sample_fake(state.model, mb, gen)

    def d_phase(use_r1):
        torch.autograd.grad(d_loss_fn(state.disc, mb.y, fake, use_r1)[0], d_params)

    def g_phase():
        state.model.train()
        torch.autograd.grad(g_loss_fn(state.model, state.disc, mb, fake, False)[0], g_params,
                            allow_unused=True)

    parts_ms = dict(zip(("sampler", "D phase, R1 on", "D phase, R1 off", "G phase"), time_ms_turns(
        [lambda: sample_fake(state.model, mb, gen), lambda: d_phase(True), lambda: d_phase(False),
         g_phase], iters=1, reps=3)))
    turns_s = sampler_turns(load_old_step(old_step), cfg, state, mb, gen) if old_step else None

    profiles = {}
    for use_r1 in (1, 0):  # one warm step each; R1's cost by kernel is the difference
        for _ in range(3):  # the profiler now and then returns no device events
            profiles[use_r1] = device_profile(
                lambda: train_step(state, batch, gen, use_r1=bool(use_r1)), n=1)
            if profiles[use_r1][0]:
                break
    return {
        "cfg": cfg, "steps": steps, "vals": vals, "launches": launches, "dtypes": dtypes,
        "wall_s": wall, "step_ms": [1e3 / r["train/steps_per_sec"] for r in steps],
        "peak_bytes": peak, "buckets": buckets, "n_val": n_val, "turns": turns, "peaks": peaks,
        "step_launches": step_launches, "turn_bucket": (batch.x.shape[1], batch.y.shape[2]),
        "profiles": profiles, "mas_inputs": mas_seen[0], "parts_ms": parts_ms,
        "sampler_turns": turns_s,
        "state": state, "batch": batch, "train_ds": train_ds, "val_ds": val_ds,
        "n_batches": len(loader),
    }


# device kernels of the sampler by part: (label, name fragments), first match wins
SAMPLER_PARTS = (("K1", ("gn_mish",)), ("casts and copies", ("copy", "Copy", "cast")),
                 ("convolutions and GEMMs", ("conv", "gemm", "Gemm", "xmma", "cudnn", "sm90_",
                                             "sm80_", "cutlass", "wgrad", "dgrad")))


def load_old_step(path):
    """An earlier ``train/step.py`` (a git-ignored copy) loaded as a module of
    its own; its imports resolve to this checkout's port."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("facegantts_tpu_torch.train._earlier_step",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sampler_turns(old_step, cfg, state, mb, gen):
    """The GAN step's no-grad ``sample_fake`` of an earlier ``step.py`` and
    of this one on one micro-batch and the same noise: card time in turns
    (earlier, new, new, earlier; three calls a turn, CUDA events), then one
    profiled call of each: device time by part (``SAMPLER_PARTS``, the rest
    elementwise), launches, and K1's calls by dtype."""
    import torch

    from facegantts_tpu_torch.train import step as new_step

    noise = torch.randn(mb.y.shape, generator=gen, device="cuda")
    fns = {tag: mod.make_gan_loss_fns(cfg)[0] for tag, mod in
           (("earlier", old_step), ("new", new_step))}
    calls = {tag: (lambda f=f: f(state.model, mb, noise=noise)) for tag, f in fns.items()}
    out = {tag: {"ms": []} for tag in fns}
    fakes = {tag: fn() for tag, fn in calls.items()}
    torch.cuda.synchronize()
    for tag in ("earlier", "new", "new", "earlier"):
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            calls[tag]()
            end.record()
            end.synchronize()
            out[tag]["ms"].append(start.elapsed_time(end))
    for tag, fn in calls.items():
        with path_counts() as pc:
            per, wall, count = device_profile(fn, n=1)
        parts = collections.Counter()
        for k, v in per.items():
            label = next((lab for lab, frags in SAMPLER_PARTS if any(f in k for f in frags)),
                         "elementwise and the rest")
            parts[label] += v / 1e3
        out[tag].update(device_ms=sum(per.values()) / 1e3, parts=dict(parts),
                        launches=sum(count.values()), wall_ms=wall / 1e3,
                        k1_dtypes={k: v // 2 for k, v in pc.fwd.items()})  # warm-up + run
    diff = (fakes["new"] - fakes["earlier"]).abs().amax(dim=1)  # (B, T)
    cover = {tag: f.abs().sum(dim=1) > 0 for tag, f in fakes.items()}  # the frames it covers
    both = cover["new"] & cover["earlier"]
    out["fake_diff"], out["fake_max"] = float(diff.max()), float(fakes["earlier"].abs().max())
    out["fake_diff_both"] = float(diff[both].max()) if both.any() else None
    out["frames"] = {tag: c.sum(dim=1).tolist() for tag, c in cover.items()}
    return out


class path_counts:
    """Inside the block: every kernel's launches (``kernels.LAUNCHES``, zeroed
    on entry, read on exit) and the dtype of every K1 forward call from the
    U-Net and every K1 backward call."""

    def __enter__(self):
        from facegantts_tpu_torch.models import unet as unet_mod
        from facegantts_tpu_torch.ops import gn_mish, kernels

        self.fwd, self.bwd = collections.Counter(), collections.Counter()
        self.orig = unet_mod.gn_mish_mask, gn_mish.gn_mish_mask_bwd

        def fwd(x, *a, **k):
            self.fwd[str(x.dtype)[6:]] += 1
            return self.orig[0](x, *a, **k)

        def bwd(g, x, *a, **k):
            self.bwd[str(x.dtype)[6:]] += 1
            return self.orig[1](g, x, *a, **k)

        unet_mod.gn_mish_mask, gn_mish.gn_mish_mask_bwd = fwd, bwd
        kernels.LAUNCHES.clear()
        return self

    def __exit__(self, *exc):
        from facegantts_tpu_torch.models import unet as unet_mod
        from facegantts_tpu_torch.ops import gn_mish, kernels

        unet_mod.gn_mish_mask, gn_mish.gn_mish_mask_bwd = self.orig
        self.launches = dict(kernels.LAUNCHES)

    def check(self, label, fwd, fwd_bf16, bwd, bwd_bf16, n_mas):
        """Raise unless the block launched K1's forward ``fwd`` times
        (``fwd_bf16`` of them bf16), its backward ``bwd`` times (``bwd_bf16``
        bf16) and MAS ``n_mas`` times."""
        from facegantts_tpu_torch.ops import gn_mish, mas

        got = (self.launches.get(gn_mish.NAME, 0), self.fwd["bfloat16"],
               self.launches.get(gn_mish.BWD_NAME, 0), self.bwd["bfloat16"],
               self.launches.get(mas.NAME, 0))
        want = (fwd, fwd_bf16, bwd, bwd_bf16, n_mas)
        if got != want or sum(self.fwd.values()) != fwd or sum(self.bwd.values()) != bwd:
            raise AssertionError(f"[options {label}] launches (K1 forward, of them bf16, K1 "
                                 f"backward, of them bf16, MAS) {got}, want {want}; K1 calls by "
                                 f"dtype: forward {dict(self.fwd)}, backward {dict(self.bwd)}")
        return got


def option_counts(cfg):
    """Per GAN step of ``cfg`` at batch 64 (plain step: per step), what the
    code launches: (K1 forwards, of them bf16, K1 backwards, of them bf16,
    MAS).  Every U-Net evaluation gets an f32 activation, the bf16 samplers'
    and ``train_bf16``'s too, where the JAX package's flax promotes the
    encoder (from its first attention on) and the U-Net to f32 with bf16
    weights (``train/precision.py``), so K1 runs in f32 on every training
    path, forward and backward."""
    if not cfg.use_gan:
        return K1_PER_EVAL, 0, K1_PER_EVAL, 0, 1
    n = cfg.per_gpu_batchsize // cfg.micro_batch_size
    sampler = n * K1_PER_EVAL * cfg.train_fake_timesteps
    g_evals = 1 + (cfg.timesteps if cfg.adv_grad_through_sampler else 0)
    g_fwd = n * K1_PER_EVAL * g_evals * (2 if cfg.grad_remat else 1)
    return (sampler + g_fwd, 0, n * K1_PER_EVAL * g_evals, 0,
            n * (2 if cfg.grad_remat else 1))


def option_run(label, cfg, work_dir, steps, train_ds, val_ds):
    """``train/loop.train`` under ``cfg`` for ``steps`` steps and its
    validation (one batch): every metric finite, the launches of the steps
    and the validation batch as ``option_counts`` says, masters and
    optimizer state f32.  Returns (state, step ms, peak bytes, launches,
    the last step's metrics)."""
    import shutil

    import torch

    from facegantts_tpu_torch.train.loop import train

    shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with path_counts() as counts:
        state = train(cfg, work_dir, steps, train_ds, val_ds, device="cuda")
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    key = "train/g_loss" if cfg.use_gan else "train/total_loss"
    logged = [r for r in recs if key in r]
    vals = [r for r in recs if "val/total_loss" in r]
    if [r["step"] for r in logged] != list(range(1, steps + 1)) or not vals:
        raise AssertionError(f"[options {label}] logged steps {[r['step'] for r in logged]}, "
                             f"{len(vals)} validations")
    for r in logged + vals:
        bad = [k for k, v in r.items() if k != "step" and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"[options {label}] non-finite {bad} at step {r['step']}")
    n_val = int(vals[-1]["val/batches"])
    if n_val != 1:
        raise AssertionError(f"[options {label}] {n_val} validation batches, want 1")
    fwd, fwd16, bwd, bwd16, n_mas = option_counts(cfg)
    # a validation batch: the no-grad sampler (GAN) and one f32 loss
    v_fwd = K1_PER_EVAL * ((cfg.train_fake_timesteps + 1) if cfg.use_gan else 1)
    v_fwd16 = 0
    got = counts.check(label, steps * fwd + v_fwd, steps * fwd16 + v_fwd16, steps * bwd,
                       steps * bwd16, steps * n_mas + 1)
    for module in (state.model, state.disc):
        if module is None:
            continue
        bad = [n for n, p in module.named_parameters() if p.dtype != torch.float32
               or (p.grad is not None and p.grad.dtype != torch.float32)]
        if bad:
            raise AssertionError(f"[options {label}] not f32: {bad[:4]}")
    for opt in (state.optimizer, state.disc_optimizer):
        if opt is None:
            continue
        bad = [k for st in opt.opt.state.values() for k, v in st.items()
               if torch.is_tensor(v) and v.dim() and v.dtype != torch.float32]
        if bad:
            raise AssertionError(f"[options {label}] optimizer state not f32: {bad[:4]}")
    step_ms = [1e3 / r["train/steps_per_sec"] for r in logged]
    return state, step_ms, peak, got, logged[-1]


# phase 14: a small LRS2-shaped corpus (train, val, test clips over 8 speakers)
CORPUS_SPLITS = (("train", 64), ("val", 8), ("test", 8))
CORPUS_SPEAKERS = 8
CORPUS_SECONDS = (1.2, 5.6)
CORPUS_TEXTS = (
    "THE BIRCH CANOE SLID ON THE SMOOTH PLANKS", "GLUE THE SHEET TO THE DARK BLUE BACKGROUND",
    "IT IS EASY TO TELL THE DEPTH OF A WELL", "THESE DAYS A CHICKEN LEG IS A RARE DISH",
    "RICE IS OFTEN SERVED IN ROUND BOWLS", "THE JUICE OF LEMONS MAKES FINE PUNCH",
    "THE BOX WAS THROWN BESIDE THE PARKED TRUCK", "THE HOGS WERE FED CHOPPED CORN AND GARBAGE",
    "FOUR HOURS OF STEADY WORK FACED US", "A LARGE SIZE IN STOCKINGS IS HARD TO SELL",
    "THE BOY WAS THERE WHEN THE SUN ROSE", "A ROD IS USED TO CATCH PINK SALMON",
    "THE SOURCE OF THE HUGE RIVER IS THE CLEAR SPRING", "KICK THE BALL STRAIGHT AND FOLLOW THROUGH",
    "HELP THE WOMAN GET BACK TO HER FEET", "A POT OF TEA HELPS TO PASS THE EVENING",
)
EVAL_STEPS = 2  # phase 14's training: the evaluation runs at its last step
EVAL_BATCH = 16  # the corpus's 64 training clips give few full batches of 64
# phase 14's mel bar against the formula in float64, TF32 off (set before the
# first run on the card from the CPU's differences on this corpus): the linear
# mel within 1e-5 of its frame's largest value, the log-mel within MEL_LOG_BAR
# where the mel is above 1e-3 of that value
MEL_LOG_BAR = 5e-4


def corpus_clip(seconds, f0_range, rng, sr=16000):
    """One speech-like clip: voiced harmonic segments of 0.15-0.6 s with a
    gliding F0 in ``f0_range`` and a vowel-like tilt, pauses of 0.05-0.3 s,
    a noise floor; int16 at 0.7 of full scale."""
    n = int(seconds * sr)
    y = 0.004 * rng.standard_normal(n)
    pos = int(rng.uniform(0.05, 0.2) * sr)
    while pos < n - int(0.1 * sr):
        m = min(int(rng.uniform(0.15, 0.6) * sr), n - pos)
        f0 = np.linspace(*rng.uniform(*f0_range, 2), m)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        formant = rng.uniform(1.0, 1.6)
        seg = sum(np.sin(k * phase + rng.uniform(0, 6)) / k ** formant for k in range(1, 30)
                  if k * f0.max() < sr / 2)
        seg = seg * np.hanning(m) ** 0.3 + 0.02 * rng.standard_normal(m)
        y[pos:pos + m] += seg
        pos += m + int(rng.uniform(0.05, 0.3) * sr)
    return (y / np.abs(y).max() * 0.7 * 32767).astype(np.int16)


def write_corpus(root, face_png, seed=0):
    """The LRS2 layout under ``root``: ``lrs2/wav/{trainval,test}/<spk>/<clip>.wav``,
    the ``Text:`` line and the face jpg beside ``lrs2/{trainval,test}/<spk>/<clip>``,
    and one filelist a split.  Returns (Config overrides, {split: clip names})."""
    import shutil

    from PIL import Image
    from scipy.io import wavfile

    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(seed)
    lrs2 = os.path.join(root, "lrs2")
    f0s = [(lo, lo + rng.uniform(25, 60)) for lo in np.linspace(90, 190, CORPUS_SPEAKERS)]
    face = Image.open(face_png).convert("RGB")
    names, over = {}, {"lrs2_path": lrs2}
    for split, count in CORPUS_SPLITS:
        sub = "test" if split == "test" else "trainval"
        names[split] = [f"spk{i % CORPUS_SPEAKERS}_{split}/{i:05d}" for i in range(count)]
        for i, name in enumerate(names[split]):
            spk = i % CORPUS_SPEAKERS
            for d in (os.path.join("wav", sub), sub):
                os.makedirs(os.path.join(lrs2, d, os.path.dirname(name)), exist_ok=True)
            wavfile.write(os.path.join(lrs2, "wav", sub, name + ".wav"), 16000,
                          corpus_clip(rng.uniform(*CORPUS_SECONDS), f0s[spk], rng))
            with open(os.path.join(lrs2, sub, name + ".txt"), "w") as f:
                f.write(f"Text:  {CORPUS_TEXTS[rng.integers(len(CORPUS_TEXTS))]}\nConf:  4\n")
            face.save(os.path.join(lrs2, sub, name + ".jpg"))
        over[f"lrs2_{split}"] = os.path.join(root, f"{split}.list")
        with open(over[f"lrs2_{split}"], "w") as f:
            f.write("\n".join(names[split]) + "\n")
    return over, names


def mel_errors(got, exact):
    """(linear error of the frame's largest value, log error where the mel
    is above 1e-3 of it), each the largest over the clip."""
    lin, top = np.exp(exact), np.exp(exact).max(axis=0, keepdims=True)
    live = lin > 1e-3 * top
    return (float((np.abs(np.exp(got) - lin) / top).max()),
            float(np.abs(got - exact)[live].max()))


def pack_corpus(over, packed, device):
    """Every split through ``data.preprocess.main`` on ``device``, each
    clip's mel recorded with the waveform it came from; the mels are held to
    ``ops/mel.py: mel_spectrogram_float64`` (TF32 off, whatever the process
    sets) and the packed
    float16 mels to the recorded ones.  Returns (seconds by part a clip,
    {split: shard paths}, the largest errors, clips)."""
    import torch

    from facegantts_tpu_torch.config import default_config
    from facegantts_tpu_torch.data import preprocess
    from facegantts_tpu_torch.data.dataset import load_packed
    from facegantts_tpu_torch.ops.mel import mel_spectrogram_float64

    seen, orig = [], preprocess._mel_host

    def recording(wav, cfg, device=None):
        out = orig(wav, cfg, device)
        seen.append((np.array(wav), out))
        return out

    timings, shards = {}, {}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # the op must turn TF32 off itself
    preprocess._mel_host = recording
    try:
        for split, _ in CORPUS_SPLITS:
            argv = [f"{k}={v}" for k, v in over.items()] + [
                f"packed_data_dir={packed}", f"split={split}", f"device={device}"]
            shards[split] = preprocess.main(argv, timings=timings)
    finally:
        preprocess._mel_host = orig
        torch.backends.cuda.matmul.allow_tf32 = prev
    cfg = default_config(env={}, overrides=dict(packed_data_dir=packed))
    args = (cfg.n_fft, cfg.n_mels, cfg.sample_rate, cfg.hop_len, cfg.win_len, cfg.f_min,
            cfg.f_max)
    errs = [mel_errors(m, mel_spectrogram_float64(w, *args)[0]) for w, m in seen]
    lin, log_err = max(e[0] for e in errs), max(e[1] for e in errs)
    if not (lin <= 1e-5 and log_err <= MEL_LOG_BAR):
        raise AssertionError(f"[data] mel against float64: linear {lin:.3e} of the frame's "
                             f"largest value (bar 1e-5), log {log_err:.3e} (bar {MEL_LOG_BAR})")
    packed_mels = [np.asarray(ds[i]["y"]) for split, _ in CORPUS_SPLITS
                   for ds in [load_packed(cfg, split)] for i in range(len(ds))]
    if len(packed_mels) != len(seen) or any(
            not np.array_equal(p.astype(np.float16), m.astype(np.float16))
            for p, (_, m) in zip(packed_mels, seen)):
        raise AssertionError("[data] a packed mel is not its recorded mel in float16")
    per_clip = {k: v / len(seen) for k, v in timings.items()}
    return per_clip, shards, (lin, log_err), len(seen)


_MISSING = object()


class timed_calls:
    """Inside the block, each ``(owner, attribute, label)`` callable is
    wrapped to add its host seconds (its results reach the host, so they
    include the device's) to ``self.seconds[label]`` and its result to
    ``self.results[label]``."""

    def __init__(self, targets):
        self.targets, self.seconds, self.saved = targets, collections.Counter(), []
        self.results = collections.defaultdict(list)

    def __enter__(self):
        for owner, attr, label in self.targets:
            fn = getattr(owner, attr)

            def timed(*a, _fn=fn, _label=label, **k):
                t0 = time.perf_counter()
                try:
                    out = _fn(*a, **k)
                finally:
                    self.seconds[_label] += time.perf_counter() - t0
                self.results[_label].append(out)
                return out

            self.saved.append((owner, attr, owner.__dict__.get(attr, _MISSING)))
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, old in reversed(self.saved):
            if old is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)



def eval_train(cfg, work_dir, device="cuda"):
    """``train/loop.train`` on the packed corpus with the in-training
    evaluation at its last step: every evaluation's launches (counts zeroed
    just before it, read just after) and host seconds by part.  Returns
    (state, the evaluations' records, the whole run's launches)."""
    import shutil

    from facegantts_tpu_torch.evaluation import evaluate, intrain
    from facegantts_tpu_torch.evaluation import metrics as metrics_mod
    from facegantts_tpu_torch.evaluation import world
    from facegantts_tpu_torch.ops import kernels
    from facegantts_tpu_torch.train.loop import train

    shutil.rmtree(work_dir, ignore_errors=True)
    records, total = [], collections.Counter()
    orig_run = intrain.IntrainEvaluator.run

    def run(self, state, step):
        total.update(kernels.LAUNCHES)
        targets = [(self.synth, "synthesize", "synthesis"), (self, "_gt_wav", "copy-synthesis"),
                   (self, "syncnet_apply", "SyncNet"), (evaluate, "_mel", "mel"),
                   (world, "world_log_f0_rmse", "WORLD F0"), (metrics_mod, "mcd", "MCD"),
                   (metrics_mod, "log_spectral_distance", "LSD"), (self, "mos", "MOS")]
        t0 = time.perf_counter()
        with timed_calls(targets) as tc, path_counts() as pc:
            res = orig_run(self, state, step)
        records.append({"step": step, "results": res, "seconds": dict(tc.seconds),
                        "wall_s": time.perf_counter() - t0, "launches": pc.launches,
                        "k1_fwd": dict(pc.fwd), "k1_bwd": dict(pc.bwd),
                        "copies": tc.results["copy-synthesis"]})
        total.update(pc.launches)
        kernels.LAUNCHES.clear()
        return res

    kernels.LAUNCHES.clear()
    intrain.IntrainEvaluator.run = run
    try:
        t0 = time.perf_counter()
        state = train(cfg, work_dir, EVAL_STEPS, device=device)
        wall = time.perf_counter() - t0
    finally:
        intrain.IntrainEvaluator.run = orig_run
    total.update(kernels.LAUNCHES)
    return state, records, dict(total), wall


def data_eval_phase(smi, face_png):
    """Phase 14: the data and evaluation path on the card.  Raises on any
    failed check; returns what it measured."""
    import torch

    from facegantts_tpu_torch.config import default_config
    from facegantts_tpu_torch.evaluation import acc_measure, evaluate
    from facegantts_tpu_torch.ops import gn_mish, mas

    root = os.path.join(ROOT, "runs", "chip_smoke_corpus")
    packed = os.path.join(root, "packed")
    out = {}
    t0 = time.perf_counter()
    over, names = write_corpus(root, face_png)
    out["write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["per_clip_s"], out["shards"], out["mel_err"], out["clips"] = pack_corpus(
        over, packed, "cuda")
    out["pack_s"] = time.perf_counter() - t0

    # train on it, the evaluation at the last step
    cfg = default_config(env={}, overrides=dict(
        over, packed_data_dir=packed, use_gan=0, fused_gn_mish=1, eval_interval=EVAL_STEPS,
        batch_size=EVAL_BATCH, num_gpus=1, log_every_n_steps=1))
    if cfg.eval_n_samples != 4 or cfg.f0_protocol != "world" or not cfg.use_bf16:
        raise AssertionError(f"[eval] not the Config's evaluation: eval_n_samples "
                             f"{cfg.eval_n_samples}, f0_protocol {cfg.f0_protocol}, use_bf16 "
                             f"{cfg.use_bf16}")
    work = os.path.join(ROOT, "runs", "chip_smoke_eval")
    state, records, out["train_launches"], out["train_wall_s"] = eval_train(cfg, work)
    del state
    torch.cuda.empty_cache()
    if [r["step"] for r in records] != [EVAL_STEPS]:
        raise AssertionError(f"[eval] evaluations at steps {[r['step'] for r in records]}")
    rec = out["eval"] = records[0]
    n = int(rec["results"]["Samples"])
    got = (rec["launches"].get(gn_mish.NAME, 0), rec["k1_fwd"].get("bfloat16", 0),
           rec["launches"].get(gn_mish.BWD_NAME, 0), rec["launches"].get(mas.NAME, 0))
    want = (K1_PER_EVAL * cfg.timesteps * n, K1_PER_EVAL * cfg.timesteps * n, 0, 0)
    if n != cfg.eval_n_samples or got != want:
        raise AssertionError(f"[eval] {n} items; launches (K1, of them bf16, K1 backward, MAS) "
                             f"{got}, want {want}")
    with open(os.path.join(work, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    evals = [r for r in recs if "eval/Composite Metric" in r]
    if "eval_backends" not in recs[0] or [r["step"] for r in evals] != [EVAL_STEPS] or not all(
            math.isfinite(v) for v in evals[0].values()):
        raise AssertionError(f"[eval] metrics.jsonl: {recs[0]}, {evals}")
    step_dir = os.path.join(work, "inference", f"step_{EVAL_STEPS:08d}")
    with open(os.path.join(step_dir, "eval_output.txt")) as f:
        text = f.read()
    for key in ("# backend syncnet: RANDOM-INIT", "# backend mos: DSP calibration proxy",
                "# backend f0: world", "# backend vocoder: RANDOM-INIT", "Composite Metric: ",
                "Speaker Similarity: ", "F0 RMSE: ", "MCD: ", "STFT Distance: ", "UTMOS: "):
        if key not in text:
            raise AssertionError(f"[eval] eval_output.txt lacks {key!r}")
    samples = [os.path.join(step_dir, f"sample_{i}.wav") for i in range(n)]
    if not all(os.path.exists(p) for p in samples):
        raise AssertionError(f"[eval] sample wavs missing in {step_dir}")
    out["eval_text"] = text
    out["samples"], out["work"] = samples, work

    # the evaluate CLI: the evaluation's samples against the corpus wavs of those val clips
    import shutil

    gt = os.path.join(root, "gt_eval")
    os.makedirs(gt, exist_ok=True)
    for i in range(n):
        shutil.copy(os.path.join(over["lrs2_path"], "wav", "trainval", names["val"][i] + ".wav"),
                    os.path.join(gt, f"sample_{i}.wav"))
    t0 = time.perf_counter()
    res = evaluate.main([f"output_dir={step_dir}", f"ground_truth_dir={gt}",
                         f"results_path={os.path.join(root, 'evaluation')}"])
    out["evaluate_s"] = time.perf_counter() - t0
    if res["Paired Files"] != n or not all(math.isfinite(v) for v in res.values()):
        raise AssertionError(f"[evaluate] {res}")
    with open(os.path.join(root, "evaluation", "eval_output.txt")) as f:
        if "Composite Metric: " not in f.read():
            raise AssertionError("[evaluate] eval_output.txt lacks the composite")
    out["evaluate"] = res

    # the acc_measure CLI on the packed test split
    t0 = time.perf_counter()
    acc = acc_measure.main([f"packed_data_dir={packed}", "n_way=5", "n_trials=100"])["results"]
    out["acc_s"] = time.perf_counter() - t0
    if not all(0.0 <= acc[k] <= 1.0 for k in ("voice_to_face_acc", "face_to_voice_acc")):
        raise AssertionError(f"[acc_measure] {acc}")
    out["acc"] = acc
    out["cfg"], out["gt_dir"], out["packed"] = cfg, gt, packed
    return out


# phase 15: the UTMOS-strong SSL MOS model at the wav2vec2 BASE widths
MOS_SEED = 15
MOS_SECONDS = (1, 4, 10)
CONV_KERNELS, CONV_STRIDES = (10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2)  # wav2vec2 BASE
# the card against the port on the CPU, strict f32 (set before the first card
# run from the CPU's f32-against-float64 differences at half and quarter
# widths, 1 and 4 s: features 2.2e-6 to 3.1e-6, MOS 7.5e-9 to 2.8e-8)
SSL_MOS_BAR, SSL_FEAT_BAR = 1e-5, 1e-4
SWEEP_LRS = (1e-4, 1e-5)
SWEEP_TIMEOUT_S = 600


def mos_clip(seconds, seed):
    """Phase-14-style harmonic speech-like audio, float in [-1, 1]."""
    return corpus_clip(seconds, (100, 160), np.random.default_rng(seed)).astype(np.float32) / 32768


def utmos_flops(sizes, n):
    """(frames, {part: operations}) of one ``UTMOSStrong`` call on ``n``
    samples, a multiply-add counted as 2."""
    t, c_in, conv = n, 1, 0.0
    for d, k, st in zip(sizes["conv_dims"], CONV_KERNELS, CONV_STRIDES):
        t = (t - k) // st + 1
        conv += 2.0 * t * d * c_in * k
        c_in = d
    h, f, lh = sizes["hidden"], sizes["ffn"], sizes["blstm_hidden"]
    conv += 2.0 * t * c_in * h  # the feature projection
    lstm_in = h + 2 * sizes["cond_dim"]
    return t, {
        "conv encoder": conv,
        "positional conv": 2.0 * t * h * (h // sizes["pos_groups"]) * sizes["pos_kernel"],
        "layers": sizes["layers"] * (8.0 * t * h * h + 4.0 * t * t * h + 4.0 * t * h * f),
        "BiLSTM": 2 * 2.0 * t * (lstm_in + lh) * 4 * lh,
        "head": 2.0 * t * 2 * lh * sizes["proj_hidden"] + 2.0 * t * sizes["proj_hidden"],
    }


def mos_parts(model, x):
    """{part: callable} over ``model``'s parts, each on the input the part
    before it gives for ``x``: the conv encoder (with the feature
    projection), the positional conv (with the add and the encoder's
    LayerNorm), the transformer layers, the BiLSTM (with the conditioning),
    the head (with the frame mean)."""
    import torch

    w, enc = model.wav2vec2, model.wav2vec2.encoder

    def layers(y):
        for layer in enc["layers"]:
            y = layer(y)
        return y

    def blstm(y):
        cond = torch.cat([model.domain_emb.weight[0], model.judge_emb.weight[0]])
        return model.blstm(torch.cat([y, cond.expand(*y.shape[:2], -1)], dim=-1))[0]

    with torch.inference_mode():
        h = w.feature_projection(w.feature_extractor(x))
        p = enc["layer_norm"](h + enc["pos_conv_embed"](h))
        y = layers(p)
        z = blstm(y)
    return {"conv encoder": lambda: w.feature_projection(w.feature_extractor(x)),
            "positional conv": lambda: enc["layer_norm"](h + enc["pos_conv_embed"](h)),
            "layers": lambda: layers(p), "BiLSTM": lambda: blstm(y),
            "head": lambda: model.projection(z)[..., 0].mean(-1) * 2 + 3}


def profile_ms(fn, n=3):
    """(device ms, launches) of one call of ``fn`` under torch.profiler: the
    sum over its kernels (kernels that overlap on other streams count in
    full); (None, 0) where the profiler saw no device events three times."""
    for _ in range(3):  # the profiler now and then returns no device events
        per, _, count = device_profile(fn, n=n)
        if per:
            return sum(per.values()) / 1e3, sum(count.values())
    return None, 0


def run_sweep(cmd, timeout):
    """Run the sweep's command, its output read line by line: (exit code,
    lines, [seconds of each trial from its "running" line to its result
    line]).  The command is killed after ``timeout`` seconds."""
    import re
    import threading

    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    lines, trial_s, started = [], [], None
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("[hyperopt] running:"):
                started = time.perf_counter()
            elif re.match(r"\[hyperopt\] trial \d+: composite=", line) and started is not None:
                trial_s.append(time.perf_counter() - started)
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, lines, trial_s


def mos_phase(smi, de):
    """Phase 15: the UTMOS-strong SSL MOS model at the wav2vec2 BASE widths
    on the card, through ``make_mos_predictor``, the ``evaluate`` CLI, the
    analysis statistics, the weight pins and the hyperparameter sweep, on
    phase 14's corpus and samples (``de``).  Raises on any failed check;
    returns what it measured."""
    import copy
    import shutil

    import torch
    from scipy.io import wavfile

    from facegantts_tpu_torch import weights
    from facegantts_tpu_torch.evaluation import analysis, evaluate, ssl_mos, utmos
    from facegantts_tpu_torch.evaluation.metrics import stft_mag
    from facegantts_tpu_torch.ops import kernels

    root = os.path.join(ROOT, "runs", "chip_smoke_mos")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {}
    kernels.LAUNCHES.clear()

    # (a) one seeded model written twice: HF naming with parametrizations,
    # fairseq naming with weight_g / weight_v
    t0 = time.perf_counter()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(MOS_SEED)
        model = ssl_mos.UTMOSStrong()
    sd = model.state_dict()
    sizes = ssl_mos.model_sizes(sd)
    out["params"] = sum(p.numel() for p in model.parameters())
    files = {"hf": os.path.join(root, "utmos_hf.pt"),
             "fairseq": os.path.join(root, "utmos_fairseq.pt")}
    torch.save(ssl_mos.reference_state_dict(sd, "hf", "parametrizations"), files["hf"])
    torch.save({"state_dict": ssl_mos.reference_state_dict(sd, "fairseq", "g_v")},
               files["fairseq"])
    del model, sd
    out["write_s"] = time.perf_counter() - t0
    out["file_bytes"] = {k: os.path.getsize(v) for k, v in files.items()}
    preds, out["load_s"] = {}, {}
    for k, path in files.items():
        t0 = time.perf_counter()
        pred = utmos.make_mos_predictor(path)
        out["load_s"][k] = time.perf_counter() - t0
        devices = {p.device.type for p in pred.model.parameters()}
        if not isinstance(pred, ssl_mos.SSLMOSPredictor) or devices != {"cuda"}:
            raise AssertionError(f"[mos] {k} file: {type(pred).__name__} on {devices}")
        # cuDNN's LSTM wants its weights in one buffer (else it compacts them at every call)
        chunks = {p.untyped_storage().data_ptr() for p in pred.model.blstm.parameters()}
        if len(chunks) != 1:
            raise AssertionError(f"[mos] {k} file: the LSTM's weights lie in {len(chunks)} buffers")
        preds[k] = pred
    clips = {sec: mos_clip(sec, sec) for sec in MOS_SECONDS}
    with strict_f32():
        out["hf_fairseq"] = [preds[k](clips[4], 16000) for k in files]
    if abs(out["hf_fairseq"][0] - out["hf_fairseq"][1]) > 1e-6:
        raise AssertionError(f"[mos] HF and fairseq files differ: {out['hf_fairseq']}")
    pred = preds.pop("hf")
    del preds
    torch.cuda.empty_cache()

    # (b) the card against the port on the CPU, strict f32; the shift under
    # PyTorch's TF32 defaults; the shift with every norm at torch's 1e-5
    cpu = ssl_mos.model_from_state_dict(
        {k: v.cpu() for k, v in pred.model.state_dict().items()}, device="cpu")
    eps5 = copy.deepcopy(pred.model)
    eps5.blstm.flatten_parameters()
    for m in eps5.modules():
        if isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            m.eps = 1e-5
    out["cpu_rows"] = []
    for sec, wav in clips.items():
        x = torch.from_numpy(wav)[None]
        with torch.inference_mode():
            with strict_f32():
                feat_cpu, mos_cpu = cpu.wav2vec2(x), float(cpu(x))
                feat_gpu = pred.model.wav2vec2(x.cuda()).cpu()
                mos_gpu, mos_eps5 = pred(wav, 16000), float(eps5(x.cuda()))
            with cudnn_mode(tf32=True, deterministic=False):  # PyTorch's defaults
                mos_tf32 = pred(wav, 16000)
        row = {"seconds": sec, "frames": feat_cpu.shape[1], "mos_cpu": mos_cpu,
               "mos_gpu": mos_gpu, "mos_err": abs(mos_gpu - mos_cpu),
               "feat_err": float((feat_gpu - feat_cpu).abs().max()),
               "feat_max": float(feat_cpu.abs().max()), "tf32_shift": mos_tf32 - mos_gpu,
               "eps5_shift": mos_eps5 - mos_gpu}
        out["cpu_rows"].append(row)
        if not (row["mos_err"] <= SSL_MOS_BAR and row["feat_err"] <= SSL_FEAT_BAR):
            raise AssertionError(f"[mos] card against CPU at {sec} s: MOS {row['mos_err']:.3e} "
                                 f"(bar {SSL_MOS_BAR}), features {row['feat_err']:.3e} "
                                 f"(bar {SSL_FEAT_BAR})")
    del cpu, eps5
    torch.cuda.empty_cache()

    # (c) warm time of a call, device time by part, launches, peak memory, at
    # PyTorch's defaults (what the evaluation runs)
    out["timing"] = []
    weight_bytes = sum(p.numel() * p.element_size() for p in pred.model.parameters())
    for sec, wav in clips.items():
        x = torch.from_numpy(wav)[None].cuda()
        ms = time_ms(lambda: pred(wav, 16000), iters=5, reps=5)
        dev_ms, launches = profile_ms(lambda: pred(wav, 16000))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        pred(wav, 16000)
        peak = torch.cuda.max_memory_allocated() - before  # above the weights and the rest
        with torch.inference_mode():
            parts = {k: (time_ms(fn, iters=5, reps=3), *profile_ms(fn))
                     for k, fn in mos_parts(pred.model, x).items()}
        frames, flops = utmos_flops(sizes, len(wav))
        bound_ms, bound_by = bound(weight_bytes + 4 * len(wav), sum(flops.values()))
        out["timing"].append({"seconds": sec, "frames": frames, "ms": ms, "dev_ms": dev_ms,
                              "launches": launches, "peak": peak, "parts": parts,
                              "gflop": {k: v / 1e9 for k, v in flops.items()},
                              "bound_ms": bound_ms, "bound_by": bound_by})
    out["weight_bytes"] = weight_bytes

    # (d) the evaluate CLI over phase 14's samples, scored by the HF file (F0
    # by YIN: phase 14 ran this CLI with WORLD, 20-35 s of host time)
    step_dir = os.path.dirname(de["samples"][0])
    t0 = time.perf_counter()
    with timed_calls([(ssl_mos.SSLMOSPredictor, "__call__", "MOS")]) as tc:
        res = evaluate.main([f"output_dir={step_dir}", f"ground_truth_dir={de['gt_dir']}",
                             f"results_path={os.path.join(root, 'evaluation')}",
                             f"mos_ckpt={files['hf']}", "f0_protocol=yin"])
    out["evaluate_s"], out["evaluate_mos_s"] = time.perf_counter() - t0, tc.seconds["MOS"]
    out["evaluate_mos_calls"] = len(tc.results["MOS"])
    with open(os.path.join(root, "evaluation", "eval_output.txt")) as f:
        text = f.read()
    if (f"# backend mos: utmos-ssl checkpoint ({files['hf']})" not in text
            or res["Paired Files"] != len(de["samples"])
            or not all(math.isfinite(v) for v in res.values())):
        raise AssertionError(f"[mos evaluate] {res}; eval_output.txt: {text[:400]!r}")
    out["evaluate"] = res

    # (e) the MOS-study statistics on phase 14's synthesized and
    # copy-synthesized items, and every plot where matplotlib imports
    synth = [wavfile.read(p)[1].astype(np.float32) / 32768 for p in de["samples"]]
    ratings = {"synthesized": [pred(w, 16000) for w in synth],
               "copy-synthesis": [pred(w, 16000) for w in de["eval"]["copies"]]}
    out["ratings"] = ratings
    out["stats"] = analysis.mos_statistics(ratings)
    out["wilcoxon"] = analysis.pairwise_wilcoxon(ratings)
    if not all(math.isfinite(v) for r in ratings.values() for v in r) or len(out["wilcoxon"]) != 1:
        raise AssertionError(f"[mos analysis] {ratings}, {out['wilcoxon']}")
    from facegantts_tpu_torch.data.dataset import load_packed

    val = load_packed(de["cfg"], "val")
    mels = [np.asarray(val[i]["y"], np.float32) for i in range(2)]
    spec_db = 20 * np.log10(stft_mag(synth[0], 1024, 256).T + 1e-6)
    plot_dir = os.path.join(root, "plots")
    os.makedirs(plot_dir)
    plots = [
        ("mel.png", lambda p: analysis.save_mel_plot(mels[0], p, title="val 0")),
        ("spectrogram.png", lambda p: analysis.save_spectrogram_db(spec_db, p, title="sample 0")),
        ("comparison.png", lambda p: analysis.save_mel_comparison(
            [("val 0", mels[0]), ("val 1", mels[1])], p)),
        ("progress.png", lambda p: analysis.save_epoch_progress([(1, mels[0]), (2, mels[1])], p)),
        ("faces.pdf", lambda p: analysis.save_face_grid_pdf(
            [os.path.join(ROOT, "test", "face.png")] * 4, p, cols=2)),
        ("curves.png", lambda p: analysis.plot_training_curves(
            os.path.join(de["work"], "metrics.jsonl"), p)),
    ]
    try:
        import matplotlib  # noqa: F401

        out["matplotlib"] = True
    except ImportError:
        out["matplotlib"] = False
    out["plots"] = {}
    for name, call in plots:
        path = os.path.join(plot_dir, name)
        if out["matplotlib"]:
            call(path)
            out["plots"][name] = os.path.getsize(path)
            continue
        try:
            call(path)
        except ImportError as e:
            if "matplotlib" not in str(e):
                raise
            out["plots"][name] = f"ImportError: {e}"
        else:
            raise AssertionError(f"[mos analysis] {name} written without matplotlib")

    # (f) the HF file pinned into a pins file of the work directory, then
    # loaded through the port's importer; a copy with one byte altered refused
    pins = os.path.join(root, "weight_pins.json")
    prev = os.environ.get("FACEGANTTS_WEIGHT_PINS")
    os.environ["FACEGANTTS_WEIGHT_PINS"] = pins
    try:
        t0 = time.perf_counter()
        out["digest"] = weights.pin("utmos22_strong", files["hf"])
        state, info = weights.load_verified("utmos22_strong", files["hf"])
        out["verified_s"] = time.perf_counter() - t0
        if info["unmapped"] or set(state) != set(pred.model.state_dict()):
            raise AssertionError(f"[weights] unmapped {info['unmapped'][:4]}")
        del state
        bad = os.path.join(root, "utmos_hf_altered.pt")
        shutil.copy(files["hf"], bad)
        with open(bad, "r+b") as f:
            f.seek(out["file_bytes"]["hf"] // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 1]))
        try:
            weights.load_verified("utmos22_strong", bad)
        except RuntimeError as e:
            if "mismatch" not in str(e):
                raise
            out["refused"] = str(e).splitlines()[0]
        else:
            raise AssertionError("[weights] an altered file was loaded")
        os.remove(bad)
    finally:
        if prev is None:
            os.environ.pop("FACEGANTTS_WEIGHT_PINS")
        else:
            os.environ["FACEGANTTS_WEIGHT_PINS"] = prev
    out["launches_in_process"] = dict(kernels.LAUNCHES)
    del pred
    torch.cuda.empty_cache()

    # (g) the hyperparameter sweep: a grid of two learning rates, each trial a
    # trainer process on the card with the in-training evaluation scored by
    # the HF file
    sweep_root = os.path.join(root, "sweep")
    fixed = dict(packed_data_dir=de["packed"], use_gan=0, batch_size=EVAL_BATCH, num_gpus=1,
                 max_steps=2, eval_interval=2, eval_n_samples=1, mos_ckpt=files["hf"],
                 fused_gn_mish=1, log_every_n_steps=1)
    with open(os.path.join(root, "sweep.json"), "w") as f:
        json.dump({"fixed": fixed, "grid": {"learning_rate": list(SWEEP_LRS)}}, f)
    t0 = time.perf_counter()
    rc, lines, trial_s = run_sweep(
        [sys.executable, "-m", "facegantts_tpu_torch.hyperopt",
         f"config={os.path.join(root, 'sweep.json')}", f"out_root={sweep_root}"],
        SWEEP_TIMEOUT_S)
    out["sweep_s"], out["trial_s"] = time.perf_counter() - t0, trial_s
    with open(os.path.join(root, "sweep.log"), "w") as f:
        f.write("\n".join(lines) + "\n")
    launch_lines = [json.loads(ln.split(": ", 1)[1]) for ln in lines
                    if ln.startswith("[INFO] kernel launches: ")]
    devices = [ln for ln in lines if ln.startswith("[INFO] use_gan=")]
    with open(os.path.join(sweep_root, "results.json")) as f:
        results = json.load(f)
    out["sweep"], out["trial_launches"] = results, launch_lines
    composites = [r["composite"] for r in results]
    fails = []
    if rc != 0 or any("trial failed" in ln for ln in lines):
        fails.append(f"exit {rc}, failed trials {[ln for ln in lines if 'trial failed' in ln]}")
    if sorted(r["params"]["learning_rate"] for r in results) != sorted(SWEEP_LRS):
        fails.append(f"trials {[r['params'] for r in results]}")
    if not all(math.isfinite(c) for c in composites) or composites != sorted(composites):
        fails.append(f"composites {composites} (finite and sorted wanted)")
    if len(devices) != len(SWEEP_LRS) or not all(ln.endswith("device=cuda") for ln in devices):
        fails.append(f"trial devices {devices}")
    if len(launch_lines) != len(SWEEP_LRS) or not all(
            ll.get("gn_mish_mask", 0) > 0 and ll.get("maximum_path", 0) > 0
            for ll in launch_lines):
        fails.append(f"trial launches {launch_lines}")
    for r in results:
        path = os.path.join(sweep_root, f"trial_{r['trial']:03d}", "inference",
                            "step_00000002", "eval_output.txt")
        with open(path) as f:
            if f"# backend mos: utmos-ssl checkpoint ({files['hf']})" not in f.read():
                fails.append(f"{path} names another MOS backend")
    if fails:
        raise AssertionError("[sweep] " + "; ".join(fails) + "\n" + "\n".join(lines[-40:]))
    out["files"] = files
    return out


def log_mos(smi, mo, de):
    """Phase 15's lines from what ``mos_phase`` returned."""
    log(f"[mos] {smi}: UTMOSStrong at the wav2vec2 BASE widths, {mo['params']} parameters "
        f"(seed {MOS_SEED}), written as HF (parametrizations) and fairseq (weight_g/weight_v) "
        f"files of {mo['file_bytes']} bytes in {mo['write_s']:.1f} s; make_mos_predictor -> "
        f"SSLMOSPredictor on cuda in " + ", ".join(f"{k} {v:.1f} s" for k, v in mo["load_s"].items())
        + f"; MOS of the 4 s clip HF {mo['hf_fairseq'][0]!r}, fairseq {mo['hf_fairseq'][1]!r}")
    for r in mo["cpu_rows"]:
        log(f"[mos] {smi}: {r['seconds']} s ({r['frames']} frames), strict f32: card MOS "
            f"{r['mos_gpu']!r}, CPU {r['mos_cpu']!r}, |difference| {r['mos_err']:.3e} (bar "
            f"{SSL_MOS_BAR}); features max |difference| {r['feat_err']:.3e} (bar {SSL_FEAT_BAR}, "
            f"largest |feature| {r['feat_max']:.2f}); MOS shift under PyTorch's TF32 defaults "
            f"{r['tf32_shift']:.3e}; with every norm at eps 1e-5 {r['eps5_shift']:.3e}")
    for r in mo["timing"]:
        log(f"[mos] {smi}: {r['seconds']} s ({r['frames']} frames), PyTorch's defaults: warm "
            f"{r['ms']:.3f} ms a call (CUDA events, wav in, float out); device {fmt_ms(r['dev_ms'])} "
            f"in {r['launches']:.0f} launches (the profiler's sum over kernels); by part (card "
            f"ms by CUDA events, device ms, launches) " + ", ".join(
                f"{k} {v[0]:.3f} / {fmt_ms(v[1])} / {v[2]:.0f}" for k, v in r["parts"].items())
            + f"; GFLOP " + ", ".join(f"{k} {v:.3f}" for k, v in r["gflop"].items())
            + f"; bound {r['bound_ms']:.3f} ms ({r['bound_by']}; weights "
            f"{mo['weight_bytes']} bytes); the call's peak {r['peak'] / 2**20:.1f} MiB above "
            f"what was allocated before it")
    log(f"[mos evaluate] {smi}: python -m facegantts_tpu_torch.evaluation.evaluate with "
        f"mos_ckpt=<HF file> f0_protocol=yin over phase 14's {len(de['samples'])} samples: "
        f"{mo['evaluate_s']:.1f} s, "
        f"the MOS part {mo['evaluate_mos_s'] * 1e3:.1f} ms in {mo['evaluate_mos_calls']} calls; "
        + ", ".join(f"{k} {v:.4f}" for k, v in mo["evaluate"].items()))
    log(f"[mos analysis] SSL MOS of phase 14's items: " + "; ".join(
        f"{k} {[round(v, 6) for v in vals]}" for k, vals in mo["ratings"].items()))
    log(f"[mos analysis] mos_statistics {json.dumps(mo['stats'])}; pairwise_wilcoxon "
        f"{json.dumps(mo['wilcoxon'])}")
    log(f"[mos analysis] matplotlib {'imports: plots written' if mo['matplotlib'] else 'absent: each plot call raised'} "
        f"{mo['plots']}")
    log(f"[weights] {smi}: utmos22_strong pinned {mo['digest']} and loaded through "
        f"load_verified in {mo['verified_s']:.1f} s; a copy with one byte altered refused: "
        f"{mo['refused']}")
    log(f"[sweep] {smi}: python -m facegantts_tpu_torch.hyperopt, grid learning_rate "
        f"{list(SWEEP_LRS)}, use_gan=0, batch {EVAL_BATCH}, 2 steps, the evaluation of 1 item at "
        f"step 2 scored by the HF file: {mo['sweep_s']:.1f} s; seconds a trial "
        f"{[round(v, 1) for v in mo['trial_s']]}; results.json {json.dumps(mo['sweep'])}; "
        f"trial launches {mo['trial_launches']}; launches in this process over (a)-(f) "
        f"{mo['launches_in_process']}")


# phase 16: the tooling slice
EXPORT_SEEDS = (7, 8)  # a loaded call against the live one, each seed
EXPORT_TURNS = (0, 1, 1, 0) * 3  # 0 the loaded program, 1 the live Synthesizer
OP_TURNS = (0, 1, 1, 0) * 10  # K1 on the live path: 0 called directly, 1 through the op
OP_HOST_TURNS = (0, 1, 1, 0) * 2  # the host time of one K1 call each way, in turns
PROFILE_WINDOW = (1, 2)  # the traced training steps: start, count
BENCH_METRICS = ("train_samples_per_sec_parity", "mfu_parity",
                 "train_samples_per_sec_bucket_mix", "inference_rtf")


def run_module(args, timeout, env=None):
    """``python -m <args>`` from the repository root: (exit code, stdout,
    stderr, seconds); the child is killed at ``timeout``."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout, env=dict(os.environ, **(env or {})))
    return p.returncode, p.stdout, p.stderr, time.perf_counter() - t0


def export_check(tag, synth, fn, ids, texts, face, launches):
    """Phase 16 (a) in one precision: a loaded program ``fn`` of the pair
    the first test sentence (``ids``) lands in, held to ``synth`` at
    ``EXPORT_SEEDS`` (wav 1e-5, mel 5e-4, the bars of tests/test_export.py),
    250 K1 launches a call, and timed against it in turns.  Adds the
    launches to ``launches``."""
    import torch

    from facegantts_tpu_torch.ops import gn_mish, kernels

    cfg = synth.cfg
    tx, ty = cfg.text_buckets[0], cfg.mel_buckets[0]
    x = np.zeros((1, tx), np.int32)
    x[0, :len(ids)] = ids
    x_len = np.array([len(ids)], np.int32)
    face_b = face[None]
    gaps = []
    for seed in EXPORT_SEEDS:
        kernels.LAUNCHES.clear()
        wav, mel_l, y_len = fn(x, x_len, face_b, seed)
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        launches.update(got)
        if got.get(gn_mish.NAME, 0) != K1_PER_EVAL * cfg.timesteps or len(got) != 1:
            raise AssertionError(f"[export {tag}] a loaded call launched {got}")
        ref_wav, ref_mel = synth.synthesize(texts[0], face, seed=seed)
        n = int(y_len[0])
        w = np.clip(wav[0, :n * cfg.hop_len].cpu().numpy(), -1.0, 1.0)
        m = mel_l[0, :, :n].cpu().numpy()
        if w.shape != ref_wav.shape or m.shape != ref_mel.shape:
            raise AssertionError(f"[export {tag}] shapes {w.shape} {m.shape} against "
                                 f"{ref_wav.shape} {ref_mel.shape}")
        gw, gm = float(np.abs(w - ref_wav).max()), float(np.abs(m - ref_mel).max())
        gaps.append({"seed": seed, "wav": gw, "mel": gm, "frames": n,
                     "bitwise": bool(np.array_equal(w, ref_wav) and np.array_equal(m, ref_mel))})
        if not (np.isfinite(w).all() and gw <= 1e-5 and gm <= 5e-4):
            raise AssertionError(f"[export {tag}] seed {seed}: loaded against live wav "
                                 f"{gw:.3e} (bar 1e-5) mel {gm:.3e} (bar 5e-4)")

    def loaded_call():
        wav_, mel_, _ = fn(x, x_len, face_b, EXPORT_SEEDS[0])
        return wav_.cpu(), mel_.cpu()

    def live_call():
        return synth.synthesize(texts[0], face, seed=EXPORT_SEEDS[0])

    loaded_call(), live_call()
    times = {0: [], 1: []}
    for which in EXPORT_TURNS:
        t0 = time.perf_counter()
        (live_call if which else loaded_call)()
        times[which].append((time.perf_counter() - t0) * 1e3)
    return {"pair": (tx, ty), "gaps": gaps, "loaded_ms": times[0], "live_ms": times[1]}


def tooling_phase(smi, texts, face, cmu):
    """Phase 16: (a) the bucket pair the first test sentence lands in, at
    the Config widths (random weights, seed 0): in bf16 exported by
    ``export_bundle`` in the process; in f32 written as a reference-named
    file, migrated by ``python -m facegantts_tpu_torch.migrate_checkpoint``
    (also ``mode=fix-lightning``) and exported by ``python -m
    facegantts_tpu_torch.export`` from the migrated directory; each loaded
    and held to its live Synthesizer (``export_check``); then K1 on the live
    bf16 path called directly and through its registered op in turns; (b)
    ``python -m facegantts_tpu_torch.bench``; (c) ``train()`` with a traced
    window; (d) ``python -m facegantts_tpu_torch.utils.flops``, beside (a)'s
    export.  Raises on a failed check; returns what it measured."""
    import glob
    import re
    import shutil
    import threading

    import torch

    from facegantts_tpu_torch.config import default_config
    from facegantts_tpu_torch.data.dataset import SyntheticDataset
    from facegantts_tpu_torch.export import export_bundle, load_bundle
    from facegantts_tpu_torch.models import unet as unet_mod
    from facegantts_tpu_torch.ops import gn_mish, kernels
    from facegantts_tpu_torch.synthesis import Synthesizer, pick_bucket
    from facegantts_tpu_torch.train.loop import train

    root = os.path.join(ROOT, "runs", "chip_smoke_tooling")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    launches = collections.Counter()
    out = {"export": {}, "seconds": {}}

    # (a) the pair's programs: bf16 exported here while, in the background,
    # the f32 weights go through the migration and export CLIs and the FLOP
    # audit (d) counts; nothing is timed until both are done
    t_part = time.perf_counter()
    synths, overs, pairs = {}, {}, {}
    for bf16 in (1, 0):
        tag = "bf16" if bf16 else "f32"
        overs[tag] = dict(fused_gn_mish=1, use_bf16=bf16, timesteps=10, temperature=8.0)
        synth = Synthesizer(default_config(env={}, overrides=overs[tag]), cmudict=cmu, seed=0,
                            device="cuda")
        ids = synth.encode_text(texts[0])
        _, mel = synth.synthesize(texts[0], face)
        pairs[tag] = (pick_bucket(len(ids), synth.cfg.text_buckets),
                      pick_bucket(mel.shape[1], synth.cfg.mel_buckets))
        synth.cfg = synth.cfg.replace(text_buckets=(pairs[tag][0],),
                                      mel_buckets=(pairs[tag][1],))
        synths[tag] = synth
    bundles = {tag: os.path.join(root, f"bundle_{tag}") for tag in synths}
    ref = os.path.join(root, "reference.pt")
    torch.save({"state_dict": {**{k: v.cpu() for k, v in synths["f32"].model.state_dict().items()},
                               "discriminator.conv.weight": torch.ones(3)}}, ref)
    migrated = os.path.join(root, "migrated")
    tx, ty = pairs["f32"]
    calls = {
        "migrate_checkpoint": [f"src={ref}", f"dst={migrated}", "use_gan=0"],
        "migrate_checkpoint fix-lightning": [f"src={ref}", f"dst={os.path.join(root, 'fixed.ckpt')}",
                                             "mode=fix-lightning"],
        "export": [f"out_dir={bundles['f32']}", f"resume_from={migrated}", f"text_buckets={tx}",
                   f"mel_buckets={ty}", *(f"{k}={v}" for k, v in overs["f32"].items())],
        "utils.flops": []}
    done = {}

    def chain(names):
        for name in names:
            done[name] = run_module([f"facegantts_tpu_torch.{name.split()[0]}", *calls[name]], 600)
            if done[name][0] != 0:
                return

    threads = [threading.Thread(target=chain, args=(names,)) for names in (
        ["migrate_checkpoint", "migrate_checkpoint fix-lightning", "export"], ["utils.flops"])]
    for t in threads:
        t.start()
    try:
        t0 = time.perf_counter()
        export_bundle(synths["bf16"], bundles["bf16"])
        bf16_export_s = time.perf_counter() - t0
    finally:
        for t in threads:
            t.join()
    for name in calls:
        if name not in done or done[name][0] != 0:
            raise AssertionError(f"[cli] {name}: {done.get(name, (None, '', 'not run'))[2][-3000:]}")
    if "pytorch-lightning_version" not in torch.load(os.path.join(root, "fixed.ckpt"),
                                                     weights_only=False):
        raise AssertionError("[cli] fix-lightning wrote no version key")
    for tag, synth in synths.items():
        tx, ty = pairs[tag]
        rec = {f"{name} s": done[name][3] for name in calls if tag == "f32" and name != "utils.flops"}
        rec["export_s"] = bf16_export_s if tag == "bf16" else float(
            re.search(r"exported .* in ([0-9.]+) s", done["export"][1]).group(1))
        t0 = time.perf_counter()
        _, loaded = load_bundle(bundles[tag])
        rec["load_s"] = time.perf_counter() - t0
        rec["bytes"] = os.path.getsize(os.path.join(bundles[tag], f"synth_tx{tx}_ty{ty}.pt2"))
        # as phase 12: f32 with TF32 off and cuDNN's deterministic algorithms,
        # where an f32 result does not depend on the algorithm cuDNN picks
        # (under PyTorch's TF32 defaults two live f32 calls differ in the
        # vocoder); bf16 at PyTorch's defaults
        with cudnn_mode(tf32=tag == "bf16", deterministic=tag == "f32"):
            rec.update(export_check(tag, synth, loaded[(tx, ty)], synth.encode_text(texts[0]),
                                    texts, face, launches))
        out["export"][tag] = rec

    # K1 on the live path (the bf16 request): its checks and the kernel
    # launch called directly, or the registered op, in turns
    synth = synths["bf16"]
    op = torch.ops.facegantts.gn_mish_mask

    def direct(x_, scale, bias, lens, num_groups=8, eps=1e-5):
        gn_mish._check_inputs(x_, scale, bias, lens, num_groups)
        return gn_mish._launch_fwd(x_, scale, bias, lens, num_groups, eps, False)[0]

    def via_op(x_, scale, bias, lens, num_groups=8, eps=1e-5):
        return op(x_, scale, bias, lens, num_groups, eps)

    default = unet_mod.gn_mish_mask
    req = {0: [], 1: []}
    try:
        for which in OP_TURNS:
            unet_mod.gn_mish_mask = via_op if which else direct
            kernels.LAUNCHES.clear()
            t0 = time.perf_counter()
            synth.synthesize(texts[0], face)
            req[which].append((time.perf_counter() - t0) * 1e3)
            got = dict(kernels.LAUNCHES)
            launches.update(got)
            if got.get(gn_mish.NAME, 0) != K1_PER_EVAL * synth.cfg.timesteps:
                raise AssertionError(f"[op] a live request launched {got}")
    finally:
        unet_mod.gn_mish_mask = default
    xs = torch.randn((1, 256, 32, 109), device="cuda", dtype=torch.bfloat16)
    sc, bi = torch.ones(256, device="cuda"), torch.zeros(256, device="cuda")
    ln = torch.full((1,), 100, dtype=torch.int32, device="cuda")
    host = {0: [], 1: []}
    with torch.no_grad():
        for which in OP_HOST_TURNS:
            host[which].append(host_us(lambda: (via_op if which else direct)(xs, sc, bi, ln)))
    out["op"] = {"req_ms": req, "host_us": host}
    del synths, synth
    torch.cuda.empty_cache()
    out["seconds"]["export"] = time.perf_counter() - t_part

    # (b) the bench
    rc, stdout, stderr, bench_s = run_module(["facegantts_tpu_torch.bench"], 900,
                                             {"BENCH_TRAIN": "1"})
    if rc != 0:
        raise AssertionError(f"[bench] exit {rc}: {stderr[-3000:]}")
    lines = [json.loads(ln_) for ln_ in stdout.splitlines() if ln_.startswith("{")]
    metrics = {r["metric"]: r for r in lines}
    if [r["metric"] for r in lines][-1] != "inference_rtf" or set(metrics) != set(BENCH_METRICS):
        raise AssertionError(f"[bench] lines {lines}")
    for r in lines:
        if not (math.isfinite(r["value"]) and r["value"] > 0):
            raise AssertionError(f"[bench] {r}")
    if not 0 < metrics["mfu_parity"]["value"] < 1:
        raise AssertionError(f"[bench] mfu_parity {metrics['mfu_parity']}")
    bench_launches = json.loads(next(ln_ for ln_ in stderr.splitlines()[::-1]
                                     if ln_.startswith("kernel launches: "))[len("kernel launches: "):])
    launches.update(bench_launches)
    out["bench"] = {"lines": lines, "stderr": [ln_ for ln_ in stderr.splitlines() if ln_.strip()
                                               and not ln_.startswith("/") and "arning" not in ln_],
                    "seconds": bench_s, "launches": bench_launches}
    out["seconds"]["bench"] = bench_s

    # (c) a traced window of plain training at the Config widths
    t_part = time.perf_counter()
    trace_dir = os.path.join(root, "trace")
    cfg_p = default_config(env={}, overrides=dict(
        TRAIN_OVERRIDES, eval_interval=0, profile_dir=trace_dir,
        profile_start_step=PROFILE_WINDOW[0], profile_num_steps=PROFILE_WINDOW[1]))
    kernels.LAUNCHES.clear()
    train(cfg_p, os.path.join(root, "train"), sum(PROFILE_WINDOW) + 1,
          SyntheticDataset(n_items=1024, n_mels=cfg_p.n_mels, seed=0),
          SyntheticDataset(n_items=512, n_mels=cfg_p.n_mels, seed=1), device="cuda")
    launches.update(kernels.LAUNCHES)
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"[trace] files {traces}")
    with open(traces[0]) as f:
        text = f.read()
    named = {k: text.count(k) for k in (K1_FWD_KERNEL, K1_BWD_KERNEL, MAS_KERNEL, "train_step")}
    if not all(named.values()):
        raise AssertionError(f"[trace] names in {traces[0]}: {named}")
    out["trace"] = {"file": os.path.relpath(traces[0], ROOT), "bytes": len(text), "named": named,
                    "launches": dict(kernels.LAUNCHES)}
    out["seconds"]["trace"] = time.perf_counter() - t_part

    # (d) the FLOP audit at the bench's shape, run beside (a)
    flops = json.loads(done["utils.flops"][1].strip().splitlines()[-1])
    if not (all(v > 0 for v in flops.values())
            and flops["step_measured"] == flops["step"] - 2 * flops["disc_fake"]):
        raise AssertionError(f"[flops] {flops}")
    out["flops"] = flops
    out["seconds"]["flops (beside the export)"] = done["utils.flops"][3]
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    out["launches"] = launches
    return out


def log_tooling(smi, r):
    """Phase 16's lines from what ``tooling_phase`` returned."""
    for tag, e in r["export"].items():
        cli = "".join(f", {k} {v:.1f}" for k, v in e.items() if k.endswith(" s"))
        log(f"[export {tag}] {smi}: pair {e['pair']}, export {e['export_s']:.1f} s, load "
            f"{e['load_s']:.1f} s, {e['bytes']} bytes{cli}; loaded against live: " + "; ".join(
                f"seed {g['seed']} wav {g['wav']:.3e} mel {g['mel']:.3e} bitwise {g['bitwise']}"
                for g in e["gaps"])
            + f"; warm ms in turns: loaded {statistics.median(e['loaded_ms']):.2f} (all "
            f"{[round(v, 2) for v in e['loaded_ms']]}), live {statistics.median(e['live_ms']):.2f} "
            f"(all {[round(v, 2) for v in e['live_ms']]})")
    op = r["op"]
    log(f"[op] {smi}: warm bf16 request, K1 called directly {statistics.median(op['req_ms'][0]):.2f}"
        f" ms (all {[round(v, 2) for v in op['req_ms'][0]]}), through facegantts::gn_mish_mask "
        f"{statistics.median(op['req_ms'][1]):.2f} ms (all {[round(v, 2) for v in op['req_ms'][1]]}); "
        f"host us a K1 call at (1, 256, 32, 109) bf16, in turns: directly "
        f"{[round(v, 2) for v in op['host_us'][0]]}, through the op "
        f"{[round(v, 2) for v in op['host_us'][1]]}")
    for line in r["bench"]["lines"]:
        log(f"[bench] {json.dumps(line)}")
    for line in r["bench"]["stderr"]:
        log(f"[bench stderr] {line}")
    log(f"[bench] {smi}: {r['bench']['seconds']:.1f} s; launches {r['bench']['launches']}")
    t = r["trace"]
    log(f"[trace] {smi}: {t['file']} ({t['bytes']} bytes) names {t['named']}; launches {t['launches']}")
    f = r["flops"]
    log(f"[flops] {smi}: python -m facegantts_tpu_torch.utils.flops at (128, 436), batch 32: " + ", ".join(
        f"{k} {v / 1e12:.4f}" for k, v in f.items()) + f" TFLOP; step_measured / step "
        f"{f['step_measured'] / f['step']:.4f}: the step reuses the D phase's fake logits, so it "
        f"runs 2 discriminator forwards on the fake ({2 * f['disc_fake'] / 1e12:.4f} TFLOP) fewer "
        f"than the composed count, which counts them as JAX's g_loss_fn(reuse=None) does")
    log(f"[tooling] {smi}: seconds by part " + ", ".join(
        f"{k} {v:.1f}" for k, v in r["seconds"].items()) + f"; launches {dict(r['launches'])}")


def k1_bwd_bf16(shape, gen):
    """K1's backward kernel in bf16 against ``gn_mish_mask_bwd_ref`` at one
    shape (``k1_bwd_case``'s bars: dx 2^-8, dscale and dbias 1e-4 of the
    largest value), its card time, device time alone, the plain version's
    time and the bound (bf16 x and g read, dx written; f32 scale, bias,
    lens, stats in, (B, C, 2) partials out; operations over the f32 rate)."""
    import torch

    from facegantts_tpu_torch.ops.gn_mish import gn_mish_mask_bwd, gn_mish_mask_bwd_ref, group_stats

    b, c, f, t = shape
    lens = [(t - 3, t, t // 2, 1)[i % 4] for i in range(b)]
    err = k1_bwd_case(shape, torch.bfloat16, lens, gen)
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    scale = torch.randn(c, generator=gen, device="cuda") * 6
    bias = torch.randn(c, generator=gen, device="cuda") * 8
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    stats = group_stats(x)
    n = b * c * f * t
    bound_ms, bound_by = bound(3 * n * 2 + 2 * c * 4 + b * 4 + b * 8 * 8 + b * c * 8,
                               n_ops=n * K1_BWD_OPS_PER_ELEM)

    def kern():
        return gn_mish_mask_bwd(g, x, scale, bias, lens_t, stats)

    return {"err": err, "ms": time_ms(kern, iters=20, reps=5),
            "plain_ms": time_ms(lambda: gn_mish_mask_bwd_ref(g, x, scale, bias, lens_t, stats),
                                iters=5, reps=3),
            "dev_us": profiled_us(kern, K1_BWD_KERNEL), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def step_turns(label, steps, batch, state, gen, order, **kw):
    """Steps of ``steps[k]`` in ``order`` on one batch, drawing from
    ``gen``: ms (host clock around the step and a read of its metrics),
    peak bytes, metrics.  The allocator's cache is kept between steps, as
    in a training loop: with it emptied before each step, the f32 plain
    step's turns ranged 228-458 ms on an H100 80GB HBM3 at 700 W, as each
    step allocated its memory anew."""
    import torch

    res = {k: [] for k in steps}
    for k in steps:  # each step function's first call builds its plans
        steps[k](state, batch, gen, **kw)
    for k in order:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        _, m = steps[k](state, batch, gen, **kw)
        m = {n: float(v) for n, v in m.items()}  # synchronises
        ms = (time.perf_counter() - t1) * 1e3
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"[options {label}] {k}: non-finite metrics {m}")
        res[k].append((ms, torch.cuda.max_memory_allocated(), m))
    return res


def warm_ms(rows):
    """The median and every step's ms of ``step_turns`` rows."""
    ms = [r[0] for r in rows]
    return f"{statistics.median(ms):.1f} ms (all {[round(v, 1) for v in ms]})"

def peak_gib(rows):
    """The largest peak of ``step_turns`` rows, GiB."""
    return f"{max(r[1] for r in rows) / 2**30:.2f} GiB"


def plain_bf16_turns(smi, state, batch, cfg16):
    """Phase 13's plain step: ``train_bf16`` 1 against 0 on one batch in
    PLAIN_TURNS, each setting's warm steps, peak memory and one warm step's
    device time and launches, and the kernels behind the difference.  Logs;
    returns the turns' results."""
    import torch

    from facegantts_tpu_torch.train.step import make_plain_train_step

    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = {0: make_plain_train_step(cfg16.replace(train_bf16=0), "cuda")[0],
             1: make_plain_train_step(cfg16, "cuda")[0]}
    res = step_turns("plain", steps, batch, state, gen, PLAIN_TURNS)
    kernels = {}
    for k in (0, 1):
        for _ in range(3):  # the profiler now and then returns no device events
            per, _, count = device_profile(lambda: steps[k](state, batch, gen), n=1)
            if per:
                break
        kernels[k] = per, count
        busy = (f"{sum(per.values()) / 1e3:.1f} ms in {round(sum(count.values()))} kernel "
                f"launches" if per else "not measured")
        log(f"[options plain train_bf16] {smi}: train_bf16={k} in turns {PLAIN_TURNS}, bucket "
            f"{(batch.x.shape[1], batch.y.shape[2])}: {warm_ms(res[k])}, peak "
            f"{peak_gib(res[k])}, total_loss {min(r[2]['total_loss'] for r in res[k]):.4f} to "
            f"{max(r[2]['total_loss'] for r in res[k]):.4f}; one warm step's device busy {busy}")
    (per32, n32), (per16, n16) = kernels[0], kernels[1]
    if per32 and per16:  # where train_bf16's extra device time and launches go
        extra = sorted(set(per32) | set(per16), key=lambda n: per32[n] - per16[n])[:8]
        for name in extra:
            log(f"[options plain train_bf16]   +{(per16[name] - per32[name]) / 1e3:.3f} ms "
                f"({round(n16[name])} vs {round(n32[name])} launches)  {name[:110]}")
    return res


def options_phase(smi):
    """Phase 13: the four training options at the Config widths on
    ``SyntheticDataset`` (seed 0) at batch 64, ``fused_gn_mish=1``, each
    through ``train/loop.train`` for OPT_STEPS steps and one validation
    batch (launches asserted, masters and optimizer state f32), then timed
    in turns on one batch against the setting without it; K1's bf16
    backward at the slice's shapes.  ``adv_grad_through_sampler`` runs in
    micro-batches of ADV_MICRO.  Logs as it goes; returns the launches
    of the loop runs and the K1 bf16 backward results."""
    import torch

    from facegantts_tpu_torch.config import default_config
    from facegantts_tpu_torch.data.dataset import BucketedLoader, SyntheticDataset
    from facegantts_tpu_torch.train.step import (
        _micro_split,
        make_gan_loss_fns,
        make_gan_train_step,
    )

    train_ds = SyntheticDataset(n_items=1024, n_mels=128, seed=0)
    # 160 items of 300-430 frames: one full validation batch, bucket (128, 436)
    val_ds = SyntheticDataset(n_items=160, n_mels=128, seed=1, min_frames=300, max_frames=430)
    work = os.path.join(ROOT, "runs", "chip_smoke_options")
    launches = collections.Counter()
    out = {}

    def loop(label, cfg):
        """``option_run`` under ``cfg``, its launches added to the phase's."""
        res = option_run(label, cfg, work, OPT_STEPS, train_ds, val_ds)
        launches.update(dict(zip(("K1", "K1 bf16", "K1 bwd", "K1 bwd bf16", "MAS"), res[3])))
        return res

    gen = torch.Generator(device="cuda").manual_seed(0)
    # -- the plain step under train_bf16, against f32 -------------------------------
    cfg16 = default_config(env={}, overrides=dict(TRAIN_OVERRIDES, train_bf16=1))
    state, step_ms, peak, got, last = loop("plain train_bf16", cfg16)
    log(f"[options plain train_bf16] {smi}: loop steps {[round(v, 1) for v in step_ms]} ms, "
        f"peak {peak / 2**30:.2f} GiB; launches (K1, bf16, K1 bwd, bf16, MAS) {got}; last "
        + " ".join(f"{k[6:]}={v:.4f}" for k, v in last.items() if k.startswith("train/")))
    batch = next(BucketedLoader(train_ds, cfg16, cfg16.per_gpu_batchsize).epoch(0))
    res = plain_bf16_turns(smi, state, batch, cfg16)
    out["plain"] = res
    del state

    # -- the GAN step under disc_bf16, against f32, R1 on and off -------------------
    gcfg = default_config(env={}, overrides=GAN_OVERRIDES)
    dcfg = gcfg.replace(disc_bf16=1)
    state, step_ms, peak, got, last = loop("disc_bf16", dcfg)
    log(f"[options disc_bf16] {smi}: loop steps {[round(v, 1) for v in step_ms]} ms, peak "
        f"{peak / 2**30:.2f} GiB; launches {got}")
    batch = next(BucketedLoader(train_ds, gcfg, gcfg.per_gpu_batchsize).epoch(0))
    bucket = (batch.x.shape[1], batch.y.shape[2])
    steps = {0: make_gan_train_step(gcfg, "cuda")[0], 1: make_gan_train_step(dcfg, "cuda")[0]}
    for use_r1 in (1, 0):
        res = step_turns("disc_bf16", steps, batch, state, gen, OPT_TURNS, use_r1=bool(use_r1))
        for k in (0, 1):
            log(f"[options disc_bf16] {smi}: disc_bf16={k}, R1 {'on' if use_r1 else 'off'}, in "
                f"turns {OPT_TURNS}, bucket {bucket}: {warm_ms(res[k])}, peak {peak_gib(res[k])}; "
                f"d_loss {[round(r[2]['d_loss'], 4) for r in res[k]]} r1_penalty "
                f"{[round(r[2]['r1_penalty'], 4) for r in res[k]]}")
        out[("disc_bf16", use_r1)] = res
    mb = _micro_split(batch.to("cuda"), gcfg.micro_batch_size)[1][0]
    d_params = list(state.disc.parameters())
    fake = make_gan_loss_fns(gcfg)[0](state.model, mb, gen)
    d_fns = {k: make_gan_loss_fns(c)[1] for k, c in ((0, gcfg), (1, dcfg))}
    for r1 in (1, 0):
        vals = {k: d_fns[k](state.disc, mb.y, fake, bool(r1)) for k in (0, 1)}
        vals = {k: (float(v[0]), float(v[1]["r1_penalty"]), float(v[1]["disc_acc"]))
                for k, v in vals.items()}
        log(f"[options disc_bf16] {smi}: one micro-batch, one state and fake, R1 "
            f"{'on' if r1 else 'off'}: (d_loss, r1_penalty, disc_acc) f32 {vals[0]}, bf16 "
            f"{vals[1]}; relative difference of d_loss "
            f"{abs(vals[1][0] - vals[0][0]) / abs(vals[0][0]):.3e}")
        out[("d_values", r1)] = vals
    order = [(k, r1) for k in OPT_TURNS for r1 in (1, 0)]
    d_ms = time_ms_turns([lambda k=k, r1=r1: torch.autograd.grad(
        d_fns[k](state.disc, mb.y, fake, bool(r1))[0], d_params) for k, r1 in order],
        iters=1, reps=3)
    by = collections.defaultdict(list)
    for (k, r1), v in zip(order, d_ms):
        by[(k, r1)].append(v)
    log(f"[options disc_bf16] {smi}: the D phase of one micro-batch (B={gcfg.micro_batch_size}, "
        f"bucket {bucket}; forwards, loss and gradients), CUDA events, medians of 3 in turns: "
        + ", ".join(f"disc_bf16={k} R1 {'on' if r1 else 'off'} "
                    f"{[round(v, 2) for v in by[(k, r1)]]} ms" for k in (0, 1) for r1 in (1, 0)))
    out["d_phase_ms"] = dict(by)
    for _ in range(3):  # the profiler now and then returns no device events
        prof = device_profile(lambda: steps[1](state, batch, gen, use_r1=True), n=1)
        if prof[0]:
            break
    per, _, count = prof
    if not per:
        log("[options disc_bf16 profile] the profiler saw no device time: not measured")
    else:
        sm80 = {k: v for k, v in per.items() if "sm80" in k}
        log(f"[options disc_bf16 profile] {smi}: one warm disc_bf16=1 R1 step, bucket {bucket}: "
            f"device busy {sum(per.values()) / 1e3:.1f} ms; kernels named sm80: "
            f"{sum(sm80.values()) / 1e3:.2f} ms in {sum(count[k] for k in sm80):.0f} launches")
        for k, v in per.most_common(12):
            log(f"[options disc_bf16 profile]   {v / 1e3:8.3f} ms ({count[k]:.0f}x)  {k[:100]}")
    out["profile"] = prof
    del state, steps, fake, mb, d_params, d_fns

    # -- the GAN step under train_bf16 ------------------------------------------
    state, step_ms, peak, got, last = loop("GAN train_bf16", gcfg.replace(train_bf16=1))
    log(f"[options GAN train_bf16] {smi}: loop steps {[round(v, 1) for v in step_ms]} ms, peak "
        f"{peak / 2**30:.2f} GiB; launches {got}; last " + " ".join(
            f"{k[6:]}={v:.4f}" for k, v in last.items() if k.startswith("train/")
            and k[6:] in ("d_loss", "g_loss", "r1_penalty", "adv_loss", "diffusion_loss")))
    del state

    # -- the GAN step under adv_grad_through_sampler ----------------------------------
    acfg = gcfg.replace(adv_grad_through_sampler=1, micro_batch_size=ADV_MICRO)
    state, step_ms, peak, got, last = loop("adv_grad_through_sampler", acfg)
    log(f"[options adv_grad_through_sampler] {smi}: micro-batches of {ADV_MICRO}, fakes at "
        f"{acfg.train_fake_timesteps} steps; loop steps {[round(v, 1) for v in step_ms]} ms, "
        f"peak {peak / 2**30:.2f} GiB; launches {got}; last " + " ".join(
            f"{k[6:]}={v:.4f}" for k, v in last.items() if k.startswith("train/")
            and k[6:] in ("d_loss", "g_loss", "g_guard_loss", "adv_loss")))
    if last["train/g_guard_loss"] != last["train/g_loss"]:
        raise AssertionError("[options adv_grad_through_sampler] the G gate is not g_loss")
    out["adv"] = (step_ms, peak)
    del state

    # -- the GAN step under grad_remat, against without -----------------------------
    rcfg = gcfg.replace(grad_remat=1)
    state, step_ms, peak, got, last = loop("grad_remat", rcfg)
    log(f"[options grad_remat] {smi}: loop steps {[round(v, 1) for v in step_ms]} ms, peak "
        f"{peak / 2**30:.2f} GiB; launches {got}")
    res = step_turns("grad_remat", {0: make_gan_train_step(gcfg, "cuda")[0],
                                    1: make_gan_train_step(rcfg, "cuda")[0]},
                     batch, state, gen, OPT_TURNS)
    for k in (0, 1):
        log(f"[options grad_remat] {smi}: grad_remat={k} in turns {OPT_TURNS}, bucket {bucket}, "
            f"R1 on: {warm_ms(res[k])}, peak {peak_gib(res[k])}")
    out["remat"] = res
    del state

    # -- K1's bf16 backward at the slice's shapes --------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(13)
    k1 = {}
    for label, shapes in (("plain crop (B=64, 128)", K1_TRAIN), ("GAN (B=16, 436)", K1_GAN_436)):
        for shape, n in shapes:
            r = k1[shape] = k1_bwd_bf16(shape, gen)
            log(f"[options K1 bwd bf16] {shape} {smi}: against gn_mish_mask_bwd_ref "
                f"{r['err']:.3e} of the largest (bars dx 2^-8, dscale and dbias 1e-4); card "
                f"{r['ms'] * 1e3:.1f} us, device only {fmt_us(r['dev_us'])}, plain "
                f"{r['plain_ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.2f} us "
                f"({r['bound_by']}): {bound_share(r['bound_ms'], r['dev_us'])} of it on the device")
        tot = {k: sum(k1[s][k] * n for s, n in shapes) for k in ("ms", "plain_ms", "bound_ms")}
        dev = None if any(k1[s]["dev_us"] is None for s, _ in shapes) else sum(
            k1[s]["dev_us"] * n for s, n in shapes) / 1e3
        log(f"[options K1 bwd bf16] {smi}: one {label} U-Net evaluation's {K1_PER_EVAL} "
            f"backward launches: card {tot['ms']:.3f} ms, device only {fmt_ms(dev)}, plain "
            f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms")
    out["k1_bwd_bf16"] = k1
    out["launches"] = launches
    return out


def _flat_state(obj, prefix=""):
    """Every leaf of a nested state_dict, by path."""
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    else:
        return {prefix: obj}
    out = {}
    for k, v in items:
        out.update(_flat_state(v, f"{prefix}{k}/"))
    return out


def state_mismatches(a, b):
    """The leaves in which two TrainStates differ (bitwise for tensors)."""
    import torch

    bad = [] if a.step == b.step else ["step"]
    for part in ("model", "optimizer", "disc", "disc_optimizer"):
        fa, fb = (_flat_state(getattr(s_, part).state_dict()) for s_ in (a, b))
        if fa.keys() != fb.keys():
            bad.append(f"{part}: keys differ")
            continue
        for k, v in fa.items():
            w = fb[k]
            same = (v.dtype == w.dtype and torch.equal(v.cpu(), w.cpu())
                    if isinstance(v, torch.Tensor) else v == w)
            if not same:
                bad.append(f"{part}/{k}")
    return bad


def _http(port, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


def _pcm_of_wav(data):
    import io
    import wave

    with wave.open(io.BytesIO(data), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def persist_phase(gan, texts, face, cmu):
    """Phase 12: the GAN state phase 8 left saved through ``CheckpointPolicy``
    and restored into a fresh state (bitwise), one step from each, a
    resumed ``train()``, inference and serving from the checkpoint and a
    bshall vocoder file, streaming against one vocoder call.  Every check is
    collected; the phase raises at its end if any failed."""
    import shutil
    import threading

    import torch

    from facegantts_tpu_torch.config import default_config
    from facegantts_tpu_torch.models.hifigan import HiFiGANGenerator
    from facegantts_tpu_torch.ops import gn_mish, kernels, mas
    from facegantts_tpu_torch.serve import SynthesisService, make_server, wav_bytes
    from facegantts_tpu_torch.synthesis import Synthesizer
    from facegantts_tpu_torch.train import checkpoint as ck
    from facegantts_tpu_torch.train.loop import train
    from facegantts_tpu_torch.train.step import init_state, make_gan_train_step

    cfg, state, batch = gan["cfg"], gan["state"], gan["batch"]
    fails, out, launches = [], {}, collections.Counter()
    work = os.path.join(ROOT, "runs", "chip_smoke_persist")
    shutil.rmtree(work, ignore_errors=True)
    step = out["step"] = state.step

    def counted(fn):
        """fn() with the counts zeroed just before and read just after."""
        kernels.LAUNCHES.clear()
        r = fn()
        got = dict(kernels.LAUNCHES)
        launches.update(got)
        return r, got

    # 1. save and restore
    policy = ck.CheckpointPolicy(work, keep_top_k=cfg.keep_top_k, monitor=cfg.checkpoint_monitor,
                                 snapshot_epochs=cfg.snapshot_epochs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    policy.save_step(state, step)
    out["save_ms"] = (time.perf_counter() - t0) * 1e3
    epoch = step // gan["n_batches"]
    t0 = time.perf_counter()
    policy.save_epoch(state, step, epoch, {"total_loss": gan["vals"][-1]["val/total_loss"]})
    out["save_epoch_ms"] = (time.perf_counter() - t0) * 1e3
    out["bytes"] = os.path.getsize(os.path.join(work, "last", str(step), ck.CKPT_FILE))
    out["epoch_files"] = sorted(os.path.relpath(os.path.join(d, f), work)
                                for d, _, fs in os.walk(work) for f in fs)
    fresh = init_state(cfg, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.restore_checkpoint(os.path.join(work, "last"), fresh)
    torch.cuda.synchronize()
    out["restore_ms"] = (time.perf_counter() - t0) * 1e3
    bad = state_mismatches(state, fresh)
    out["restore_bitwise"] = not bad
    if bad:
        fails.append(f"restore not bitwise: {bad[:8]}")

    # 2. one step from each state, the same batch and draws
    train_step, _ = make_gan_train_step(cfg, "cuda")
    metrics, step_ms = {}, {}
    for tag, st in (("saved", state), ("restored", fresh)):
        gen = torch.Generator(device="cuda").manual_seed(11)
        torch.manual_seed(11)  # dropout
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with path_counts() as pc:
            (_, m), got = counted(lambda: train_step(st, batch, gen, use_r1=True))
        metrics[tag] = {k: float(v) for k, v in m.items()}
        step_ms[tag] = (time.perf_counter() - t0) * 1e3
        want = {gn_mish.BWD_NAME: 100, mas.NAME: 4, gn_mish.NAME: 500}
        if any(got.get(k, 0) != n for k, n in want.items()):
            fails.append(f"one step from the {tag} state launched {got}, want {want}")
        if pc.fwd["bfloat16"] or pc.bwd["bfloat16"]:  # the sampler's U-Net computes in f32
            fails.append(f"one step from the {tag} state ran K1 in bf16: forward "
                         f"{dict(pc.fwd)}, backward {dict(pc.bwd)}")
    rel = {k: abs(v - metrics["restored"][k]) / max(abs(v), abs(metrics["restored"][k]), 1e-30)
           for k, v in metrics["saved"].items()}
    out["step_rel"], out["step_ms"], out["step_metrics"] = rel, step_ms, metrics
    if max(rel.values()) > 1e-5:
        fails.append(f"one step: losses differ by more than 1e-5 relative: {rel}")
    out["param_diff"] = max(float((p.detach() - q.detach()).abs().max()) for p, q in zip(
        state.model.parameters(), fresh.model.parameters()))
    del fresh, train_step

    # 3. resume through train()
    t0 = time.perf_counter()
    with path_counts() as pc:
        resumed, got = counted(lambda: train(cfg.replace(resume_from=os.path.join(work, "last")),
                                             work, step + 2, gan["train_ds"], gan["val_ds"],
                                             device="cuda"))
    if pc.fwd["bfloat16"] or pc.bwd["bfloat16"]:
        fails.append(f"resume: K1 ran in bf16: forward {dict(pc.fwd)}, backward {dict(pc.bwd)}")
    out["resume_wall_s"] = time.perf_counter() - t0
    with open(os.path.join(work, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    logged = [r for r in recs if "train/g_loss" in r]
    n_val = sum(int(r["val/batches"]) for r in recs if "val/batches" in r)
    out["resume_steps"] = [r["step"] for r in logged]
    out["resume_step_ms"] = [1e3 / r["train/steps_per_sec"] for r in logged]
    out["resume_launches"] = got
    if resumed.step != step + 2 or out["resume_steps"] != [step + 1, step + 2]:
        fails.append(f"resume: logged steps {out['resume_steps']}, final {resumed.step}")
    if ck.all_steps(os.path.join(work, "last")) != [step + 2]:
        fails.append(f"resume: last/ holds {ck.all_steps(os.path.join(work, 'last'))}")
    want = {gn_mish.BWD_NAME: 200, mas.NAME: 8 + n_val, gn_mish.NAME: 1000 + 125 * n_val}
    if any(got.get(k, 0) != n for k, n in want.items()):
        fails.append(f"resume: launches {got}, want {want}")
    del resumed
    gan.pop("state")
    del state
    torch.cuda.empty_cache()

    # 4. inference from the checkpoint and a bshall vocoder file
    sd = ck.restore_generator_state_dict(os.path.join(work, "last"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        voc = HiFiGANGenerator(in_channels=cfg.n_mels)
    for mod in voc.modules():
        if isinstance(mod, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            torch.nn.utils.weight_norm(mod)
    voc_path = os.path.join(work, "hifigan_bshall.pt")
    torch.save({"generator": {f"module.{k}": v for k, v in voc.state_dict().items()}}, voc_path)
    vsd = ck.load_hifigan_state_dict(voc_path)
    out["precisions"] = {}
    def one_precision(bf16):
        """Steps 4-6 in one precision; returns what they measured."""
        tag = "bf16" if bf16 else "f32"
        r = {}
        icfg = default_config(env={}, overrides=dict(fused_gn_mish=1, use_bf16=bf16, timesteps=10,
                                                     temperature=8.0))
        service = SynthesisService(icfg, state_dict=sd, vocoder_state_dict=vsd, cmudict=cmu,
                                   default_face=face, device="cuda")
        synth = service.synth
        other = Synthesizer(icfg, cmudict=cmu, seed=0, device="cuda")
        before, _ = other.synthesize(texts[0], face, seed=3)
        other.update_params(sd, vsd)
        (wav, mel), got = counted(lambda: synth.synthesize(texts[0], face, seed=3))
        swapped, _ = other.synthesize(texts[0], face, seed=3)
        del other
        r["launches"] = got
        if got.get(gn_mish.NAME, 0) != 250:
            fails.append(f"[{tag}] a request from the checkpoint launched {got}")
        if not np.isfinite(wav).all() or len(wav) != mel.shape[1] * icfg.hop_len:
            fails.append(f"[{tag}] the checkpoint's waveform is not finite or not whole")
        if not np.array_equal(wav, swapped):
            again, _ = synth.synthesize(texts[0], face, seed=3)
            fails.append(f"[{tag}] update_params: max |diff| {np.abs(wav - swapped).max()} "
                         "against a Synthesizer built with the weights (that one against "
                         f"itself: {np.abs(wav - again).max()})")
        if len(before) == len(wav) and np.array_equal(before, wav):
            fails.append(f"[{tag}] the loaded weights changed nothing")
        if not bf16:  # the same request twice, in two other cuDNN settings
            r["repeat_diff"] = {}
            for tf32, det in ((True, False), (False, False)):
                with cudnn_mode(tf32=tf32, deterministic=det):
                    w1, m1 = synth.synthesize(texts[0], face, seed=3)
                    w2, m2 = synth.synthesize(texts[0], face, seed=3)
                r["repeat_diff"][f"tf32={tf32}"] = (float(np.abs(m1 - m2).max()),
                                                    float(np.abs(w1 - w2).max()))
        lat = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            synth.synthesize(texts[0], face, seed=3)
            lat.append((time.perf_counter() - t0) * 1e3)
        r["direct_ms"], r["frames"] = lat, mel.shape[1]

        # 5. streaming: chunks against one call, time to first audio
        gen = torch.Generator(device="cuda").manual_seed(5)
        r["stream"] = {}
        for frames in (256, 872):
            m_ = torch.randn(icfg.n_mels, frames, generator=gen, device="cuda") - 5.0
            with torch.inference_mode():
                full = np.clip(synth.vocoder(m_[None].to(synth.dtype)).float()[0].cpu().numpy(),
                               -1.0, 1.0)
            firsts, totals, fulls, got_wav = [], [], [], None
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                it = synth.stream_vocode(m_)
                chunks = [next(it)]
                firsts.append((time.perf_counter() - t0) * 1e3)
                chunks += list(it)
                totals.append((time.perf_counter() - t0) * 1e3)
                got_wav = np.concatenate(chunks)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.inference_mode():
                    synth.vocoder(m_[None].to(synth.dtype)).float()[0].cpu().numpy()
                fulls.append((time.perf_counter() - t0) * 1e3)
            diff = float(np.abs(got_wav - full).max()) if len(got_wav) == len(full) else None
            r["stream"][frames] = {"first_ms": firsts[1:], "total_ms": totals[1:],
                                   "full_ms": fulls[1:], "chunks": len(chunks), "diff": diff}
            if not bf16:  # the same with PyTorch's default TF32 convolutions
                with cudnn_mode(tf32=True, deterministic=False), torch.inference_mode():
                    full_d = synth.vocoder(m_[None]).float()[0].cpu().numpy().clip(-1.0, 1.0)
                    got_d = np.concatenate(list(synth.stream_vocode(m_)))
                r["stream"][frames]["diff_tf32"] = float(np.abs(got_d - full_d).max())
            bar = 0.0 if tag == "f32" else 0.05
            if diff is None or diff > bar:
                fails.append(f"[{tag}] stream_vocode at {frames} frames: max |diff| {diff} "
                             f"against one call (bar {bar})")

        # 6. serving: HTTP against the direct call
        srv = make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        port = srv.server_address[1]
        try:
            resp, data = _http(port, "GET", "/health")
            health = r["health"] = json.loads(data)
            if health.get("platform") != "gpu" or health.get("device") != \
                    torch.cuda.get_device_name(0):
                fails.append(f"[{tag}] /health says {health}")
            body = {"text": texts[0], "seed": 3}
            (resp, data), got = counted(lambda: _http(port, "POST", "/synthesize", body))
            direct, _ = synth.synthesize(texts[0], service.default_face, seed=3)
            if resp.status != 200 or data != wav_bytes(direct, icfg.sample_rate):
                fails.append(f"[{tag}] /synthesize ({resp.status}) differs from the direct call")
            if got.get(gn_mish.NAME, 0) != 250:
                fails.append(f"[{tag}] a served request launched {got}")
            r["served_launches"] = got
            ref = _pcm_of_wav(data)
            resp, sdata = _http(port, "POST", "/synthesize_stream", body)
            streamed = np.frombuffer(sdata, "<i2")
            tail = synth.vocoder.margin_frames() * icfg.hop_len
            lsb = (int(np.abs(streamed[:-tail].astype(np.int32) - ref[:-tail]).max())
                   if len(streamed) == len(ref) else None)
            r["stream_lsb"] = lsb
            bar = 1 if tag == "f32" else int(0.05 * 32767)
            if resp.status != 200 or resp.getheader("X-Sample-Rate") != str(icfg.sample_rate) \
                    or lsb is None or lsb > bar:
                fails.append(f"[{tag}] /synthesize_stream: status {resp.status}, {len(streamed)} "
                             f"samples for {len(ref)}, max |diff| {lsb} LSB (bar {bar}) away "
                             f"from the last {tail} samples")
            http_ms, direct_ms = [], []
            for i in range(10):  # in turns: http, direct, direct, http, ...
                for kind in (("http", "direct") if i % 2 == 0 else ("direct", "http")):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if kind == "http":
                        _http(port, "POST", "/synthesize", body)
                    else:
                        wav_bytes(synth.synthesize(texts[0], service.default_face, seed=3)[0],
                                  icfg.sample_rate)
                    (http_ms if kind == "http" else direct_ms).append(
                        (time.perf_counter() - t0) * 1e3)
            r["http_ms"], r["http_direct_ms"] = http_ms, direct_ms
        finally:
            srv.shutdown()
            srv.server_close()
            service.close()
            thread.join(timeout=60)
        del service, synth
        torch.cuda.empty_cache()
        return r

    for bf16 in (1, 0):
        # f32 is held exactly: TF32 off and cuDNN's deterministic algorithms,
        # the one setting in which an f32 result does not depend on which
        # algorithm cuDNN picks for a shape; bf16 runs PyTorch's defaults
        with cudnn_mode(tf32=bool(bf16), deterministic=not bf16):
            out["precisions"]["bf16" if bf16 else "f32"] = one_precision(bf16)
    out["launches"] = launches
    out["fails"] = fails
    return out


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
        "dev_us": profiled_us(lambda: maximum_path(value, mask), MAS_KERNEL),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def k1_backward_check(shape, gen):
    """K1's forward and backward kernels (through the autograd Function)
    against autograd of the plain chain, and the backward kernel alone
    against its plain version ``gn_mish_mask_bwd_ref``, one upstream
    gradient for all.  The affine spreads z past both sides of Mish's clamp
    at 20.  Bar: 1e-4 of the largest value (f32 sums in another order)."""
    import torch
    import torch.nn.functional as F

    from facegantts_tpu_torch.ops.gn_mish import (
        gn_mish_mask,
        gn_mish_mask_bwd,
        gn_mish_mask_bwd_ref,
        gn_mish_mask_ref,
        group_stats,
    )

    b, c, f, t = shape
    x = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
    scale = torch.randn(c, generator=gen, device="cuda") * 6
    bias = torch.randn(c, generator=gen, device="cuda") * 8
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

    def rel(got, want):
        return max((g - v).abs().max().item() / max(1.0, v.abs().max().item())
                   for g, v in zip(got, want))

    got, want = run(gn_mish_mask), run(gn_mish_mask_ref)
    stats = group_stats(x)
    kern, plain = gn_mish_mask_bwd(w, x, scale, bias, lens, stats), gn_mish_mask_bwd_ref(
        w, x, scale, bias, lens, stats)
    torch.cuda.synchronize()
    err_y = (got[0] - want[0]).abs().max().item()
    err_g, err_plain = rel(got[1:], want[1:]), rel(kern, plain)
    if not (err_y <= 1e-4 and err_g <= 1e-4 and err_plain <= 1e-4):
        raise AssertionError(f"[K1 bwd] {shape}: forward err {err_y:.3e}, gradients vs autograd "
                             f"{err_g:.3e}, backward kernel vs plain {err_plain:.3e} (bar 1e-4)")
    n = b * c * f * t
    # forward: x in, y out; backward: x and the gradient in, dx out
    bound_ms, bound_by = bound(5 * n * 4, n_ops=n * (K1_OPS_PER_ELEM + K1_BWD_OPS_PER_ELEM))
    # the backward alone: x, g, scale, bias, lens, stats in; dx, (B, C, 2) out
    bwd_bound = bound(3 * n * 4 + 2 * c * 4 + b * 4 + b * 8 * 8 + b * c * 8,
                      n_ops=n * K1_BWD_OPS_PER_ELEM)
    def bwd():
        return gn_mish_mask_bwd(w, x, scale, bias, lens, stats)

    return {
        "err": err_y, "grad_err": err_g, "bwd_err": err_plain,
        "bwd_abs_err": max((g - v).abs().max().item() for g, v in zip(kern, plain)),
        "ms": time_ms(lambda: run(gn_mish_mask), iters=5, reps=3),
        "plain_ms": time_ms(lambda: run(gn_mish_mask_ref), iters=5, reps=3),
        "library_ms": time_ms(lambda: run(library), iters=5, reps=3),
        # device time alone of one forward + backward (every device kernel
        # of the pair, autograd's included), kernels and library
        "dev_us": profiled_us(lambda: run(gn_mish_mask)),
        "library_dev_us": profiled_us(lambda: run(library)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bwd": {"ms": time_ms(bwd, iters=20, reps=5),
                "plain_ms": time_ms(lambda: gn_mish_mask_bwd_ref(w, x, scale, bias, lens, stats),
                                    iters=5, reps=3),
                # the wrapper's device time (the kernel and the sum over b)
                # and the kernel's alone
                "dev_us": profiled_us(bwd), "kernel_dev_us": profiled_us(bwd, K1_BWD_KERNEL),
                "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]},
    }


def ab_phase(texts, face, cmu, fused_synth):
    """``fused_gn_mish`` 0 against 1 in turns (AB_ORDER), in one process on
    one card: warm bf16 request latency (AB_REQUESTS requests of the first
    test sentence, duration cache warm) and training step time and peak
    memory (AB_STEPS steps of a fresh state at the smoke's recipe on the same
    batches).  Returns {setting: {"req_ms", "step_ms" (per turn), "peak"}}."""
    import torch

    from facegantts_tpu_torch.config import default_config
    from facegantts_tpu_torch.data.dataset import BucketedLoader, SyntheticDataset
    from facegantts_tpu_torch.synthesis import Synthesizer
    from facegantts_tpu_torch.train.step import init_state, make_plain_train_step

    plain_cfg = fused_synth.cfg.replace(fused_gn_mish=0)
    synths = {1: fused_synth, 0: Synthesizer(plain_cfg, cmudict=cmu, seed=0, device="cuda")}
    synths[0].synthesize(texts[0], face)  # cuDNN set-up and the duration cache
    ds = SyntheticDataset(n_items=1024, n_mels=plain_cfg.n_mels, seed=0)
    out = {s: {"req_ms": [], "step_ms": [], "peak": []} for s in (0, 1)}
    for fused in AB_ORDER:
        for _ in range(AB_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            synths[fused].synthesize(texts[0], face)
            out[fused]["req_ms"].append((time.perf_counter() - t0) * 1e3)
        cfg = default_config(env={}, overrides=dict(TRAIN_OVERRIDES, fused_gn_mish=fused))
        state = init_state(cfg, "cuda")
        step, _ = make_plain_train_step(cfg, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        batches = BucketedLoader(ds, cfg, cfg.per_gpu_batchsize).epoch(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(AB_STEPS):
            batch = next(batches)
            t0 = time.perf_counter()
            _, metrics = step(state, batch, gen)
            loss = float(metrics["total_loss"])  # synchronises
            times.append((time.perf_counter() - t0) * 1e3)
            if not math.isfinite(loss):
                raise AssertionError(f"[A/B] fused_gn_mish={fused}: non-finite loss")
        out[fused]["step_ms"].append(times)
        out[fused]["peak"].append(torch.cuda.max_memory_allocated())
        del state, step
        torch.cuda.empty_cache()
    return out


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
    p1 = out[probe.P1_NAME]
    p1["bound_ms"], p1["bound_by"] = bound(8 * n1, n_ops=2 * n1)
    # host-bound, and the host's pace drifts within a run: the kernel and
    # the library call in turns, so neither the order nor the drift decides
    p1["ms"], p1["library_ms"] = time_ms_turns(
        [lambda: probe.probe_trivial(x), lambda: torch.add(one, x, alpha=2.0)], reps=15)
    p1["dev_us"] = profiled_us(lambda: probe.probe_trivial(x), P1_KERNEL)
    p1["host_us"] = host_us(lambda: probe.probe_trivial(x))
    p1["library_host_us"] = host_us(lambda: torch.add(one, x, alpha=2.0))
    t_y = v.shape[0]
    out[probe.P2_NAME]["bound_ms"], out[probe.P2_NAME]["bound_by"] = bound(
        8 * v.numel(), n_ops=2 * v.numel(), chain_s=t_y * DEP_STEP_CYCLES / SM_CLOCK_HZ)
    p2 = out[probe.P2_NAME]
    p2["library_ms"] = None
    p2["dev_us"] = profiled_us(lambda: probe.probe_dp_loop(v), P2_KERNEL)
    # the kernel's device time in SM cycles at the maximum clock, a column
    p2["cycles_per_col"] = None if p2["dev_us"] is None else p2["dev_us"] * 1e-6 * SM_CLOCK_HZ / t_y
    return out


def k1_bwd_case(shape, dtype, lens, gen, offset=False):
    """The K1 backward kernel alone against ``gn_mish_mask_bwd_ref`` on one
    input (x and g views at an odd offset if ``offset``: element copies).
    Bars, of the largest value: f32 1e-4 (sums in another order); bf16
    dscale and dbias 1e-4 (f32 sums of the same values), dx 2^-8 (one bf16
    rounding of an f32 result).  Returns the largest relative error."""
    import torch

    from facegantts_tpu_torch.ops import kernels
    from facegantts_tpu_torch.ops.gn_mish import (
        BWD_NAME,
        gn_mish_mask_bwd,
        gn_mish_mask_bwd_ref,
        group_stats,
    )

    b, c, f, t = shape

    def tensor(sd, shift):
        v = (torch.randn(shape, generator=gen, device="cuda") * sd + shift).to(dtype)
        if offset:
            v = torch.empty(v.numel() + 1, dtype=dtype, device="cuda")[1:].view(shape).copy_(v)
        return v

    x, g = tensor(2.0, 0.5), tensor(1.0, 0.0)
    scale = torch.randn(c, generator=gen, device="cuda") * 6
    bias = torch.randn(c, generator=gen, device="cuda") * 8
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    stats = group_stats(x)
    before = kernels.LAUNCHES[BWD_NAME]
    got = gn_mish_mask_bwd(g, x, scale, bias, lens_t, stats)
    want = gn_mish_mask_bwd_ref(g, x, scale, bias, lens_t, stats)
    torch.cuda.synchronize()
    if kernels.LAUNCHES[BWD_NAME] != before + 1:
        raise AssertionError(f"[K1 bwd edges] {shape}: no kernel launch")
    worst = 0.0
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        a, w = a.float(), w.float()
        rel = (a - w).abs().max().item() / max(1.0, w.abs().max().item())
        bar = 2.0 ** -8 if (dtype == torch.bfloat16 and name == "dx") else 1e-4
        if not (torch.isfinite(a).all() and rel <= bar):
            raise AssertionError(f"[K1 bwd edges] {shape} {dtype} lens {lens} offset {offset}: "
                                 f"{name} off by {rel:.3e} of the largest (bar {bar:.1e})")
        worst = max(worst, rel)
    return worst


def k1_bwd_edge_checks(gen):
    """The backward kernel where its units and channels fall unevenly: T of
    1, 3, 32 and 109, lengths 0, 1 and T, views at an odd offset, and the
    streaming 872-frame slab at batch 1, in f32 and bf16.  Returns the
    number of cases and the largest relative error by dtype."""
    import torch

    worst, n = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        errs = []
        for t in (1, 3, 32, 109):
            for shape in ((2, 16, 8, t), (3, 64, 32, t)):
                b = shape[0]
                for lens in ([0] * b, [1] * b, [t] * b, [0, t, 1][:b]):
                    errs.append(k1_bwd_case(shape, dtype, lens, gen))
                errs.append(k1_bwd_case(shape, dtype, [t, 1, t // 2][:b], gen, offset=True))
        errs.append(k1_bwd_case((1, 64, 128, 872), dtype, [800], gen))
        errs.append(k1_bwd_case((2, 64, 128, 436), dtype, [0, 436], gen, offset=True))
        worst[str(dtype)[6:]] = max(errs)
        n += len(errs)
    return n, worst


def p2_shape_checks(gen):
    """P2 exactly equal to its plain version (NaN where it has NaN) at every
    (T_y, B, T_x) of P2_SHAPES and with a NaN in the input; returns the
    number of cases."""
    import torch

    from facegantts_tpu_torch import probe

    def same(got, want):
        nan = want.isnan()
        return torch.equal(got.isnan(), nan) and torch.equal(
            torch.where(nan, 0.0, got), torch.where(nan, 0.0, want))

    cases = [(shape, None) for shape in P2_SHAPES]
    cases += [((40, 8, t_x), where) for t_x, where in ((128, (3, 2, 127)), (100, (0, 0, 99)),
                                                       (33, (10, 5, 7)))]
    for shape, where in cases:
        v = torch.randn(shape, generator=gen, device="cuda")
        if where is not None:
            v[where] = float("nan")
        got, want = probe.probe_dp_loop(v), probe.probe_dp_loop_ref(v)
        torch.cuda.synchronize()
        if not same(got, want):
            raise AssertionError(f"[P2] {shape} (NaN at {where}): kernel and plain version differ")
    return len(cases)


def load_old_k1(src_dir, proc, so_path):
    """The earlier K1 (``gn_mish.py`` and ``gn_mish.cu`` in ``src_dir``, a
    git-ignored copy) as a module of its own on its own library, built by
    ``proc``; its launches count in a counter of its own."""
    import ctypes
    import importlib.util
    import types

    log_text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"the earlier gn_mish.cu did not build:\n{log_text}")
    spec = importlib.util.spec_from_file_location("earlier_gn_mish",
                                                  os.path.join(src_dir, "gn_mish.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(so_path)
    mod.kernels = types.SimpleNamespace(library=lambda name: lib,
                                        LAUNCHES=collections.Counter())
    return mod


def k1_bwd_alt_plan(x):
    """Where this backward streams a slab in tiles although one block's
    shared memory would hold its rows whole (one block an SM instead of
    two), that whole-slab launch, for the turns; else None.  Returns
    (label, plan)."""
    from facegantts_tpu_torch.ops import gn_mish

    plan = gn_mish._plan(x, 8, True)
    elem = x.element_size()
    smem = gn_mish._smem_bytes(x.shape, 8, elem, True, plan.rpb, plan.rpb)
    if plan.rpt == plan.rpb or smem > gn_mish._MAX_SMEM:
        return None
    return "the slab whole at one block an SM", gn_mish._Plan(
        x.shape, 8, int(elem == 2), plan.vec, plan.cluster, plan.rpb, plan.rpb, smem, 0)


def k1_bwd_turns(old, shape, gen):
    """The earlier backward kernel and this one at one shape, f32, on the
    same inputs: both against the plain version (1e-4 of the largest), card
    times in turns (old, new per repetition), and device times alone in the
    order old, new, new, old (the wrapper's, kernel and sum over b).  Where
    this kernel has another launch (``k1_bwd_alt_plan``), that launch joins
    the turns ("alt")."""
    import torch

    from facegantts_tpu_torch.ops import gn_mish

    b, c, f, t = shape
    x = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
    scale = torch.randn(c, generator=gen, device="cuda") * 6
    bias = torch.randn(c, generator=gen, device="cuda") * 8
    lens = torch.tensor([(t - 3, t, t // 2, 1)[i % 4] for i in range(b)], dtype=torch.int32,
                        device="cuda")
    w = torch.randn(shape, generator=gen, device="cuda")
    stats = gn_mish.group_stats(x)
    fns = [lambda m=m: m.gn_mish_mask_bwd(w, x, scale, bias, lens, stats) for m in (old, gn_mish)]
    alt = k1_bwd_alt_plan(x)
    if alt is not None:
        alt_label, alt_plan = alt
        key = (tuple(x.shape), 8, x.dtype, True, x.device)

        def alt_fn():
            own = gn_mish._plans[key]
            gn_mish._plans[key] = alt_plan
            try:
                return gn_mish.gn_mish_mask_bwd(w, x, scale, bias, lens, stats)
            finally:
                gn_mish._plans[key] = own

        fns.append(alt_fn)
    want = gn_mish.gn_mish_mask_bwd_ref(w, x, scale, bias, lens, stats)
    for label, fn in zip(("earlier", "new", "alt"), fns):
        got = fn()
        torch.cuda.synchronize()
        rel = max((a - v).abs().max().item() / max(1.0, v.abs().max().item())
                  for a, v in zip(got, want))
        if not rel <= 1e-4:
            raise AssertionError(f"[K1 bwd turns] {shape}: {label} kernel off by {rel:.3e}")
    card = time_ms_turns(fns, iters=20, reps=7)
    dev = [profiled_us(fns[i]) for i in (0, 1, 1, 0)]
    out = {"old_ms": card[0], "new_ms": card[1], "old_dev_us": (dev[0], dev[3]),
           "new_dev_us": (dev[1], dev[2])}
    if alt is not None:
        out["alt"], out["alt_ms"], out["alt_dev_us"] = alt_label, card[2], profiled_us(fns[2])
    return out


def fmt_us(v):
    return "not measured" if v is None else f"{v:.1f} us"


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.3f} ms"


def bound_share(bound_ms, us):
    """The bound over a measured time, as a percentage."""
    return "not measured" if us is None else f"{100 * bound_ms * 1e3 / us:.1f} %"


def eval_sums(results, counts):
    """Device ms of one U-Net evaluation's K1 backward launches from the
    per-shape ``k1_backward_check`` results: the wrapper's backward, its
    kernel alone, and the forward + backward pair of kernels and of the
    library; None where a shape was not measured."""
    picks = {"bwd": lambda r: r["bwd"]["dev_us"], "kernel": lambda r: r["bwd"]["kernel_dev_us"],
             "pair": lambda r: r["dev_us"], "library": lambda r: r["library_dev_us"]}
    out = {}
    for k, pick in picks.items():
        vals = [pick(r) for r in results]
        out[k] = None if None in vals else sum(v * n for v, n in zip(vals, counts)) / 1e3
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    # --old-k1=DIR: an earlier gn_mish.py and gn_mish.cu (a git-ignored copy)
    # whose backward is timed against this one in turns (phase 11)
    old_k1 = next((a.split("=", 1)[1] for a in args if a.startswith("--old-k1=")), None)
    # --old-step=FILE: an earlier train/step.py (a git-ignored copy) whose
    # no-grad GAN sampler is timed against this one in turns (phase 8)
    old_step = next((a.split("=", 1)[1] for a in args if a.startswith("--old-step=")), None)
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
    t_script = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[setup] {smi}")
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"[setup] device {name} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    old_build = None
    if old_k1:  # built beside the port's kernels, at the same time
        old_so = os.path.join(os.path.abspath(old_k1), "libgn_mish_earlier.so")
        old_build = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", old_so,
             os.path.join(old_k1, "gn_mish.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = kernels.build()
    log(f"[setup] built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for k, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[setup] {k} ptxas: {line.strip()}")

    # ---- 2. the main path at full width -------------------------------------
    log(f"[time] phase 2 starts {time.perf_counter() - t_script:.1f} s into the script")
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

    # ---- 3. fused_gn_mish 0 against 1, in turns --------------------------------
    log(f"[time] phase 3 starts {time.perf_counter() - t_script:.1f} s into the script")
    ab = ab_phase(texts, face, cmu, synths[1])
    for fused in (0, 1):
        r = ab[fused]
        warm_steps = [ms for turn in r["step_ms"] for ms in turn[1:]]
        log(f"[A/B] fused_gn_mish={fused}: warm bf16 request median "
            f"{statistics.median(r['req_ms']):.1f} ms (all {[round(v, 1) for v in r['req_ms']]}); "
            f"training step median {statistics.median(warm_steps):.1f} ms over steps 2-{AB_STEPS} "
            f"of each turn (all {[[round(v, 1) for v in t] for t in r['step_ms']]}); peak memory "
            f"{[round(p / 2**30, 2) for p in r['peak']]} GiB")

    # ---- 4. K1 against its plain version ---------------------------------------
    log(f"[time] phase 4 starts {time.perf_counter() - t_script:.1f} s into the script")
    gen = torch.Generator(device="cuda").manual_seed(0)
    eval_shapes = {s for s, _ in K1_EVAL_436}
    shapes = set(eval_shapes)
    shapes |= {(4, *s[1:]) for s, _ in K1_EVAL_436}
    shapes |= {s for s, _ in K1_EVAL_872}
    shapes |= {s for s, _ in seen}
    for shape in sorted(shapes):  # the launch plan each shape gets (cluster, rows, tiles)
        for dtype in (torch.float32, torch.bfloat16):
            p = gn_mish._plan(torch.empty(shape, dtype=dtype, device="cuda"), 8, False)
            log(f"[K1 plan] {shape} {str(dtype)[6:]}: {8 * shape[0]} clusters of {p.cluster}, "
                f"{p.rpb} rows a block in tiles of {p.rpt} ({-(-p.rpb // p.rpt)} tile(s)), "
                f"{p.smem} B shared, bulk copies {bool(p.vec)}; the card holds {p.active} such "
                f"clusters at once")
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
    for ty, eval_shapes_n in ((436, K1_EVAL_436), (872, K1_EVAL_872)):
        for dtype in (torch.float32, torch.bfloat16):
            tot = {k: sum(results[(s, dtype)][k] * n for s, n in eval_shapes_n)
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
            per_eval[(ty, dtype)] = tot
            dev = {}
            for k in ("dev_us", "plain_dev_us", "library_dev_us"):
                vals = [(results[(s, dtype)].get(k), n) for s, n in eval_shapes_n]
                dev[k] = None if any(v is None for v, _ in vals) else sum(v * n for v, n in vals)
            log(f"[K1] one U-Net eval at Ty={ty}, B=1, {str(dtype)[6:]} ({K1_PER_EVAL} launches): "
                f"kernel {tot['ms'] * 1e3:.1f} us plain {tot['plain_ms'] * 1e3:.1f} us "
                f"library {tot['library_ms'] * 1e3:.1f} us bound {tot['bound_ms'] * 1e3:.1f} us | "
                f"device only: kernel {fmt_us(dev['dev_us'])} plain {fmt_us(dev['plain_dev_us'])} "
                f"library {fmt_us(dev['library_dev_us'])}")

    # ---- 5. kernel vs plain chain through the whole decoder -----------------
    log(f"[time] phase 5 starts {time.perf_counter() - t_script:.1f} s into the script")
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

    # ---- 6. where one request's time goes (bf16, duration cache warm) ---------
    log(f"[time] phase 6 starts {time.perf_counter() - t_script:.1f} s into the script")
    synth = synths[1]
    for _ in range(3):  # the profiler now and then returns no device events
        kernels.LAUNCHES.clear()
        per, wall, count = device_profile(lambda: synth.synthesize(texts[0], face), n=3)
        calls = kernels.LAUNCHES[gn_mish.NAME] / 4  # the warm-up call and 3 profiled runs
        busy = sum(per.values())
        if busy:
            break
    if busy == 0:
        log("[profile] the profiler saw no device time: not measured")
    else:
        k1 = kernel_sum(per, K1_FWD_KERNEL)
        k1_kernels = {k: n for k, n in count.items()
                      if any(s in k for s in ("gn_mish", "gn_stats", "gn_apply"))}
        plain_wall = latency[("bf16", 2)] * 1e3  # same request, unprofiled
        log(f"[profile] bf16 request (text 0, cached): device busy {busy / 1e3:.1f} ms of "
            f"{plain_wall / 1e3:.1f} ms unprofiled wall ({100 * busy / plain_wall:.1f}% busy, "
            f"{100 - 100 * busy / plain_wall:.1f}% idle; {wall / 1e3:.1f} ms under the profiler); "
            f"K1 {k1 / 1e3:.2f} ms ({100 * k1 / busy:.1f}% of device time)")
        log(f"[profile] K1: {calls:.0f} wrapper calls a request; its device kernels a "
            f"request: {k1_kernels}")
        # one launch per K1 call: the forward kernel and nothing else
        if set(k1_kernels) != {k for k in k1_kernels if K1_FWD_KERNEL in k} or \
                kernel_sum(count, K1_FWD_KERNEL) != calls:
            raise AssertionError(f"[profile] K1 calls {calls} but device kernels {k1_kernels}")
        for k, v in per.most_common(10):
            log(f"[profile]   {v / 1e3:8.3f} ms  {k[:110]}")

    # ---- 7. the training path at full width ----------------------------------
    log(f"[time] phase 7 starts {time.perf_counter() - t_script:.1f} s into the script")
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
    per, wall, shape, count = train_profile(cfg_t, tr["state"])
    busy = sum(per.values())
    if busy == 0:
        log("[train profile] the profiler saw no device time: not measured")
    else:
        k1, k1_bwd = kernel_sum(per, K1_FWD_KERNEL), kernel_sum(per, K1_BWD_KERNEL)
        mas_us = kernel_sum(per, MAS_KERNEL)
        if not mas_us > 0:
            raise AssertionError(f"[train profile] no device time under {MAS_KERNEL!r}: the MAS "
                                 f"kernel was renamed or not launched ({sorted(per)[:8]} ...)")
        log(f"[train profile] one warm step, (text, mel) bucket {shape}: device busy "
            f"{busy / 1e3:.1f} ms of {wall:.1f} ms unprofiled wall ({100 * busy / 1e3 / wall:.1f}% "
            f"busy); K1 forward {k1 / 1e3:.2f} ms ({kernel_sum(count, K1_FWD_KERNEL):.0f} "
            f"launches), K1 backward {k1_bwd / 1e3:.2f} ms ({kernel_sum(count, K1_BWD_KERNEL):.0f} "
            f"launches), MAS {mas_us / 1e3:.3f} ms ({kernel_sum(count, MAS_KERNEL):.0f} launches)")
        for k, v in per.most_common(12):
            log(f"[train profile]   {v / 1e3:8.3f} ms  {k[:110]}")
    del tr["state"]

    # ---- 8. GAN training at full width ------------------------------------------
    log(f"[time] phase 8 starts {time.perf_counter() - t_script:.1f} s into the script")
    gan = gan_phase(os.path.join(ROOT, "runs", "chip_smoke_gan"), old_step)
    cfg_g = gan["cfg"]
    for r, ms in zip(gan["steps"], gan["step_ms"]):
        log(f"[GAN] step {r['step']} (R1 on): {ms:.1f} ms " + " ".join(
            f"{k[6:]}={v:.4f}" for k, v in r.items() if k.startswith("train/")
            and k != "train/steps_per_sec"))
    for r in gan["vals"]:
        log(f"[GAN] val after step {r['step']}: " + " ".join(
            f"{k[4:]}={v:.4f}" for k, v in r.items() if k.startswith("val/")))
    log(f"[GAN] {smi}: batch {cfg_g.per_gpu_batchsize} in micro-batches of "
        f"{cfg_g.micro_batch_size}, {cfg_g.disc_loss_type} loss, R1 gamma {cfg_g.r1_gamma} every "
        f"step, fake sampler bf16 at {cfg_g.train_fake_timesteps} steps, G phase at full length, "
        f"disc {cfg_g.disc_base_channels}x{cfg_g.disc_num_layers} ({cfg_g.kernel_height}, "
        f"{cfg_g.kernel_width}); (text, mel) buckets of the steps {gan['buckets']}; "
        f"{gan['n_val']} validation batches")
    log(f"[GAN] {smi}: loop steps 1-{GAN_STEPS} (R1 on): first {gan['step_ms'][0]:.1f} ms, then "
        f"{[round(v, 1) for v in gan['step_ms'][1:]]} ms; peak memory "
        f"{gan['peak_bytes'] / 2**30:.2f} GiB; {gan['wall_s']:.1f} s with validation; launches "
        f"{gan['launches']}, K1 by dtype {gan['dtypes']}")
    for use_r1 in (1, 0):
        ts = gan["turns"][use_r1]
        log(f"[GAN] {smi}: bucket {gan['turn_bucket']}, R1 {'on' if use_r1 else 'off'} in turns "
            f"{GAN_TURNS}: first {ts[0]:.1f} ms, warm {statistics.median(ts[1:]):.1f} ms (all "
            f"{[round(v, 1) for v in ts]}); peak memory "
            f"{[round(v / 2**30, 2) for v in gan['peaks'][use_r1]]} GiB")
    log(f"[GAN] one step's launches (counted alone, asserted): {gan['step_launches']}")
    log(f"[GAN] {smi}: one micro-batch (B={cfg_g.micro_batch_size}) of bucket "
        f"{gan['turn_bucket']} by part, warm, CUDA events, median of 3 in turns: " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in gan["parts_ms"].items()))
    st = gan["sampler_turns"]
    if st is None:
        log("[GAN sampler turns] not measured: no --old-step=FILE (an earlier train/step.py) given")
    else:
        for tag in ("earlier", "new"):
            r = st[tag]
            log(f"[GAN sampler turns] {smi}: {tag} sample_fake, one micro-batch (B="
                f"{cfg_g.micro_batch_size}) of bucket {gan['turn_bucket']}: card "
                f"{[round(v, 1) for v in r['ms']]} ms in turns (earlier, new, new, earlier; 3 "
                f"calls a turn), median {statistics.median(r['ms']):.1f} ms; profiled: device "
                f"{r['device_ms']:.2f} ms in {r['launches']:.0f} launches ("
                + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(r["parts"].items()))
                + f"), wall {r['wall_ms']:.1f} ms; K1 calls by dtype {r['k1_dtypes']}")
        log(f"[GAN sampler turns] the two fakes differ by at most {st['fake_diff']:.3e} "
            f"(largest |value| {st['fake_max']:.1f}), {st['fake_diff_both']} on the frames both "
            f"cover; frames covered an item: earlier {st['frames']['earlier']}, new "
            f"{st['frames']['new']}")
    d_fwd = disc_forward_flops(cfg_g, cfg_g.micro_batch_size, cfg_g.n_mels, gan["turn_bucket"][1])
    d_off, d_on = gan["parts_ms"]["D phase, R1 off"], gan["parts_ms"]["D phase, R1 on"]
    log(f"[GAN] {smi}: one discriminator forward on the micro-batch: {d_fwd / 1e12:.3f} TFLOP; "
        f"the D phase without R1 (two forwards and their backward, counted as 6 forwards) "
        f"runs at {6 * d_fwd / d_off / 1e9:.1f} TFLOP/s; R1 adds {d_on - d_off:.1f} ms "
        f"({(d_on - d_off) / d_off * 6:.1f} forwards' worth at that rate)")
    for kernel in GAN_PATH_KERNELS:
        if not gan["launches"].get(kernel):
            raise AssertionError(f"kernel {kernel} never launched on the GAN path")
    per, prof_wall, count = gan["profiles"][1]
    busy = sum(per.values())
    warm_r1 = statistics.median(gan["turns"][1][1:])
    if busy == 0:
        log("[GAN profile] the profiler saw no device time: not measured")
    else:
        k1, k1_bwd = kernel_sum(per, K1_FWD_KERNEL), kernel_sum(per, K1_BWD_KERNEL)
        mas_us = kernel_sum(per, MAS_KERNEL)
        log(f"[GAN profile] {smi}: one warm R1 step, bucket {gan['turn_bucket']}: device busy "
            f"{busy / 1e3:.1f} ms of {warm_r1:.1f} ms unprofiled wall "
            f"({100 * busy / 1e3 / warm_r1:.1f}% busy; {prof_wall / 1e3:.1f} ms under the "
            f"profiler); K1 forward {k1 / 1e3:.2f} ms ({kernel_sum(count, K1_FWD_KERNEL):.0f} "
            f"launches), K1 backward {k1_bwd / 1e3:.2f} ms "
            f"({kernel_sum(count, K1_BWD_KERNEL):.0f} launches), MAS {mas_us / 1e3:.3f} ms "
            f"({kernel_sum(count, MAS_KERNEL):.0f} launches)")
        for k, v in per.most_common(15):
            log(f"[GAN profile]   {v / 1e3:8.3f} ms  {k[:110]}")
        per0, _, count0 = gan["profiles"][0]
        if per0:
            extra = collections.Counter({k: v - per0.get(k, 0.0) for k, v in per.items()})
            log(f"[GAN profile] {smi}: one warm step without R1: device busy "
                f"{sum(per0.values()) / 1e3:.1f} ms; the kernels R1 adds most to:")
            for k, v in extra.most_common(6):
                log(f"[GAN profile]   +{v / 1e3:8.3f} ms  ({count[k]:.0f} launches with R1, "
                    f"{count0.get(k, 0):.0f} without)  {k[:100]}")

    # K1 and MAS against their plain versions at the GAN path's shapes
    gen = torch.Generator(device="cuda").manual_seed(2)
    gan_checks = {}
    with strict_f32():
        for shape, _ in K1_GAN_436:  # the sampler's forwards: f32 (train/precision.py)
            p = gn_mish._plan(torch.empty(shape, device="cuda"), 8, False)
            r = gan_checks[("k1", shape)] = k1_check(shape, torch.float32, gen)
            log(f"[GAN K1] {shape} f32 forward: max_abs_err {r['err']:.3e} (bar 1e-4); "
                f"kernel {r['ms'] * 1e3:.1f} us plain {r['plain_ms'] * 1e3:.1f} us library "
                f"{r['library_ms'] * 1e3:.1f} us bound {r['bound_ms'] * 1e3:.2f} us; plan: "
                f"{8 * shape[0]} clusters of {p.cluster}, {p.rpb} rows a block in tiles of {p.rpt}")
        for shape in [s for s, _ in K1_GAN_436] + [K1_GAN_872[0][0]]:
            r = gan_checks[("k1_bwd", shape)] = k1_backward_check(shape, gen)
            log(f"[GAN K1 bwd] {shape} f32 through the autograd Function: forward max_abs_err "
                f"{r['err']:.3e}, gradients vs autograd {r['grad_err']:.3e} and backward kernel vs "
                f"gn_mish_mask_bwd_ref {r['bwd_err']:.3e} of the largest (bar 1e-4); forward + "
                f"backward: kernel {r['ms'] * 1e3:.1f} us plain {r['plain_ms'] * 1e3:.1f} us "
                f"library {r['library_ms'] * 1e3:.1f} us bound {r['bound_ms'] * 1e3:.2f} us; "
                f"backward alone: kernel {r['bwd']['ms'] * 1e3:.1f} us plain "
                f"{r['bwd']['plain_ms'] * 1e3:.1f} us bound {r['bwd']['bound_ms'] * 1e3:.2f} us")
            log(f"[GAN K1 bwd] {shape} {smi}: device only: backward {fmt_us(r['bwd']['dev_us'])} "
                f"(kernel {fmt_us(r['bwd']['kernel_dev_us'])}, the rest the sum over b), "
                f"{bound_share(r['bwd']['bound_ms'], r['bwd']['dev_us'])} of its bound; forward + "
                f"backward through backward(): kernels {fmt_us(r['dev_us'])}, library "
                f"{fmt_us(r['library_dev_us'])}")
        mas_cases = [("the GAN step's log-prior", gan.pop("mas_inputs"))]
        mas_cases += [("ragged random", mas_inputs(shape, gen)) for shape in MAS_GAN_SHAPES]
        for label, (value, mask) in mas_cases:
            r = gan_checks[("mas", label, tuple(value.shape))] = mas_check(value, mask)
            log(f"[GAN MAS] {label} {tuple(value.shape)}: paths exactly equal; kernel "
                f"{r['ms'] * 1e3:.1f} us (device only {fmt_us(r['dev_us'])}) plain "
                f"{r['plain_ms'] * 1e3:.1f} us bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
        del mas_cases
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    g_fwd = {k: sum(gan_checks[("k1", s)][k] * n for s, n in K1_GAN_436) for k in keys}
    g_both = {k: sum(gan_checks[("k1_bwd", s)][k] * n for s, n in K1_GAN_436) for k in keys}
    g_bwd = {k: sum(gan_checks[("k1_bwd", s)]["bwd"][k] * n for s, n in K1_GAN_436)
             for k in keys[:2] + keys[3:]}
    g_dev = eval_sums([gan_checks[("k1_bwd", s)] for s, _ in K1_GAN_436],
                      [n for _, n in K1_GAN_436])
    log(f"[GAN K1] {smi}: one U-Net evaluation at Ty=436, B=16 ({K1_PER_EVAL} launches): "
        f"f32 forward (the sampler's) kernel {g_fwd['ms']:.3f} ms plain {g_fwd['plain_ms']:.3f} "
        f"ms library {g_fwd['library_ms']:.3f} ms bound {g_fwd['bound_ms']:.3f} ms; f32 forward + "
        f"backward (the G phase's) kernel {g_both['ms']:.3f} ms plain {g_both['plain_ms']:.3f} ms "
        f"library {g_both['library_ms']:.3f} ms bound {g_both['bound_ms']:.3f} ms; backward "
        f"kernel alone {g_bwd['ms']:.3f} ms plain {g_bwd['plain_ms']:.3f} ms bound "
        f"{g_bwd['bound_ms']:.3f} ms")
    log(f"[GAN K1] {smi}: the same eval, device only: backward {fmt_ms(g_dev['bwd'])} (kernel "
        f"{fmt_ms(g_dev['kernel'])}); forward + backward through backward(): kernels "
        f"{fmt_ms(g_dev['pair'])}, library {fmt_ms(g_dev['library'])}")

    # ---- 9. FusedGroupNorm (K2's only consumer) and the probe (P1, P2) ---------
    log(f"[time] phase 9 starts {time.perf_counter() - t_script:.1f} s into the script")
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

    # ---- 10. the kernels against their plain versions ---------------------------
    log(f"[time] phase 10 starts {time.perf_counter() - t_script:.1f} s into the script")
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
                f"{r['ms'] * 1e3:.1f} us (device only {fmt_us(r['dev_us'])}) plain "
                f"{r['plain_ms'] * 1e3:.1f} us bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
        del mas_cases
        for shape, _ in K1_BWD_SHAPES:  # the backward's launch plans
            p = gn_mish._plan(torch.empty(shape, device="cuda"), 8, True)
            log(f"[K1 bwd plan] {shape} f32: {8 * shape[0]} clusters of {p.cluster}, {p.rpb} rows "
                f"a block in tiles of {p.rpt}, {p.smem} B shared, bulk copies {bool(p.vec)}; the "
                f"card holds {p.active} such clusters at once")
        for shape, _ in K1_TRAIN:
            r = checks[("k1_bwd", shape)] = k1_backward_check(shape, gen)
            log(f"[K1 bwd] {shape} f32: forward max_abs_err {r['err']:.3e}, gradients vs "
                f"autograd {r['grad_err']:.3e} and backward kernel vs gn_mish_mask_bwd_ref "
                f"{r['bwd_err']:.3e} of the largest (bar 1e-4); forward + backward: kernel "
                f"{r['ms'] * 1e3:.1f} us plain {r['plain_ms'] * 1e3:.1f} us library "
                f"{r['library_ms'] * 1e3:.1f} us bound {r['bound_ms'] * 1e3:.2f} us; backward "
                f"alone: kernel {r['bwd']['ms'] * 1e3:.1f} us plain "
                f"{r['bwd']['plain_ms'] * 1e3:.1f} us bound {r['bwd']['bound_ms'] * 1e3:.2f} us")
            log(f"[K1 bwd] {shape} {smi}: device only: backward {fmt_us(r['bwd']['dev_us'])} "
                f"(kernel {fmt_us(r['bwd']['kernel_dev_us'])}, the rest the sum over b), "
                f"{bound_share(r['bwd']['bound_ms'], r['bwd']['dev_us'])} of its bound; forward + "
                f"backward through backward(): kernels {fmt_us(r['dev_us'])}, library "
                f"{fmt_us(r['library_dev_us'])}")
        n_edges, edge_err = k1_bwd_edge_checks(gen)
        log(f"[K1 bwd edges] {n_edges} cases (T of 1, 3, 32, 109; lengths 0, 1, T; views at an "
            f"odd offset; the streaming (1, 64, 128, 872) slab) against gn_mish_mask_bwd_ref: "
            f"largest error of the largest value {edge_err} (bars: f32 1e-4; bf16 dx 2^-8, "
            f"dscale and dbias 1e-4)")
        n_p2 = p2_shape_checks(gen)
        log(f"[probe] {probe.P2_NAME}: exactly equal at {n_p2} inputs (T_x 1, 31, 33, 100, 128, "
            f"1024 x T_y 1, 17, 256 x B 1, 8; NaN in the input at three T_x)")
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
        p1, p2 = probes[probe.P1_NAME], probes[probe.P2_NAME]
        cycles = "not measured" if p2["cycles_per_col"] is None else f"{p2['cycles_per_col']:.1f}"
        log(f"[probe] {smi}: {probe.P2_NAME} {probe.P2_SHAPE}: card {p2['ms'] * 1e3:.2f} us, device "
            f"only {fmt_us(p2['dev_us'])} ({cycles} cycles a column at "
            f"{SM_CLOCK_HZ / 1e9:.2f} GHz over {probe.P2_SHAPE[0]} columns), bound "
            f"{p2['bound_ms'] * 1e3:.3f} us ({DEP_STEP_CYCLES} cycles a column); P1's host time a "
            f"call {p1['host_us']:.2f} us")
        log(f"[probe] {probe.P1_NAME}: card time in turns with torch.add: kernel "
            f"{p1['ms'] * 1e3:.2f} us, torch.add {p1['library_ms'] * 1e3:.2f} us; device only "
            f"{fmt_us(p1['dev_us'])} a call; host {p1['host_us']:.2f} us a call (torch.add "
            f"{p1['library_host_us']:.2f} us); the bound ({p1['bound_ms'] * 1e3:.3f} us) lies "
            f"below one launch's latency")
    bwd = {k: sum(checks[("k1_bwd", s)][k] * n for s, n in K1_TRAIN)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    bwd_only = {k: sum(checks[("k1_bwd", s)]["bwd"][k] * n for s, n in K1_TRAIN)
                for k in ("ms", "plain_ms", "bound_ms")}
    log(f"[K1 bwd] one training U-Net evaluation ({K1_PER_EVAL} launches, B=64, 128 frames), "
        f"forward + backward: kernel {bwd['ms']:.3f} ms plain {bwd['plain_ms']:.3f} ms "
        f"library {bwd['library_ms']:.3f} ms bound {bwd['bound_ms']:.3f} ms; backward kernel "
        f"alone {bwd_only['ms']:.3f} ms plain {bwd_only['plain_ms']:.3f} ms bound "
        f"{bwd_only['bound_ms']:.3f} ms (device time in a real step: phase 7's profile)")
    t_dev = eval_sums([checks[("k1_bwd", s)] for s, _ in K1_TRAIN], [n for _, n in K1_TRAIN])
    log(f"[K1 bwd] {smi}: the same eval, device only: backward {fmt_ms(t_dev['bwd'])} (kernel "
        f"{fmt_ms(t_dev['kernel'])}); forward + backward through backward(): kernels "
        f"{fmt_ms(t_dev['pair'])}, library {fmt_ms(t_dev['library'])}")

    # ---- 11. the earlier K1 backward against this one, in turns ------------------
    log(f"[time] phase 11 starts {time.perf_counter() - t_script:.1f} s into the script")
    if old_build is None:
        log("[K1 bwd turns] not measured: no --old-k1=DIR (an earlier gn_mish.py and "
            "gn_mish.cu) given")
    else:
        old_mod = load_old_k1(old_k1, old_build, old_so)
        gen = torch.Generator(device="cuda").manual_seed(11)
        turns = {}
        with strict_f32():
            for shape, _ in K1_BWD_SHAPES:
                r = turns[shape] = k1_bwd_turns(old_mod, shape, gen)
                bnd = checks.get(("k1_bwd", shape)) or gan_checks[("k1_bwd", shape)]
                bnd = bnd["bwd"]["bound_ms"]
                log(f"[K1 bwd turns] {shape} {smi}: card in turns: earlier {r['old_ms'] * 1e3:.1f} "
                    f"us, new {r['new_ms'] * 1e3:.1f} us; device only (old, new, new, old): "
                    f"earlier {' / '.join(fmt_us(v) for v in r['old_dev_us'])}, new "
                    f"{' / '.join(fmt_us(v) for v in r['new_dev_us'])}; bound {bnd * 1e3:.2f} us: "
                    f"new {bound_share(bnd, r['new_dev_us'][0])} of it on the device, "
                    f"{bound_share(bnd, r['new_ms'] * 1e3)} on the card")
                if "alt_ms" in r:
                    log(f"[K1 bwd turns] {shape} {smi}: the new kernel launched with {r['alt']} "
                        f"(the launch it did not choose): card {r['alt_ms'] * 1e3:.1f} us, device "
                        f"only {fmt_us(r['alt_dev_us'])}")
        for label, shapes in (("GAN eval (B=16, 436)", K1_GAN_436),
                              ("plain eval (B=64, 128)", K1_TRAIN)):
            tot = {k: sum(turns[sh][k] * n for sh, n in shapes) for k in ("old_ms", "new_ms")}
            devs = {k: [v[k] for v in (turns[sh] for sh, _ in shapes)]
                    for k in ("old_dev_us", "new_dev_us")}
            dev = {k: None if any(None in v for v in vals) else
                   [sum(v[i] * n for v, (_, n) in zip(vals, shapes)) / 1e3 for i in (0, 1)]
                   for k, vals in devs.items()}
            log(f"[K1 bwd turns] {smi}: one {label}, 25 backward launches: card earlier "
                f"{tot['old_ms']:.3f} ms, new {tot['new_ms']:.3f} ms; device only earlier "
                f"{dev['old_dev_us']} ms, new {dev['new_dev_us']} ms")

    # ---- 12. persistence and serving from phase 8's GAN state ----------------------
    log(f"[time] phase 12 starts {time.perf_counter() - t_script:.1f} s into the script")
    per = persist_phase(gan, texts, face, cmu)
    log(f"[persist] {smi}: GAN state at step {per['step']} (batch {cfg_g.per_gpu_batchsize}, Config widths): save_step {per['save_ms']:.1f} ms, "
        f"save_epoch (top-k + best) {per['save_epoch_ms']:.1f} ms, {per['bytes']} bytes a "
        f"checkpoint ({per['bytes'] / 2**20:.1f} MiB); restore into a fresh state "
        f"{per['restore_ms']:.1f} ms; bitwise equal: {per['restore_bitwise']}; files "
        f"{per['epoch_files']}")
    log(f"[persist] {smi}: one R1 step from the saved and from the restored state: "
        f"{per['step_ms']['saved']:.1f} / {per['step_ms']['restored']:.1f} ms; largest relative "
        f"metric difference {max(per['step_rel'].values()):.3e} "
        f"({max(per['step_rel'], key=per['step_rel'].get)}); parameters after the step differ "
        f"by at most {per['param_diff']:.3e}; g_loss {per['step_metrics']['saved']['g_loss']:.6f}"
        f" / {per['step_metrics']['restored']['g_loss']:.6f}")
    log(f"[persist] {smi}: train(resume_from=last) logged steps {per['resume_steps']}, step "
        f"times {[round(v, 1) for v in per['resume_step_ms']]} ms (phase 8's loop: "
        f"{[round(v, 1) for v in gan['step_ms']]} ms), {per['resume_wall_s']:.1f} s with set-up "
        f"and validation; launches {per['resume_launches']}")
    for tag, r in per["precisions"].items():
        log(f"[serve {tag}] {smi}: request from the checkpoint ({r['frames']} frames): direct "
            f"warm {statistics.median(r['direct_ms']):.1f} ms (all "
            f"{[round(v, 1) for v in r['direct_ms']]}), launches {r['launches']}")
        if "repeat_diff" in r:
            log(f"[serve {tag}] {smi}: one request twice, max |difference| of (mel, waveform), "
                f"deterministic cuDNN off: " + ", ".join(
                    f"{k} {v}" for k, v in r["repeat_diff"].items()))
        for frames, st in r["stream"].items():
            log(f"[serve {tag}] {smi}: stream_vocode of {frames} frames ({st['chunks']} chunks "
                f"of 64): first audio {statistics.median(st['first_ms']):.1f} ms, whole "
                f"{statistics.median(st['total_ms']):.1f} ms; one full-mel vocoder call "
                f"{statistics.median(st['full_ms']):.1f} ms; max |chunks - one call| {st['diff']}"
                + (f" (TF32 off, deterministic cuDNN; with PyTorch's default TF32 convolutions "
                   f"{st['diff_tf32']:.3e})" if "diff_tf32" in st else ""))
        log(f"[serve {tag}] {smi}: /health {r['health']}; over HTTP "
            f"{statistics.median(r['http_ms']):.1f} ms against direct + wav "
            f"{statistics.median(r['http_direct_ms']):.1f} ms (medians of 10 in turns; "
            f"{[round(v, 1) for v in r['http_ms']]} / "
            f"{[round(v, 1) for v in r['http_direct_ms']]}); /synthesize_stream within "
            f"{r['stream_lsb']} LSB of /synthesize; served launches {r['served_launches']}")
    log(f"[persist] launches over the phase: {dict(per['launches'])}")
    if per["fails"]:
        raise AssertionError("[persist] " + "; ".join(per["fails"]))

    # ---- 13. the training options -----------------------------------------------------
    log(f"[time] phase 13 starts {time.perf_counter() - t_script:.1f} s into the script")
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    opt = options_phase(smi)
    opt_launches = opt["launches"]
    log(f"[options] launches over the loop runs: {dict(opt_launches)}")

    # ---- 14. the data and evaluation path -----------------------------------------------
    log(f"[time] phase 14 starts {time.perf_counter() - t_script:.1f} s into the script")
    gc.collect()
    torch.cuda.empty_cache()
    de = data_eval_phase(smi, os.path.join(ROOT, "test", "face.png"))
    cfg_e, ev = de["cfg"], de["eval"]
    log(f"[data] {smi}: corpus of {de['clips']} clips ({', '.join(f'{s} {c}' for s, c in CORPUS_SPLITS)}; "
        f"{CORPUS_SPEAKERS} speakers, {CORPUS_SECONDS[0]}-{CORPUS_SECONDS[1]} s) written in "
        f"{de['write_s']:.1f} s; packed by data.preprocess.main in {de['pack_s']:.1f} s: ms a "
        f"clip " + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in de["per_clip_s"].items())
        + f" (mel on the card, to the host); mel against float64 (TF32 off): linear "
        f"{de['mel_err'][0]:.3e} of the frame's largest value (bar 1e-5), log {de['mel_err'][1]:.3e} "
        f"above 1e-3 of it (bar {MEL_LOG_BAR}); shards {de['shards']}")
    log(f"[eval] {smi}: train() on the packed corpus, use_gan=0, batch {cfg_e.per_gpu_batchsize}, "
        f"Config widths, eval_interval={cfg_e.eval_interval}, {EVAL_STEPS} steps, "
        f"{cfg_e.eval_n_samples} items, f0_protocol={cfg_e.f0_protocol}, use_bf16={cfg_e.use_bf16}: "
        f"{de['train_wall_s']:.1f} s in all; launches over the run {de['train_launches']}")
    log(f"[eval] {smi}: the evaluation at step {ev['step']}: {ev['wall_s'] * 1e3:.0f} ms; by part "
        f"(host clock, results on the host): " + ", ".join(
            f"{k} {v * 1e3:.0f} ms" for k, v in ev["seconds"].items())
        + f"; launches {ev['launches']}, K1 forwards by dtype {ev['k1_fwd']} "
        f"({K1_PER_EVAL * cfg_e.timesteps} bf16 an item asserted)")
    log("[eval] results: " + ", ".join(f"{k} {v:.4f}" for k, v in ev["results"].items()))
    for line in de["eval_text"].splitlines()[:4]:
        log(f"[eval] eval_output.txt: {line}")
    log(f"[evaluate] {smi}: python -m facegantts_tpu_torch.evaluation.evaluate over the "
        f"evaluation's samples against the corpus wavs: {de['evaluate_s']:.1f} s; " + ", ".join(
            f"{k} {v:.4f}" for k, v in de["evaluate"].items()))
    log(f"[acc_measure] {smi}: python -m facegantts_tpu_torch.evaluation.acc_measure on the "
        f"packed test split, n_way 5, 100 trials: {de['acc_s']:.1f} s; " + ", ".join(
            f"{k} {v:.2f}" for k, v in de["acc"].items()))
    de_launches = collections.Counter(de["train_launches"])

    # ---- 15. the UTMOS-strong SSL MOS model, analysis, weight pins, the sweep --------------
    log(f"[time] phase 15 starts {time.perf_counter() - t_script:.1f} s into the script")
    gc.collect()
    torch.cuda.empty_cache()
    mo = mos_phase(smi, de)
    log_mos(smi, mo, de)
    mo_launches = collections.Counter()
    for ll in mo["trial_launches"]:
        mo_launches.update(ll)

    # ---- 16. the tooling slice: export, the bench, a traced window, FLOPs, migration --------
    log(f"[time] phase 16 starts {time.perf_counter() - t_script:.1f} s into the script")
    gc.collect()
    torch.cuda.empty_cache()
    to = tooling_phase(smi, texts, face, cmu)
    log_tooling(smi, to)
    to_launches = to["launches"]

    # ---- lines -----------------------------------------------------------------
    f32 = per_eval[(436, torch.float32)]
    k1_err = max(r["err"] for (s, dt), r in results.items() if dt == torch.float32)
    mas_big = checks[("mas", "ragged random", MAS_SHAPES[-1])]
    k2 = {k: sum(checks[("k2", s)][k] for s, _ in K1_TRAIN)
          for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"[lines] kernels line: {gn_mish.NAME} times are one U-Net evaluation's {K1_PER_EVAL} "
        f"K1 launches at Ty=436, B=1, f32 (per-shape lines above), max_abs_err over every f32 "
        f"shape, launches on the inference ({path_launches[gn_mish.NAME]}), training "
        f"({tr['launches'][gn_mish.NAME]}), GAN ({gan['launches'][gn_mish.NAME]}), "
        f"persistence and serving ({per['launches'][gn_mish.NAME]}), training-option "
        f"({opt_launches['K1']}), data and evaluation ({de_launches[gn_mish.NAME]}), sweep "
        f"trial ({mo_launches[gn_mish.NAME]}, phase 15's trainer processes) and tooling "
        f"({to_launches[gn_mish.NAME]}: exported programs, the bench's process, the traced "
        f"training) paths; "
        f"{gn_mish.BWD_NAME} times are one training "
        f"evaluation's {K1_PER_EVAL} backward launches (B=64), max_abs_err against "
        f"gn_mish_mask_bwd_ref, launches on the training, GAN, resumed-GAN, "
        f"training-option ({opt_launches['K1 bwd bf16']} of them bf16; the bf16 backward's own "
        f"times are phase 13's), data and evaluation, sweep trial and tooling paths; "
        f"{mas_mod.NAME} at {MAS_SHAPES[-1]}, launches on the training, GAN, resumed-GAN, "
        f"training-option, data and evaluation, sweep trial and tooling paths; {gnorm.NAME} summed "
        f"over the "
        f"{len(K1_TRAIN)} "
        f"training U-Net shapes, launches in the FusedGroupNorm run; probes at their shapes, "
        f"launches in the probe run")

    def entry(name, source, replaces, launches, r, err):
        return {"name": name, "route": "cuda", "source": f"facegantts_tpu_torch/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    k1_by = collections.Counter(r["bound_by"] for r in results.values()).most_common(1)[0][0]
    log(f"[lines] the whole script: {time.perf_counter() - t_script:.1f} s; phase 16 "
        f"{to['seconds']['phase']:.1f} s")
    log(smi)
    log(json.dumps({"kernels": [
        entry(gn_mish.NAME, "csrc/gn_mish.cu", "facegantts_tpu/ops/gn_mish.py:119",
              path_launches[gn_mish.NAME] + tr["launches"][gn_mish.NAME]
              + gan["launches"][gn_mish.NAME] + per["launches"][gn_mish.NAME]
              + opt_launches["K1"] + de_launches[gn_mish.NAME] + mo_launches[gn_mish.NAME]
              + to_launches[gn_mish.NAME],
              dict(f32, bound_by=k1_by), k1_err),
        entry(gn_mish.BWD_NAME, "csrc/gn_mish.cu", "facegantts_tpu/ops/gn_mish.py:262",
              tr["launches"][gn_mish.BWD_NAME] + gan["launches"][gn_mish.BWD_NAME]
              + per["launches"][gn_mish.BWD_NAME] + opt_launches["K1 bwd"]
              + de_launches[gn_mish.BWD_NAME] + mo_launches[gn_mish.BWD_NAME]
              + to_launches[gn_mish.BWD_NAME],
              dict(bwd_only, library_ms=None, bound_by=(
                  collections.Counter(checks[("k1_bwd", s)]["bwd"]["bound_by"]
                                      for s, _ in K1_TRAIN).most_common(1)[0][0])),
              max(checks[("k1_bwd", s)]["bwd_abs_err"] for s, _ in K1_TRAIN)),
        entry(mas_mod.NAME, "csrc/mas.cu", "facegantts_tpu/ops/mas.py:38",
              tr["launches"][mas_mod.NAME] + gan["launches"][mas_mod.NAME]
              + per["launches"][mas_mod.NAME] + opt_launches["MAS"] + de_launches[mas_mod.NAME]
              + mo_launches[mas_mod.NAME] + to_launches[mas_mod.NAME], mas_big, 0.0),
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
