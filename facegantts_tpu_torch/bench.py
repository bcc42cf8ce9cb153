"""Benchmark of the PyTorch port on the card (the root ``bench.py``'s
counterpart).

    python -m facegantts_tpu_torch.bench

Prints one JSON line a metric on stdout, ``{"metric", "value", "unit"[,
"vs_baseline"]}``, the headline ``inference_rtf`` last:

- ``inference_rtf``: wall time over seconds of audio of one
  ``Synthesizer.synthesize`` call (text frontend, SyncNet, encoder, 10-step
  diffusion with K1, HiFi-GAN; ``use_bf16`` as the Config says) at the
  reference recipe (T=10, temperature 1.5, length_scale 0.91, reference
  inference.py:125-133), ``test/face.png`` and the JAX bench's sentence;
  the median of 10 warm calls.
- with ``BENCH_TRAIN=1`` (the default): ``train_samples_per_sec_parity``,
  the GAN step's samples/s on one card at batch 32 (two micro-batches of
  16), bucket (128, 436), R1 on; ``mfu_parity``, that step's FLOPs
  (``utils/flops.py``, ``step_measured``) over its time and the H100 SXM's
  published dense bf16 peak, 989e12 FLOP/s (NVIDIA's data sheet: a
  specification, not a measurement; the card's ``nvidia-smi`` name and
  power limit go to stderr); and with ``BENCH_BUCKET_MIX=1`` (the default)
  ``train_samples_per_sec_bucket_mix``, the same step over the LRS2 length
  mix of :data:`BUCKET_MIX`.  ``vs_baseline`` of the training lines is
  per-card samples/s over the reference recipe's 25 samples/s per A100
  (4xA100, global batch 256, 100k steps in a 3-day window).
- ``BENCH_BATCH=1``: batched synthesis throughput on stderr.
- ``BENCH_WATCHDOG`` (seconds, default 2700): a run that outlives it prints
  the lines measured so far and exits 3.

Its last stderr line counts the kernel launches of the run
(``kernels.LAUNCHES``).

Weights are random, from a seed, at the Config widths, with
``fused_gn_mish=1``: the U-Net runs the port's hand-written K1 (the
Config's default 0 is the plain torch chain).  The JAX bench's
``tpu_opt`` lines (``train_samples_per_sec``, ``mfu``) wait for the
``tpu_opt`` families' port: the bench says so on stderr and prints no
number for them.  Every function takes ``(cfg, device)``, so they run at
tiny widths on the CPU; ``main`` runs on the card and raises without one.
A failure anywhere fails the run.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = "The quick brown fox jumps over the lazy dog near the river bank."
H100_SXM_BF16_DENSE_FLOPS = 989e12  # NVIDIA H100 SXM data sheet, dense, no sparsity
# the reference recipe's GAN training scale: 4xA100, global batch 256, 100k
# steps inside a 3-day window (reference config.py:132, train.sh:7) -> about
# 25 samples/s per A100
REF_SAMPLES_PER_SEC_PER_GPU = 25.0
BENCH_BUCKET = (128, 436)  # (tx, ty) of the GAN step line
# LRS2 main-split lengths over the static buckets, (tx, ty, fraction of the
# samples): the JAX bench's documented assumption (clips under 1.3 s
# rejected, most utterances 2-4.5 s), kept as it is
BUCKET_MIX = (
    (64, 256, 0.40),
    (128, 436, 0.35),
    (192, 656, 0.18),
    (256, 872, 0.07),
)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_inference(cfg, device, n_iters: int = 10) -> float:
    """RTF of ``Synthesizer.synthesize`` at ``cfg``'s recipe: the median of
    ``n_iters`` warm calls over the seconds of audio."""
    from facegantts_tpu_torch.synthesis import Synthesizer, load_face
    from facegantts_tpu_torch.text.cmudict import default_cmudict
    from facegantts_tpu_torch.utils.profiling import StepTimer

    synth = Synthesizer(cfg, cmudict=default_cmudict(), device=device)
    face = synth.prepare_face(load_face(os.path.join(ROOT, "test", "face.png"), cfg.image_size))
    t0 = time.perf_counter()
    wav, _ = synth.synthesize(TEXT, face, return_mel=False)
    log(f"first synth: {time.perf_counter() - t0:.2f} s, audio {len(wav) / cfg.sample_rate:.2f} s, "
        f"finite {bool(np.isfinite(wav).all())}")
    timer = StepTimer(window=n_iters)
    for i in range(n_iters):
        timer.tic()
        wav, _ = synth.synthesize(TEXT, face, seed=i, return_mel=False)  # ends in a host copy
        timer.toc()
    audio_s = len(wav) / cfg.sample_rate
    sec = timer.stats()["step_time_median_s"]
    rtf = sec / audio_s
    log(f"median synth {sec * 1e3:.2f} ms for {audio_s:.2f} s audio -> RTF {rtf:.5f} "
        f"({1.0 / rtf:.1f}x realtime)")
    return rtf


def _gan_setup(cfg, device):
    from facegantts_tpu_torch.train.step import init_state, make_gan_train_step

    cfg = cfg.replace(use_gan=1)
    state = init_state(cfg, device)
    step, _ = make_gan_train_step(cfg, device)
    return cfg, state, step, torch.Generator(device=device).manual_seed(0)


def _time_steps(state, step, batch, gen, n_iters: int) -> float:
    """Median seconds of ``n_iters`` warm steps (one step first, untimed);
    each ends when ``g_loss`` reaches the host."""
    from facegantts_tpu_torch.utils.profiling import StepTimer

    t0 = time.perf_counter()
    float(step(state, batch, gen)[1]["g_loss"])
    log(f"  first step {(time.perf_counter() - t0) * 1e3:.1f} ms")
    timer = StepTimer(window=n_iters)
    for _ in range(n_iters):
        timer.tic()
        float(step(state, batch, gen)[1]["g_loss"])
        timer.toc()
    return timer.stats()["step_time_median_s"]


def bench_gan_step(cfg, device, n_iters: int = 5, bucket=BENCH_BUCKET):
    """The GAN step at batch ``2 * micro_batch_size`` and ``bucket`` (tx,
    ty), R1 on, random weights.  Returns (samples/s, seconds a step, FLOPs a
    step, MFU against the H100 SXM bf16 peak)."""
    from facegantts_tpu_torch.utils.flops import N_MICRO, gan_batch, gan_step_flops

    tx, ty = bucket
    flops = gan_step_flops(cfg, ty, tx, device)
    log("FLOPs a step (TFLOP): " + ", ".join(f"{k} {v / 1e12:.4f}" for k, v in flops.items()))
    cfg, state, step, gen = _gan_setup(cfg, device)
    b = N_MICRO * cfg.micro_batch_size
    batch = gan_batch(cfg, tx, ty, b).to(device)
    sec = _time_steps(state, step, batch, gen, n_iters)
    sps = b / sec
    mfu = flops["step_measured"] / sec / H100_SXM_BF16_DENSE_FLOPS
    log(f"GAN step (batch {b}, tx={tx}, ty={ty}, T={cfg.train_fake_timesteps}, R1 on): "
        f"{sec * 1e3:.1f} ms -> {sps:.2f} samples/s; {flops['step_measured'] / 1e12:.3f} "
        f"TFLOP -> MFU {100 * mfu:.3f} % of 989 TFLOP/s")
    return sps, sec, flops["step_measured"], mfu


def bench_bucket_mix(cfg, device, n_iters: int = 5, mix=BUCKET_MIX):
    """The GAN step at each bucket of ``mix`` and the mix's aggregate
    samples/s, 1 / sum(fraction / samples_per_s).  Returns (aggregate,
    [(tx, ty, fraction, samples/s)])."""
    from facegantts_tpu_torch.utils.flops import N_MICRO, gan_batch

    cfg, state, step, gen = _gan_setup(cfg, device)
    b = N_MICRO * cfg.micro_batch_size
    per_bucket = []
    for tx, ty, frac in mix:
        sec = _time_steps(state, step, gan_batch(cfg, tx, ty, b).to(device), gen, n_iters)
        per_bucket.append((tx, ty, frac, b / sec))
        log(f"bucket (tx={tx}, ty={ty}, frac={frac:.2f}): {sec * 1e3:.1f} ms -> "
            f"{b / sec:.2f} samples/s")
    agg = 1.0 / sum(f / sps for _, _, f, sps in per_bucket)
    log(f"bucket-mix aggregate: {agg:.2f} samples/s")
    return agg, per_bucket


def bench_batch_throughput(cfg, device, batch: int = 8, n_iters: int = 5) -> float:
    """``batch`` copies of the sentence in one ``synthesize_batch`` call
    (one mel bucket, one dispatch); returns utterances/s."""
    from facegantts_tpu_torch.synthesis import Synthesizer, load_face
    from facegantts_tpu_torch.text.cmudict import default_cmudict

    synth = Synthesizer(cfg, cmudict=default_cmudict(), device=device)
    face = load_face(os.path.join(ROOT, "test", "face.png"), cfg.image_size)
    texts = [TEXT] * batch
    wavs = synth.synthesize_batch(texts, face)
    audio_s = sum(len(w) for w in wavs) / cfg.sample_rate
    times = []
    for i in range(n_iters):
        t0 = time.perf_counter()
        synth.synthesize_batch(texts, face, seed=i)
        times.append(time.perf_counter() - t0)
    sec = float(np.median(times))
    log(f"batched synthesis: {batch} utterances ({audio_s:.1f} s audio) in {sec * 1e3:.1f} ms "
        f"-> {batch / sec:.2f} utt/s, RTF {sec / audio_s:.5f}")
    return batch / sec


def main() -> int:
    from facegantts_tpu_torch.config import default_config
    from facegantts_tpu_torch.ops import kernels
    from facegantts_tpu_torch.synthesis import resolve_device

    device = resolve_device(None)  # the card; raises without one
    results = []

    def flush():
        for r in results:
            print(json.dumps(r))
        sys.stdout.flush()

    def watchdog(signum, frame):
        log("FATAL: benchmark watchdog fired; printing the lines measured so far")
        flush()
        os._exit(3)

    signal.signal(signal.SIGALRM, watchdog)
    signal.alarm(int(os.environ.get("BENCH_WATCHDOG", "2700")))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(device)} ({smi}); MFU against the H100 SXM's "
        f"published dense bf16 peak, {H100_SXM_BF16_DENSE_FLOPS:.3g} FLOP/s")
    cfg = default_config(env={}, overrides={"fused_gn_mish": 1})
    rtf = bench_inference(cfg, device)
    if os.environ.get("BENCH_BATCH", "0") == "1":
        bench_batch_throughput(cfg, device)
    if os.environ.get("BENCH_TRAIN", "1") == "1":
        sps, _, _, mfu = bench_gan_step(cfg, device)
        results.append({"metric": "train_samples_per_sec_parity", "value": round(sps, 3),
                        "unit": "samples/s@batch32,unet_family=parity,h100",
                        "vs_baseline": round(sps / REF_SAMPLES_PER_SEC_PER_GPU, 4)})
        results.append({"metric": "mfu_parity", "value": round(mfu, 5),
                        "unit": "fraction_of_h100_sxm_dense_bf16_peak_989e12,unet_family=parity"})
        if os.environ.get("BENCH_BUCKET_MIX", "1") == "1":
            agg, _ = bench_bucket_mix(cfg, device)
            results.append({"metric": "train_samples_per_sec_bucket_mix", "value": round(agg, 3),
                            "unit": "samples/s,LRS2-length-mix,unet_family=parity,h100",
                            "vs_baseline": round(agg / REF_SAMPLES_PER_SEC_PER_GPU, 4)})
        log("train_samples_per_sec and mfu (unet_family=disc_family=tpu_opt): not measured; "
            "the tpu_opt families are not ported yet")
    results.append({"metric": "inference_rtf", "value": round(rtf, 6),
                    "unit": "s_compute/s_audio"})
    signal.alarm(0)
    log(f"kernel launches: {json.dumps(dict(kernels.LAUNCHES), sort_keys=True)}")
    flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
