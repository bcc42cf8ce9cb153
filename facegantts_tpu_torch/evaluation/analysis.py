"""Analysis & plotting utilities (reference evaluation/{mos_analysis,
melspec_plots,loss_plots_ablation}.py and utils/tts_util.py:48-75).

A copy of the JAX package's ``evaluation/analysis.py``, which the port keeps
because it imports nothing of that package.

- MOS study statistics: per-system descriptive stats, pairwise Wilcoxon
  signed-rank tests with Bonferroni correction (reference mos_analysis.py
  uses pingouin; this uses scipy directly).
- Mel-spectrogram plotting and side-by-side comparison figures.
- Training-curve plots from the trainer's metrics.jsonl.

All plotting is matplotlib-gated: importable without a display or without
matplotlib; a plotting call where matplotlib is not installed raises an
``ImportError`` that names it.
"""

import itertools
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# MOS statistics
# ---------------------------------------------------------------------------

def mos_statistics(ratings: Dict[str, Sequence[float]]) -> Dict[str, Dict[str, float]]:
    """Per-system mean/std/median/CI95 for MOS ratings."""
    out = {}
    for system, vals in ratings.items():
        v = np.asarray(vals, dtype=np.float64)
        sem = v.std(ddof=1) / np.sqrt(len(v)) if len(v) > 1 else 0.0
        out[system] = {
            "n": float(len(v)),
            "mean": float(v.mean()),
            "std": float(v.std(ddof=1)) if len(v) > 1 else 0.0,
            "median": float(np.median(v)),
            "ci95": float(1.96 * sem),
        }
    return out


def pairwise_wilcoxon(
    ratings: Dict[str, Sequence[float]], bonferroni: bool = True
) -> List[Dict[str, float]]:
    """Pairwise Wilcoxon signed-rank tests between systems (paired ratings),
    Bonferroni-corrected (reference mos_analysis.py protocol)."""
    from scipy.stats import wilcoxon

    systems = sorted(ratings)
    pairs = list(itertools.combinations(systems, 2))
    m = len(pairs)
    results = []
    for a, b in pairs:
        va, vb = np.asarray(ratings[a], float), np.asarray(ratings[b], float)
        n = min(len(va), len(vb))
        if n < 2 or np.allclose(va[:n], vb[:n]):
            stat, p = 0.0, 1.0
        else:
            stat, p = wilcoxon(va[:n], vb[:n])
        p_adj = min(1.0, p * m) if bonferroni else p
        results.append({
            "system_a": a, "system_b": b, "statistic": float(stat),
            "p_value": float(p), "p_adjusted": float(p_adj),
            "significant_0.05": bool(p_adj < 0.05),
        })
    return results


# ---------------------------------------------------------------------------
# plotting (reference utils/tts_util.py:48-75, evaluation/melspec_plots.py)
# ---------------------------------------------------------------------------

def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported at the call."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_mel_plot(mel: np.ndarray, path: str, title: Optional[str] = None):
    """Save one log-mel spectrogram image (reference save_plot)."""
    plt = _pyplot()

    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(np.asarray(mel), aspect="auto", origin="lower", interpolation="none")
    if title:
        ax.set_title(title)
    plt.colorbar(im, ax=ax)
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)


def save_spectrogram_db(spec_db: np.ndarray, path: str,
                        title: Optional[str] = None):
    """Linear-frequency dB spectrogram image (reference
    data_filtering/plot_noise_frequencies.py:50-59: magma colormap,
    frequency bins on y, time frames on x, dB colorbar)."""
    plt = _pyplot()

    fig = plt.figure(figsize=(10, 4), constrained_layout=True)
    plt.imshow(np.asarray(spec_db), origin="lower", aspect="auto", cmap="magma")
    if title:
        plt.title(title)
    plt.xlabel("Time Frames")
    plt.ylabel("Frequency Bins")
    plt.colorbar(label="Amplitude (dB)")
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)


def save_mel_comparison(
    mels: Sequence[Tuple[str, np.ndarray]], path: str
):
    """Stacked mel comparison figure (reference melspec_plots.py)."""
    plt = _pyplot()

    n = len(mels)
    fig, axes = plt.subplots(n, 1, figsize=(12, 3 * n), squeeze=False)
    for ax, (name, mel) in zip(axes[:, 0], mels):
        im = ax.imshow(np.asarray(mel), aspect="auto", origin="lower", interpolation="none")
        ax.set_title(name)
        plt.colorbar(im, ax=ax)
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)


def save_epoch_progress(
    mels_by_epoch: Sequence[Tuple[int, np.ndarray]], path: str,
    title: str = "training progress",
):
    """Grid of generated mels across training epochs (reference
    evaluation/facegantts_epoch_progress.py): one row per checkpoint epoch,
    shared color scale so brightness changes are comparable."""
    plt = _pyplot()

    n = len(mels_by_epoch)
    if n == 0:
        raise ValueError("no mels given")
    vmin = min(float(np.min(m)) for _, m in mels_by_epoch)
    vmax = max(float(np.max(m)) for _, m in mels_by_epoch)
    fig, axes = plt.subplots(n, 1, figsize=(12, 2.2 * n), squeeze=False)
    for ax, (epoch, mel) in zip(axes[:, 0], mels_by_epoch):
        ax.imshow(np.asarray(mel), aspect="auto", origin="lower",
                  interpolation="none", vmin=vmin, vmax=vmax)
        ax.set_ylabel(f"epoch {epoch}", fontsize=8)
        ax.set_xticks([])
        ax.set_yticks([])
    axes[0, 0].set_title(title)
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)


def save_face_grid_pdf(image_paths: Sequence[str], path: str, cols: int = 4):
    """Face-image contact sheet as a PDF (reference
    evaluation/save_face_pdf.py exports MOS-study face pages)."""
    plt = _pyplot()
    from PIL import Image

    n = len(image_paths)
    if n == 0:
        raise ValueError("no images given")
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows), squeeze=False)
    for i, ax in enumerate(axes.ravel()):
        ax.axis("off")
        if i < n:
            ax.imshow(np.asarray(Image.open(image_paths[i]).convert("RGB")))
            ax.set_title(str(i), fontsize=7)
    plt.tight_layout()
    plt.savefig(path, format="pdf")
    plt.close(fig)


def plot_training_curves(metrics_jsonl: str, path: str, keys: Optional[Sequence[str]] = None):
    """Loss curves from the trainer's metrics.jsonl (reference
    loss_plots_ablation.py reads TensorBoard; we read our JSONL)."""
    plt = _pyplot()

    records = [json.loads(l) for l in open(metrics_jsonl) if l.strip()]
    if not records:
        raise ValueError(f"no records in {metrics_jsonl}")
    if keys is None:
        keys = sorted({k for r in records for k in r if k != "step"})
    fig, ax = plt.subplots(figsize=(10, 6))
    for k in keys:
        pts = [(r["step"], r[k]) for r in records if k in r]
        if pts:
            xs, ys = zip(*pts)
            ax.plot(xs, ys, label=k)
    ax.set_xlabel("step")
    ax.legend(fontsize=7)
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)


def collect_mos_samples(wav_paths: Sequence[str], video_root: str,
                        target_dir: str, seed: int = 0) -> Sequence[str]:
    """Assemble a MOS-study sample folder: copy each generated wav and
    extract one face frame from its source video next to it (reference
    evaluation/syncnet_inputs.py + save_face_pdf.save_random_frame_as_png —
    minus that script's hard-coded cluster paths).

    ``wav_paths`` follow the inference output layout ``.../<spk>/<clip>.wav``;
    the matching video is ``<video_root>/<spk>/<clip>.mp4``.  Returns the
    written face-image paths (input order), usable directly with
    ``save_face_grid_pdf``.  Videos are read with cv2 when available; a
    missing video or cv2 leaves a wav without a face image (warned), like
    the reference's try/except-and-continue."""
    import random
    import shutil

    os.makedirs(target_dir, exist_ok=True)
    rng = random.Random(seed)
    try:
        import cv2
    except ImportError:
        cv2 = None
    faces = []
    for wav_path in wav_paths:
        parts = os.path.normpath(wav_path).split(os.sep)
        if len(parts) < 2:
            # expected layout is <spk>/<clip>.wav; a bare filename has no
            # speaker directory to name the sample after
            print(f"[WARN] skipping {wav_path!r}: no <spk>/<clip>.wav layout")
            continue
        spk, clip = parts[-2], os.path.splitext(parts[-1])[0]
        shutil.copy(wav_path, os.path.join(target_dir, f"{spk}_{clip}.wav"))
        video = os.path.join(video_root, spk, clip + ".mp4")
        out = os.path.join(target_dir, f"{spk}_{clip}_face.png")
        if cv2 is None or not os.path.exists(video):
            print(f"[WARN] no face frame for {wav_path} "
                  f"({'no cv2' if cv2 is None else video + ' missing'})")
            continue
        cap = cv2.VideoCapture(video)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if n > 0:
            cap.set(cv2.CAP_PROP_POS_FRAMES, rng.randrange(n))
        ok, frame = cap.read()
        cap.release()
        if not ok:
            print(f"[WARN] unreadable video {video}")
            continue
        cv2.imwrite(out, frame)
        faces.append(out)
    return faces
