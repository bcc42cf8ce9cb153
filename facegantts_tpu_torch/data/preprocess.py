"""Offline dataset packing of the PyTorch port: LRS2 corpus -> packed shards.

Port of the JAX package's ``data/preprocess.py``.  Runs the reference's
per-epoch CPU hot loop once (reference data/lrs2_dataset.py:61-130): wav
load -> spectral-gating denoise -> 50 ms fade-out -> optional band filters
-> log-mel (the port's mel op, on the card unless ``device=cpu``);
transcript -> cleaned symbol IDs with blank interspersal; one face frame per
clip.  The shards are the JAX package's two formats, which the port's
``data/dataset.py: load_packed`` reads.

Face frames: the pre-extracted ``<image_data_root>/<clip>.jpg`` read through
PIL when present, else a frame of the video decoded with cv2 if it imports;
clips with neither, or without audio or text, are skipped with a warning.

Usage:
  python -m facegantts_tpu_torch.data.preprocess split=train lrs2_path=... \
      packed_data_dir=packed/ [shard_size=512] [pack_format=raw|npz] [device=cpu]
"""

import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from facegantts_tpu_torch.config import Config, default_config, parse_cli_overrides
from facegantts_tpu_torch.data.denoise import fade_out, spectral_gate
from facegantts_tpu_torch.data.filters import apply_filter_chain
from facegantts_tpu_torch.ops.mel import mel_spectrogram
from facegantts_tpu_torch.synthesis import resolve_device
from facegantts_tpu_torch.text import intersperse, text_to_sequence
from facegantts_tpu_torch.text.cmudict import default_cmudict
from facegantts_tpu_torch.utils.audio import load_wav


def _mel_host(wav: np.ndarray, cfg: Config, device=None) -> np.ndarray:
    """(T,) waveform -> (n_mels, frames) f32 log-mel, computed on ``device``
    (the card unless the caller asks for the CPU)."""
    y = torch.as_tensor(np.asarray(wav, np.float32)[None], device=resolve_device(device))
    out = mel_spectrogram(y, cfg.n_fft, cfg.n_mels, cfg.sample_rate, cfg.hop_len,
                          cfg.win_len, cfg.f_min, cfg.f_max)
    return out[0].cpu().numpy()


def _load_face(clip_path: str, cfg: Config, rng) -> Optional[np.ndarray]:
    """One face frame as (224, 224, 3) uint8 BGR."""
    img_path = clip_path.replace(
        f"/{cfg.video_data_root}/", f"/{cfg.image_data_root}/"
    ).rsplit(".", 1)[0] + ".jpg"
    if os.path.exists(img_path):
        from PIL import Image

        img = Image.open(img_path).convert("RGB").resize(
            (cfg.image_size, cfg.image_size)
        )
        return np.asarray(img, np.uint8)[..., ::-1]
    try:
        import cv2  # optional
    except ImportError:
        return None
    cap = cv2.VideoCapture(clip_path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if n <= 0:
        return None
    cap.set(cv2.CAP_PROP_POS_FRAMES, int(rng.integers(0, n)))
    ok, frame = cap.read()
    cap.release()
    if not ok:
        return None
    return cv2.resize(frame, (cfg.image_size, cfg.image_size)).astype(np.uint8)


def pack_split(cfg: Config, split: str, shard_size: int = 512, pack_format: str = "raw",
               device=None, timings: Optional[Dict[str, float]] = None) -> List[str]:
    """Pack one split; returns the shard paths.  ``timings``, if given,
    accumulates seconds by part: ``denoise`` (spectral gate and fade),
    ``filters``, ``mel`` (to the host, synchronised) and ``write``."""
    filelist = {
        "train": cfg.lrs2_train, "val": cfg.lrs2_val, "test": cfg.lrs2_test
    }[split]
    subdir = "test" if split == "test" else "trainval"
    with open(filelist) as f:
        names = [ln.strip() for ln in f if ln.strip()]

    spk_ids: Dict[str, int] = {}
    for n in names:  # speaker dir -> integer id (lrs2_dataset.py:50-56)
        spk_ids.setdefault(n.split("/")[0], len(spk_ids))

    cmu = default_cmudict(cfg.cmudict_path)
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(cfg.packed_data_dir, exist_ok=True)
    tm = timings if timings is not None else {}

    def timed(part, fn, *a, **k):
        t0 = time.perf_counter()
        r = fn(*a, **k)
        tm[part] = tm.get(part, 0.0) + time.perf_counter() - t0
        return r

    shard, paths = _new_shard(), []
    for n in names:
        wav_path = os.path.join(cfg.lrs2_path, cfg.audio_data_root, subdir, n + ".wav")
        txt_path = os.path.join(cfg.lrs2_path, subdir, n + ".txt")
        vid_path = os.path.join(cfg.lrs2_path, subdir, n + ".mp4")
        if not (os.path.exists(wav_path) and os.path.exists(txt_path)):
            print(f"[WARN] missing audio/text for {n}, skipping")
            continue
        wav, sr = load_wav(wav_path)
        assert sr == cfg.sample_rate, f"sampling rate must be {cfg.sample_rate}"
        wav = timed("denoise", lambda w: fade_out(spectral_gate(
            w, sr, prop_decrease=cfg.denoise_factor, n_fft=cfg.n_fft, hop=cfg.hop_len,
            win_length=cfg.win_len), sr), wav)
        wav = timed("filters", apply_filter_chain, wav, cfg.sample_rate, cfg)
        mel = timed("mel", _mel_host, wav, cfg, device)

        with open(txt_path) as f:
            line = f.readline().strip()
        text = line.split(":", 1)[1].strip() if line.upper().startswith("TEXT") else line
        ids = text_to_sequence(text, dictionary=cmu)
        if cfg.add_blank:
            ids = intersperse(ids)

        face = _load_face(vid_path, cfg, rng)
        if face is None:
            print(f"[WARN] no face frame for {n}, skipping")
            continue

        shard["text"].append(np.asarray(ids, np.int32))
        shard["mel"].append(mel.astype(np.float16))
        shard["faces"].append(face)
        shard["spk"].append(spk_ids[n.split("/")[0]])
        if len(shard["spk"]) >= shard_size:
            paths.append(timed("write", _flush, cfg, split, shard, len(paths), pack_format))
            shard = _new_shard()
    if shard["spk"]:
        paths.append(timed("write", _flush, cfg, split, shard, len(paths), pack_format))
    print(f"packed {split}: {len(paths)} shards, {len(spk_ids)} speakers")
    return paths


def _new_shard():
    return {"text": [], "mel": [], "faces": [], "spk": []}


def _flush(cfg: Config, split: str, shard, idx: int,
           pack_format: str = "raw") -> str:
    """Write one shard.  ``raw`` (default): a directory of plain .npy
    members the loader opens with mmap — random item access touches only
    the pages read, no per-access inflation (numpy NpzFile decompresses a
    whole member on EVERY [] access).  ``npz``: legacy compressed single
    file (smaller at rest, materialized once at open)."""
    members = dict(
        text_flat=np.concatenate(shard["text"]) if shard["text"] else np.zeros(0, np.int32),
        text_offsets=np.cumsum([0] + [len(t) for t in shard["text"]]).astype(np.int64),
        mel_flat=np.concatenate(shard["mel"], axis=1),
        mel_offsets=np.cumsum([0] + [m.shape[1] for m in shard["mel"]]).astype(np.int64),
        faces=np.stack(shard["faces"]),
        spk_ids=np.asarray(shard["spk"], np.int32),
    )
    if pack_format == "npz":
        path = os.path.join(cfg.packed_data_dir, f"{split}_{idx:05d}.npz")
        np.savez_compressed(path, **members)
        return path
    path = os.path.join(cfg.packed_data_dir, f"{split}_{idx:05d}")
    os.makedirs(path, exist_ok=True)
    for name, arr in members.items():
        np.save(os.path.join(path, f"{name}.npy"), arr)
    return path


def main(argv=None, timings: Optional[Dict[str, float]] = None):
    """The CLI; returns the shard paths.  ``timings`` as :func:`pack_split`'s."""
    overrides = parse_cli_overrides(argv if argv is not None else sys.argv[1:])
    split = overrides.pop("split", "train")
    shard_size = int(overrides.pop("shard_size", 512))
    pack_format = overrides.pop("pack_format", "raw")
    device = overrides.pop("device", None)
    cfg = default_config(overrides=overrides)
    if not cfg.packed_data_dir:
        raise SystemExit("set packed_data_dir=...")
    return pack_split(cfg, split, shard_size, pack_format, device=device, timings=timings)


if __name__ == "__main__":
    main()
