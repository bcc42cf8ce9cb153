"""Ahead-of-time export of the PyTorch port: one self-contained synthesis
program per (text, mel) bucket pair (the JAX package's ``export.py``).

Each program is text + face + noise -> (wav, mel, y_len), made with
``torch.export.export`` and written with ``torch.export.save``: the
generator's and the vocoder's weights are held in the program, so a serving
host needs this package only for K1, which the program holds as the
registered operator ``facegantts::gn_mish_mask`` (``ops/gn_mish.py``), 25 a
U-Net evaluation.  ``manifest.json`` carries the JAX bundle's keys.

torch cannot draw ``jax.random``'s noise, so the program takes the initial
noise (1, n_mels, ty) f32 as an input.  :func:`load_bundle` gives callables
with the JAX bundle's signature, ``fn(x, x_len, face, seed) -> (wav, mel,
y_len)``: each draws the noise from ``torch.Generator(device).manual_seed(seed)``
as ``Synthesizer.synthesize`` does, so a loaded call equals a live one.

Usage:
  python -m facegantts_tpu_torch.export out_dir=exported/ \\
      [resume_from=<port checkpoint dir | reference .pt>] [vocoder_ckpt=<hifigan.pt>] \\
      [device=cpu] [key=value config overrides]

The program runs on the device it was exported on (``platforms`` in the
manifest): the card unless ``device=cpu``.
"""

import json
import os
import sys
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from facegantts_tpu_torch.ops import gn_mish  # noqa: F401  (registers the K1 op for load)

MANIFEST = "manifest.json"
SIGNATURE = ("fn(x(1,tx) i32, x_len(1,) i32, face(1,224,224,3) f32 "
             "BGR 0..255, seed() i32) -> (wav, mel, y_len)")


class SynthesisProgram(nn.Module):
    """What a bundle's program runs at one bucket pair: ``FaceTTS.encode``,
    the Synthesizer's ``use_bf16`` casts and ``decode`` with the given noise,
    and the vocoder (``Synthesizer._decode_vocode``).  ``forward(x (1, tx)
    i32, x_len (1,) i32, face (1, 224, 224, 3) f32, noise (1, n_mels, ty)
    f32) -> (wav f32, mel f32, y_len i32)``."""

    def __init__(self, synth, ty: int, n_timesteps: int, temperature: float):
        super().__init__()
        self.model, self.vocoder = synth.model, synth.vocoder
        self._synth = synth
        self.ty, self.n_timesteps, self.temperature = ty, n_timesteps, temperature

    def forward(self, x, x_len, face, noise):
        enc = self.model.encode(x.long(), x_len.long(), face, self._synth.cfg.length_scale)
        return self._synth._decode_vocode(enc, self.ty, self.n_timesteps, self.temperature,
                                          False, 0, noise=noise)


def export_bundle(synth, out_dir: str, n_timesteps: Optional[int] = None,
                  temperature: Optional[float] = None) -> Dict:
    """Export every (tx, ty) bucket pair of ``synth.cfg`` to ``out_dir`` on
    ``synth.device``; returns the manifest."""
    cfg = synth.cfg
    n_timesteps = n_timesteps or cfg.timesteps
    temperature = cfg.temperature if temperature is None else temperature
    os.makedirs(out_dir, exist_ok=True)
    dev = synth.device
    entries = []
    for tx in cfg.text_buckets:
        for ty in cfg.mel_buckets:
            args = (torch.zeros((1, tx), dtype=torch.int32, device=dev),
                    torch.ones((1,), dtype=torch.int32, device=dev),
                    torch.zeros((1, cfg.image_size, cfg.image_size, 3), device=dev),
                    torch.zeros((1, cfg.n_mels, ty), device=dev))
            t0 = time.perf_counter()
            with torch.no_grad():  # one flat inference graph, K1 as its registered op
                program = torch.export.export(
                    SynthesisProgram(synth, ty, n_timesteps, temperature).eval(), args)
            name = f"synth_tx{tx}_ty{ty}.pt2"
            torch.export.save(program, os.path.join(out_dir, name))
            entries.append({"tx": tx, "ty": ty, "file": name, "platforms": [dev.type]})
            print(f"exported ({tx}, {ty}) -> {name} [{dev.type}] in "
                  f"{time.perf_counter() - t0:.1f} s")
    manifest = {
        "entries": entries,
        "n_timesteps": n_timesteps,
        "temperature": temperature,
        "length_scale": cfg.length_scale,
        "sample_rate": cfg.sample_rate,
        "hop_len": cfg.hop_len,
        "n_mels": cfg.n_mels,
        "add_blank": bool(cfg.add_blank),
        "signature": SIGNATURE,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _seeded_call(module: nn.Module, device: torch.device, n_mels: int, ty: int) -> Callable:
    @torch.no_grad()
    def fn(x, x_len, face, seed):
        gen = torch.Generator(device=device).manual_seed(int(seed))
        noise = torch.randn((1, n_mels, ty), generator=gen, dtype=torch.float32, device=device)
        return module(torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device),
                      torch.as_tensor(np.asarray(x_len), dtype=torch.int32, device=device),
                      torch.as_tensor(np.asarray(face), dtype=torch.float32, device=device),
                      noise)

    return fn


def load_bundle(out_dir: str) -> Tuple[Dict, Dict]:
    """(manifest, {(tx, ty): fn(x, x_len, face, seed) -> (wav, mel, y_len)})
    from an exported bundle; each program runs on the device it was
    exported on."""
    with open(os.path.join(out_dir, MANIFEST)) as f:
        manifest = json.load(f)
    fns = {}
    for e in manifest["entries"]:
        program = torch.export.load(os.path.join(out_dir, e["file"]))
        fns[(e["tx"], e["ty"])] = _seeded_call(program.module(), torch.device(e["platforms"][0]),
                                               manifest["n_mels"], e["ty"])
    return manifest, fns


def main(argv=None):
    from facegantts_tpu_torch.config import default_config, parse_cli_overrides
    from facegantts_tpu_torch.inference import load_weights
    from facegantts_tpu_torch.synthesis import Synthesizer, resolve_device

    overrides = parse_cli_overrides(argv if argv is not None else sys.argv[1:])
    out_dir = overrides.pop("out_dir", "exported")
    device = overrides.pop("device", None)
    cfg = default_config(overrides=overrides)
    resolve_device(device)  # no card: raise before reading any weights
    state_dict, vocoder_state_dict = load_weights(cfg)
    synth = Synthesizer(cfg, state_dict=state_dict, vocoder_state_dict=vocoder_state_dict,
                        device=device)
    export_bundle(synth, out_dir)
    print(f"bundle written to {out_dir}")


if __name__ == "__main__":
    main()
