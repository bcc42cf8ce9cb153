"""Checkpoint migration CLI of the PyTorch port (the JAX package's
``migrate_checkpoint.py``; reference migrate_checkpoint.py:4-19, widened).

1. ``torch2port`` (the main path): a reference ``.pt`` / ``.ckpt`` (plain
   FaceTTS or GAN; the discriminator keys stripped, as reference
   train.py:110-121 does) becomes a port checkpoint directory at step 0,
   which ``train/loop.py: warm_start`` (``resume_from=<dir>``),
   ``checkpoint.restore_checkpoint`` and the inference, serving and export
   entry points read.  The generator is a FaceTTS of the Config initialised
   from ``cfg.seed`` with the file's weights merged in by name and shape
   (``checkpoint.merge_state_dict``); the optimizers start fresh, as the
   reference's warm start restarts optimization.  ``use_gan`` (the Config's
   default 1) decides whether the directory holds a discriminator, which a
   resumed run must match.
2. ``fix-lightning``: the reference's behaviour verbatim, the missing
   ``pytorch-lightning_version`` key added so old torch checkpoints load in
   newer Lightning.

Usage:
  python -m facegantts_tpu_torch.migrate_checkpoint src=<ckpt.pt> dst=<dir> \\
      [mode=torch2port|fix-lightning] [device=cpu] [config overrides...]

``torch2port`` builds the state on the card unless ``device=cpu``.
"""

import os
import sys

from facegantts_tpu_torch.config import default_config, parse_cli_overrides


def torch_to_port(src: str, dst: str, cfg, device=None) -> None:
    """Import reference torch weights into a fresh :class:`TrainState` of
    ``cfg`` on ``device`` and save it as a port checkpoint at step 0."""
    from facegantts_tpu_torch.synthesis import resolve_device
    from facegantts_tpu_torch.train import checkpoint as ck
    from facegantts_tpu_torch.train.step import init_state

    state = init_state(cfg, resolve_device(device))
    loaded = ck.merge_state_dict(state.model, ck.load_facetts_state_dict(src))
    ck.save_checkpoint(dst, state, step=0, keep=1)
    print(f"[INFO] wrote port checkpoint: {dst} (step 0, {len(loaded)} tensors from {src})")


def fix_lightning_version(src: str, dst: str) -> None:
    """Reference migrate_checkpoint.py behavior: add the
    ``pytorch-lightning_version`` key if absent and re-save."""
    import torch

    ckpt = torch.load(src, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict):
        raise SystemExit(f"{src} is not a dict checkpoint")
    if "pytorch-lightning_version" in ckpt:
        print("[INFO] checkpoint already has pytorch-lightning_version; copying")
    else:
        ckpt["pytorch-lightning_version"] = "1.9.0"
        print("[INFO] injected pytorch-lightning_version=1.9.0")
    torch.save(ckpt, dst)
    print(f"[INFO] wrote {dst}")


def main(argv=None):
    overrides = parse_cli_overrides(argv if argv is not None else sys.argv[1:])
    src = overrides.pop("src", None)
    dst = overrides.pop("dst", None)
    mode = overrides.pop("mode", "torch2port")
    device = overrides.pop("device", None)
    if not src or not dst:
        raise SystemExit(__doc__)
    if not os.path.exists(src):
        raise SystemExit(f"source checkpoint not found: {src}")
    if mode == "fix-lightning":
        fix_lightning_version(src, dst)
    elif mode == "torch2port":
        torch_to_port(src, os.path.abspath(dst), default_config(overrides=overrides), device)
    else:
        raise SystemExit(f"unknown mode {mode!r} (torch2port | fix-lightning)")


if __name__ == "__main__":
    main()
