"""Checksum-pinned entry points for the external pretrained artifacts.

A copy of the JAX package's ``weights.py``, which the port keeps because it
imports nothing of that package; ``ARTIFACTS`` names the port's importers
and the pins file is the port's own ``assets/weight_pins.json``.

The reference depends on four external weight files that cannot be fetched
on an air-gapped machine:

- ``facetts_lrs3.pt``  — generator warm-start (reference config.py:151,
  train.py:110-121)
- ``syncnet_ckpt``     — pretrained SyncNet (reference config.py:60,
  model/syncnet_hifigan.py:87-99)
- bshall HiFi-GAN-16k  — vocoder (reference inference.py:79,
  ``torch.hub.load('bshall/hifigan:main', 'hifigan')``)
- ``utmos22_strong``   — UTMOS MOS predictor (reference
  evaluation/eval.py:209-211)

The importers (train/checkpoint.py, evaluation/ssl_mos.py) are held to
the JAX package's on replicas, but first contact with the REAL files should
be a controlled event: this module pins each artifact to a SHA256 recorded in
``assets/weight_pins.json`` and refuses to import a file whose hash does
not match its pin.

Acquisition / verification procedure (run on a machine with network):

1. Download the artifact from its recorded source (``python -m
   facegantts_tpu_torch.weights list`` prints the sources).
2. ``python -m facegantts_tpu_torch.weights pin <name> <path>`` — hashes the
   file and records the SHA256 into assets/weight_pins.json (trust on
   first use; refuses to overwrite an existing different pin without
   ``--force``).  Commit the updated pins file.
3. From then on every load goes through ``python -m
   facegantts_tpu_torch.weights verify <name> <path>`` or
   :func:`load_verified`, which re-hashes and hard-fails on any mismatch —
   a corrupted or substituted file can never silently reach the importers.
"""

import argparse
import hashlib
import json
import os
import sys
from typing import Any, Dict, Optional

_DEFAULT_PINS_PATH = os.path.join(
    os.path.dirname(__file__), "assets", "weight_pins.json"
)


def _pins_path() -> str:
    """Committed pins file, overridable via $FACEGANTTS_WEIGHT_PINS (read
    per call) so drills and tests can trust-on-first-use replica files
    without touching the committed pins."""
    return os.environ.get("FACEGANTTS_WEIGHT_PINS", _DEFAULT_PINS_PATH)

#: name -> (source, importer dotted name) for every external artifact the
#: reference consumes; each importer takes the file's path.
ARTIFACTS: Dict[str, Dict[str, str]] = {
    "facetts_lrs3": {
        "source": "https://github.com/naver-ai/facetts (ckpts/facetts_lrs3.pt; reference config.py:151)",
        "importer": "facegantts_tpu_torch.train.checkpoint:load_facetts_state_dict",
    },
    "syncnet": {
        "source": "reference config.py:60 syncnet_ckpt (HiFi-GAN-trained SyncNet)",
        "importer": "facegantts_tpu_torch.train.checkpoint:load_syncnet_state_dict",
    },
    "hifigan_16k": {
        "source": "torch.hub bshall/hifigan:main 'hifigan' (reference inference.py:79)",
        "importer": "facegantts_tpu_torch.train.checkpoint:load_hifigan_state_dict",
    },
    "utmos22_strong": {
        "source": "https://github.com/sarulab-speech/UTMOS22 strong learner (reference evaluation/eval.py:209-211)",
        "importer": "facegantts_tpu_torch.evaluation.ssl_mos:load_utmos_checkpoint",
    },
}


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _load_pins() -> Dict[str, str]:
    path = _pins_path()
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _save_pins(pins: Dict[str, str]) -> None:
    path = _pins_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(pins, f, indent=2, sort_keys=True)
        f.write("\n")


def verify(name: str, path: str) -> str:
    """Hash `path` and check it against the committed pin for `name`.

    Returns the hex digest on success; raises on unknown artifact, missing
    pin, or mismatch (the controlled-first-contact contract)."""
    if name not in ARTIFACTS:
        raise KeyError(f"unknown artifact {name!r}; known: {sorted(ARTIFACTS)}")
    digest = sha256_file(path)
    pins = _load_pins()
    pin = pins.get(name)
    if pin is None:
        raise RuntimeError(
            f"no pinned SHA256 for {name!r} yet — this is first contact. "
            f"Inspect the file, then record the pin with:\n"
            f"  python -m facegantts_tpu_torch.weights pin {name} {path}\n"
            f"(file hash: {digest})"
        )
    if digest != pin:
        raise RuntimeError(
            f"SHA256 mismatch for {name!r}:\n  pinned  {pin}\n  file    {digest}\n"
            f"Refusing to import {path}. If the upstream artifact legitimately "
            f"changed, re-pin with --force after verifying provenance."
        )
    return digest


def _resolve(dotted: str):
    mod, fn = dotted.split(":")
    import importlib

    return getattr(importlib.import_module(mod), fn)


def load_verified(name: str, path: str, **kwargs) -> Any:
    """verify() then dispatch to the artifact's importer."""
    verify(name, path)
    return _resolve(ARTIFACTS[name]["importer"])(path, **kwargs)


def pin(name: str, path: str, force: bool = False) -> str:
    if name not in ARTIFACTS:
        raise KeyError(f"unknown artifact {name!r}; known: {sorted(ARTIFACTS)}")
    digest = sha256_file(path)
    pins = _load_pins()
    old = pins.get(name)
    if old is not None and old != digest and not force:
        raise RuntimeError(
            f"{name!r} already pinned to {old}; file hashes {digest}. "
            "Use --force only after verifying provenance."
        )
    pins[name] = digest
    _save_pins(pins)
    return digest


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="facegantts_tpu_torch.weights")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="known artifacts, sources, and pin status")
    p_v = sub.add_parser("verify", help="hash a file against its pin")
    p_v.add_argument("name")
    p_v.add_argument("path")
    p_p = sub.add_parser("pin", help="record a file's SHA256 as the pin")
    p_p.add_argument("name")
    p_p.add_argument("path")
    p_p.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.cmd == "list":
        pins = _load_pins()
        for name, meta in sorted(ARTIFACTS.items()):
            state = pins.get(name, "<unpinned>")
            print(f"{name:16s} {state}\n{'':16s} source: {meta['source']}")
        return 0
    if args.cmd == "verify":
        digest = verify(args.name, args.path)
        print(f"OK {args.name} {digest}")
        return 0
    if args.cmd == "pin":
        digest = pin(args.name, args.path, force=args.force)
        print(f"pinned {args.name} {digest}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
