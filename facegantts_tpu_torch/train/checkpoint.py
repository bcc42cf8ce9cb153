"""Checkpoints of the PyTorch port: save, restore, retention, and the
imports of reference torch weights.

The counterpart of the JAX package's ``train/checkpoint.py`` in a torch
format.  A checkpoint directory holds one numbered directory per step,
``<dir>/<step>/``, with one ``torch.save`` file (:data:`CKPT_FILE`): the
step, the generator's ``state_dict`` (SyncNet's BatchNorm running
statistics included), its optimizer's state and, for the GAN, the
discriminator and its optimizer.  Each step is written into a temporary
directory and renamed into place, so a kill mid-save leaves every earlier
step restorable, as orbax's atomic saves do.  As with orbax, a step at or
before a directory's newest step is not written again.

The importers read the reference's external weights: a FaceTTS ``.pt`` /
Lightning ``.ckpt`` (:func:`load_facetts_state_dict` and
:func:`merge_state_dict`: the GAN keys stripped, then strict=False by name
and shape) and a bshall HiFi-GAN-16k generator with weight norm folded
(:func:`load_hifigan_state_dict`).  The port keeps the reference's
parameter names, so neither renames anything.
"""

import json
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

import torch

CKPT_FILE = "state.pt"
METRICS_FILE = "metrics.json"
_TMP = ".tmp-"


# ---------------------------------------------------------------------------
# one directory of numbered steps


def state_payload(state) -> dict:
    """What a checkpoint holds of a :class:`TrainState`."""
    out = {"step": int(state.step), "model": state.model.state_dict(),
           "optimizer": state.optimizer.state_dict()}
    if state.disc is not None:
        out["disc"] = state.disc.state_dict()
        out["disc_optimizer"] = state.disc_optimizer.state_dict()
    return out


def all_steps(ckpt_dir: str) -> List[int]:
    """The steps of ``ckpt_dir`` that hold a whole checkpoint, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.isfile(os.path.join(ckpt_dir, d, CKPT_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


class _Manager:
    """The numbered steps of one directory: keeps the newest ``keep`` or,
    with ``monitor``, the ``keep`` of least monitored value (a step without
    one is not kept), as orbax's ``CheckpointManager`` with ``best_fn`` and
    ``best_mode="min"`` does."""

    def __init__(self, root: str, keep: int, monitor: Optional[str] = None):
        self.root, self.keep, self.monitor = root, keep, monitor
        os.makedirs(root, exist_ok=True)
        for d in os.listdir(root):  # the leftovers of a save that was killed
            if d.startswith(_TMP):
                shutil.rmtree(os.path.join(root, d), ignore_errors=True)

    def save(self, step: int, state, metrics: Optional[Dict[str, float]] = None) -> bool:
        steps = all_steps(self.root)
        if steps and step <= steps[-1]:
            return False
        tmp = os.path.join(self.root, f"{_TMP}{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            torch.save(state_payload(state), os.path.join(tmp, CKPT_FILE))
            if metrics is not None:
                with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                    json.dump(metrics, f)
            final = os.path.join(self.root, str(step))
            shutil.rmtree(final, ignore_errors=True)  # an incomplete step of that number
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        return True

    def _metric(self, step: int) -> Optional[float]:
        try:
            with open(os.path.join(self.root, str(step), METRICS_FILE)) as f:
                return float(json.load(f)[self.monitor])
        except (OSError, KeyError, ValueError):
            return None

    def _prune(self) -> None:
        steps = all_steps(self.root)
        if self.monitor is None:
            drop = steps[:-self.keep] if self.keep > 0 else steps
        else:
            ranked = sorted((m, s) for s, m in ((s, self._metric(s)) for s in steps)
                            if m is not None)
            kept = {s for _, s in ranked[:self.keep]}
            drop = [s for s in steps if s not in kept]
        for s in drop:
            shutil.rmtree(os.path.join(self.root, str(s)))


def save_checkpoint(ckpt_dir: str, state, step: int, keep: int = 3) -> None:
    """Save ``state`` at ``step``, keeping the newest ``keep`` steps."""
    _Manager(os.path.abspath(ckpt_dir), keep).save(step, state)


def _read(ckpt_dir: str, step: Optional[int]) -> Optional[dict]:
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    return torch.load(os.path.join(ckpt_dir, str(step), CKPT_FILE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Load the newest (or the given) step of ``ckpt_dir`` into ``state`` in
    place: model, optimizer, and for the GAN the discriminator and its
    optimizer, and ``state.step``.  Returns ``state``, or None when the
    directory holds no numbered step."""
    payload = _read(ckpt_dir, step)
    if payload is None:
        return None
    if ("disc" in payload) != (state.disc is not None):
        raise ValueError(
            f"{ckpt_dir}: a checkpoint of the {'GAN' if 'disc' in payload else 'plain'} "
            f"step cannot resume a {'GAN' if state.disc is not None else 'plain'} run "
            "(use_gan differs)")
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    if state.disc is not None:
        state.disc.load_state_dict(payload["disc"])
        state.disc_optimizer.load_state_dict(payload["disc_optimizer"])
    state.step = int(payload["step"])
    return state


def restore_generator_state_dict(ckpt_dir: str, step: Optional[int] = None
                                 ) -> Optional[Dict[str, torch.Tensor]]:
    """The generator's ``state_dict`` of the newest (or the given) step, with
    no optimizer built (the JAX ``restore_generator_variables``); None when
    the directory holds no numbered step."""
    payload = _read(ckpt_dir, step)
    return None if payload is None else payload["model"]


class CheckpointPolicy:
    """The reference's retention policy (JAX package ``CheckpointPolicy``):

    - ``<work>/checkpoints``: the top ``keep_top_k`` ranked by ``monitor``
      (min); the worst is evicted whatever its age;
    - ``<work>/last``: the newest :meth:`save_step` save;
    - ``<work>/snapshots/epoch_<e>/<step>`` for ``e`` in ``snapshot_epochs``;
    - ``<work>/best/<step>``: the best state so far, and a
      ``best_epoch_<E>_step_<S>`` symlink beside it that replaces the
      previous one (without symlinks, ``best/`` is what counts)."""

    def __init__(self, work_dir: str, keep_top_k: int = 3, monitor: str = "total_loss",
                 snapshot_epochs: Tuple[int, ...] = (0, 96)):
        self.work_dir = os.path.abspath(work_dir)
        self.monitor = monitor
        self.snapshot_epochs = set(snapshot_epochs)
        self.best = float("inf")
        self.best_name: Optional[str] = None
        self.top = _Manager(os.path.join(self.work_dir, "checkpoints"), keep_top_k, monitor)
        self.last = _Manager(os.path.join(self.work_dir, "last"), 1)
        self.best_mgr = _Manager(os.path.join(self.work_dir, "best"), 1)

    def save_step(self, state, step: int) -> None:
        """Periodic save -> ``<work>/last`` (the newest only)."""
        self.last.save(step, state)

    def snapshot(self, state, step: int, epoch: int) -> None:
        """Fixed-epoch snapshot; a no-op unless ``epoch`` is in
        ``snapshot_epochs``."""
        if epoch in self.snapshot_epochs:
            _Manager(os.path.join(self.work_dir, "snapshots", f"epoch_{epoch}"), 1).save(
                step, state)

    def save_epoch(self, state, step: int, epoch: int, metrics: Dict[str, float],
                   with_snapshot: bool = True) -> bool:
        """Ranked save with the monitored value, the epoch snapshot unless
        ``with_snapshot=False``, and the best copy.  Returns whether the
        monitored value improved."""
        value = float(metrics[self.monitor])
        self.top.save(step, state, metrics={self.monitor: value})
        if with_snapshot:
            self.snapshot(state, step, epoch)
        improved = value < self.best
        if improved:
            self.best = value
            self.best_mgr.save(step, state)
            if self.best_name:
                old = os.path.join(self.work_dir, self.best_name)
                if os.path.islink(old):
                    os.unlink(old)
            self.best_name = f"best_epoch_{epoch}_step_{step}"
            try:
                os.symlink(os.path.join("best", str(step)),
                           os.path.join(self.work_dir, self.best_name))
            except OSError:
                pass  # a filesystem without symlinks: best/ is what counts
        return improved


# ---------------------------------------------------------------------------
# reference torch weights


def load_facetts_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference FaceTTS ``.pt`` / Lightning ``.ckpt`` -> its generator
    ``state_dict`` (the ``state_dict`` entry when there is one), without the
    ``discriminator*`` and ``feature_extractor*`` keys (the JAX
    ``import_facetts``).  Lightning files pickle more than tensors, so this
    loads with ``weights_only=False``, as the JAX package does: read only
    files you trust."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw)
    return {k: v for k, v in sd.items()
            if not k.startswith(("discriminator", "feature_extractor"))}


def load_syncnet_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference SyncNet file (``syncnet_ckpt``) -> its ``state_dict`` (the
    ``state_dict`` entry when there is one; the JAX
    ``import_syncnet_checkpoint``).  Loads with ``weights_only=False``, as
    the JAX package does: read only files you trust."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    return raw.get("state_dict", raw)


def merge_state_dict(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> List[str]:
    """strict=False by name and shape (the JAX ``merge_imported``): each key
    of ``sd`` that ``model`` has with the same shape is copied in; every
    other parameter and buffer keeps its value.  Returns the keys copied."""
    own = model.state_dict()
    loaded = []
    with torch.no_grad():
        for k, v in sd.items():
            if k in own and tuple(own[k].shape) == tuple(v.shape):
                own[k].copy_(v)
                loaded.append(k)
    return loaded


def fold_weight_norm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torch ``weight_norm`` pairs (``weight_g``, ``weight_v``) -> plain
    ``weight`` = g * v / |v|, the norm over every axis but 0 (also for a
    ``ConvTranspose1d``, as ``weight_norm``'s default ``dim=0`` takes it)."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            name = k[:-len("_v")]
            v = v.float()
            norm = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
            out[name] = sd[name + "_g"].float() * v / norm
        else:
            out[k] = v
    return out


def load_hifigan_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A bshall HiFi-GAN-16k generator file -> the port's
    ``HiFiGANGenerator`` ``state_dict``: the ``generator`` entry, else
    ``state_dict``, else the whole file; a ``module.`` or ``generator.``
    prefix stripped; weight norm folded (the JAX ``import_hifigan``).
    Loads with ``weights_only=False``, as the JAX package does."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("generator", raw.get("state_dict", raw))
    sd = {re.sub(r"^(module\.|generator\.)", "", k): v for k, v in sd.items()}
    return fold_weight_norm(sd)


def generator_state_dict(cfg, path: str, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The generator weights that ``resume_from`` names, for inference and
    serving: a port checkpoint directory's newest step, or a reference
    file merged by :func:`merge_state_dict` into a FaceTTS of ``cfg``
    initialised from ``seed`` (the keys the file lacks keep that
    initialisation, as in a Synthesizer built from ``seed``)."""
    if os.path.isdir(path):
        sd = restore_generator_state_dict(path)
        if sd is None:
            raise FileNotFoundError(f"resume_from={path!r}: no numbered checkpoint step")
        return sd
    if not os.path.exists(path):
        raise FileNotFoundError(f"resume_from={path!r}: no such file or directory")
    from facegantts_tpu_torch.models.facetts import FaceTTS

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = FaceTTS.from_config(cfg)
    merge_state_dict(model, load_facetts_state_dict(path))
    return model.state_dict()
