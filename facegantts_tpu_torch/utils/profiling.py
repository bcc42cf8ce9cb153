"""Tracing hooks of the PyTorch port (the JAX package's ``utils/profiling.py``
on ``torch.profiler``).

- :class:`StepProfiler`: traces a configured window of training steps
  (``cfg.profile_dir`` / ``profile_start_step`` / ``profile_num_steps``)
  into a TensorBoard / Chrome trace (``tensorboard_trace_handler``): host
  operators, and the device's kernels when the tensors are on the card.
- :func:`annotate`: a named host span on the trace timeline
  (``torch.profiler.record_function``).
- :class:`StepTimer`: rolling step-time statistics, independent of the
  profiler.
"""

import time
from typing import Dict, Optional

import numpy as np
import torch


class StepProfiler:
    """Trace steps ``start_step`` to ``start_step + num_steps``: call
    :meth:`step` at the start of each training step with the number of
    steps taken, and :meth:`close` at the end of the run.  Nothing is traced
    without ``profile_dir``."""

    def __init__(self, profile_dir: str, start_step: int, num_steps: int, device=None):
        self.dir = profile_dir
        self.start = int(start_step)
        self.stop = int(start_step) + int(num_steps)
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self._prof: Optional[torch.profiler.profile] = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def step(self, step: int) -> None:
        if not self.dir:
            return
        if self._prof is None and step == self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(self.dir))
            self._prof.start()
            print(f"[profile] tracing steps {self.start}..{self.stop} -> {self.dir}")
        elif self._prof is not None and step >= self.stop:
            self.close()
            print(f"[profile] trace written to {self.dir}")

    def close(self) -> None:
        if self._prof is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._prof.stop()
            self._prof = None


def annotate(name: str):
    """Named host span on the profiler timeline (cheap when no trace is
    active)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling step-duration stats (median / p90 / steps-per-sec)."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times = []
        self._t0: Optional[float] = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    def stats(self) -> Dict[str, float]:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        med = float(np.median(t))
        return {
            "step_time_median_s": med,
            "step_time_p90_s": float(np.percentile(t, 90)),
            "steps_per_sec": 1.0 / max(med, 1e-9),
        }
