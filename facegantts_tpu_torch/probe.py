"""Backend probe of the PyTorch port: the counterpart of
``scripts/pallas_probe.py``.

    python -m facegantts_tpu_torch.probe [device=cpu]

Runs the two probe kernels of ``csrc/probe.cu`` and prints their times:

- P1 (``probe_trivial``, replaces ``scripts/pallas_probe.py:16``): 2x + 1 on
  a (256, 256) f32 array, checked against 3.0 on ones;
- P2 (``probe_dp_loop``, replaces ``scripts/pallas_probe.py:36``): the
  column-scan DP of the MAS access pattern over (T_y, B, T_x) f32,
  ``new = col + max(prev, roll(prev, 1, T_x))`` with a zero carry and every
  column written out; the roll wraps around (the shifted value at x = 0 is
  ``prev[T_x - 1]``), so this is not MAS.  Checked against its plain version.

Each kernel has its plain torch version beside it (the ``*_ref``
functions); a CPU tensor takes the plain version, a CUDA tensor the kernel
or an error.  The probe runs on the GPU unless ``device=cpu``.
"""

import ctypes
import statistics
import sys
import time

import torch

from facegantts_tpu_torch.ops import kernels

P1_NAME = "probe_trivial"
P2_NAME = "probe_dp_loop"
P1_SHAPE = (256, 256)
P2_SHAPE = (256, 8, 128)  # (T_y, B, T_x), the Pallas probe's default


_P = ctypes.c_void_p
# fgt_probe_trivial_f32(x, y, n, stream); fgt_probe_dp_loop_f32(v, out, T_y, B, T_x,
# rows a lane, stream)
P1_ARGTYPES = (_P, _P, ctypes.c_longlong, _P)
P2_ARGTYPES = (_P, _P) + (ctypes.c_int,) * 4 + (_P,)
_p1 = None  # the C entries, resolved at their first launch
_p2 = None
# P1's launch path reads module globals, not torch's attributes: at the
# probe's size each lookup is a visible share of the call
_F32 = torch.float32
_empty_like = torch.empty_like
_launches = kernels.LAUNCHES
# None in a CPU-only build, where no tensor reaches the launch
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _resolve_p1():
    global _p1
    _p1 = kernels.entry("probe", "fgt_probe_trivial_f32", P1_ARGTYPES)
    return _p1


def _resolve_p2():
    global _p2
    _p2 = kernels.entry("probe", "fgt_probe_dp_loop_f32", P2_ARGTYPES)
    return _p2


def _check_cuda(name: str, x: torch.Tensor, ndim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != ndim or x.dtype != torch.float32 or not x.is_contiguous() or not x.numel():
        raise ValueError(f"{name}: x must be a contiguous non-empty float32 tensor of "
                         f"{ndim} dims, got {x.dtype} {tuple(x.shape)}")


def probe_trivial_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain torch P1: 2x + 1."""
    return x * 2.0 + 1.0


def probe_trivial(x: torch.Tensor) -> torch.Tensor:
    """P1: 2x + 1 (kernel on a CUDA tensor, plain version on a CPU one).

    The launch path is kept short, since at the probe's size the host's
    call costs more than the kernel: one handle to the C entry, the raw
    stream handle, and the checks in as few attribute reads as they need."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return probe_trivial_ref(x)
        raise ValueError(f"{P1_NAME}: unsupported device {x.device}")
    n = x.numel()
    if x.dtype is not _F32 or not n or not x.is_contiguous():
        raise ValueError(f"{P1_NAME}: x must be a contiguous non-empty float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    y = _empty_like(x)
    err = (_p1 or _resolve_p1())(x.data_ptr(), y.data_ptr(), n, _raw_stream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"{P1_NAME}: CUDA kernel launch failed (cudaError {err})")
    _launches[P1_NAME] += 1
    return y


def probe_dp_loop_ref(v: torch.Tensor) -> torch.Tensor:
    """Plain torch P2 over (T_y, B, T_x): zero carry, wrap-around roll."""
    prev = torch.zeros_like(v[0])
    out = torch.empty_like(v)
    for y in range(v.shape[0]):
        prev = v[y] + torch.maximum(prev, torch.roll(prev, 1, dims=1))
        out[y] = prev
    return out


def dp_rows_per_lane(t_x: int) -> int:
    """Rows of the carry each of a warp's 32 lanes keeps in P2's kernel:
    ceil(T_x / 32) rounded up to a power of two (csrc/probe.cu)."""
    rows = 1
    while 32 * rows < t_x:
        rows *= 2
    return rows


def probe_dp_loop(v: torch.Tensor) -> torch.Tensor:
    """P2 (kernel on a CUDA tensor, plain version on a CPU one); T_x <= 1024.
    One warp per batch item, the carry in registers (csrc/probe.cu)."""
    if v.device.type == "cpu":
        return probe_dp_loop_ref(v)
    _check_cuda(P2_NAME, v, 3)
    t_y, b, t_x = v.shape
    if t_x > 1024:
        raise ValueError(f"{P2_NAME}: T_x={t_x} > 1024")
    out = torch.empty_like(v)
    err = (_p2 or _resolve_p2())(v.data_ptr(), out.data_ptr(), t_y, b, t_x,
                                 dp_rows_per_lane(t_x), _raw_stream(v.get_device()))
    if err != 0:
        raise RuntimeError(f"{P2_NAME}: CUDA kernel launch failed (cudaError {err})")
    kernels.LAUNCHES[P2_NAME] += 1
    return out


def _median_ms(fn, device: torch.device, n: int = 10) -> float:
    fn()
    times = []
    for _ in range(n):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(device=None) -> dict:
    """Run and check both probes on ``device`` (default: the GPU, which must
    exist); returns {probe: median ms of 10 calls}."""
    from facegantts_tpu_torch.synthesis import resolve_device

    device = resolve_device(device)
    x = torch.ones(P1_SHAPE, device=device)
    if not torch.equal(probe_trivial(x), torch.full_like(x, 3.0)):
        raise AssertionError(f"{P1_NAME}: 2 * 1 + 1 != 3")
    gen = torch.Generator().manual_seed(0)
    v = torch.randn(P2_SHAPE, generator=gen).to(device)
    if not torch.equal(probe_dp_loop(v), probe_dp_loop_ref(v)):
        raise AssertionError(f"{P2_NAME}: kernel and plain version disagree")
    return {P1_NAME: _median_ms(lambda: probe_trivial(x), device),
            P2_NAME: _median_ms(lambda: probe_dp_loop(v), device)}


def main(argv=None):
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    ms = run(args.get("device"))
    t_y, b, t_x = P2_SHAPE
    print(f"trivial kernel {P1_SHAPE}: OK, {ms[P1_NAME]:.3f} ms")
    print(f"DP loop kernel ({b}x{t_x}x{t_y}): OK, {ms[P2_NAME]:.3f} ms")


if __name__ == "__main__":
    main()
