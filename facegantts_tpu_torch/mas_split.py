"""Time MAS kernels by part, beside the current ``csrc/mas.cu``, on one GPU.

    python -m facegantts_tpu_torch.mas_split SOURCE.cu [SOURCE.cu ...] [--shape B,T_X,T_Y]

Each SOURCE is a version of ``csrc/mas.cu`` of one of two designs, told
apart by their text, and is compiled as it is and with one part cut out at
a time, each with ``kernels.NVCC_FLAGS`` into the git-ignored build
directory:

- the first design (one thread per text row, one block barrier per mel
  column, tiles loaded warp per row, an output pass that re-reads the mask;
  C interface value, mask, path, B, T_x, T_y, threads, shared bytes,
  stream): ``no_loads`` (the tile loads store 0 instead of reading value
  and mask), ``no_output`` (the output pass writes the T_y path cells
  only), ``no_loop`` (the column loop runs no column), ``loop_only``
  (neither loads nor the output pass);
- the warp-synchronous design (DP warps walk the columns, fill groups
  stage the band, a second block zeroes the output; C interface as
  ``ops/mas.py``): ``no_fill`` (no tile is loaded), ``no_dp`` (the DP warps run no column
  but still hand the tiles back; no backtrack), ``no_zero`` (the output is
  not zeroed), ``no_backtrack`` (the path is row tx - 1 in every column),
  ``dp_alone`` (neither tiles nor zeros).

Then it times every variant and the current kernel
(``ops.mas.maximum_path``) in two rounds, the second in reverse order, by
CUDA events (median of 5 means of 20 back-to-back calls) at the shape given
(default the top training buckets, (64, 256, 872), ragged lengths with the
first item full), and prints the card and one JSON line.  Each source as it
is, and the current kernel, must give the plain version's path exactly.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from facegantts_tpu_torch.ops import kernels
from facegantts_tpu_torch.ops import mas

_FIRST_OUTPUT = """  for (int r = warp; r < Tx; r += nwarps) {
    for (int y = lane; y < Ty; y += 32) {
      const size_t at = (size_t)r * Ty + y;
      out[at] = (r < tx && y < ty && idx[y] == r) ? msk[at] : 0.f;
    }
  }"""
_FIRST_LOADS = "tile[lane * (nt + 1) + r] = msk[at] > 0.f ? val[at] : 0.f;"
_FILL = """      if (vec)
        fill_tile<RL, CS, true>(tile, val, msk, Ty, W, tx, ty, t * W, gt, kGroups * W);
      else
        fill_tile<RL, CS, false>(tile, val, msk, Ty, W, tx, ty, t * W, gt, kGroups * W);"""
_ZERO = "for (long long i = tid; i < nvec; i += kThreads) body[i] = z;"
_BACKTRACK = "    if (warp == 0) backtrack<RL, NW>(prog, bits, idx, tx, ty);"
_NO_BACKTRACK = "    if (warp == 0) for (int y = tid; y < ty; y += 32) idx[y] = tx - 1;"
# design -> (a text only its sources hold, {variant: [(cut, replacement)]})
DESIGNS = {
    "first": ("__syncthreads();  // the previous tile is fully consumed", {
        "no_loads": [(_FIRST_LOADS, "tile[lane * (nt + 1) + r] = 0.f;")],
        "no_output": [(_FIRST_OUTPUT, "  for (int y = tid; y < ty; y += nt) "
                                      "out[(size_t)idx[y] * Ty + y] = 1.f;")],
        "no_loop": [("const int ylast = min(kTile, ty - y0);", "const int ylast = 0;")],
        "loop_only": [(_FIRST_LOADS, "tile[lane * (nt + 1) + r] = 0.f;"),
                      (_FIRST_OUTPUT, "  for (int y = tid; y < ty; y += nt) "
                                      "out[(size_t)idx[y] * Ty + y] = 1.f;")],
    }),
    "warp": ("__shfl_up_sync", {
        "no_fill": [(_FILL, "")],
        # no column: no progress is published and the bits stay unwritten, so
        # no backtrack either (the path is row tx - 1 throughout)
        "no_dp": [("for (int yl = 0; yl < ycount; yl += G) {",
                   "for (int yl = 0; yl < 0; yl += G) {"),
                  (_BACKTRACK, _NO_BACKTRACK)],
        "no_zero": [(_ZERO, "")],
        "no_backtrack": [(_BACKTRACK, _NO_BACKTRACK)],
        "dp_alone": [(_FILL, ""), (_ZERO, "")],
    }),
}


def _design(src: str) -> str:
    found = [d for d, (marker, _) in DESIGNS.items() if marker in src]
    if len(found) != 1:
        raise ValueError(f"not a MAS source of a known design (markers found: {found})")
    return found[0]


def build_variants(paths) -> dict:
    """Compile every source and its variants; {label: (design, ctypes fn)}
    with labels ``<source name>`` and ``<source name>:<variant>``."""
    out_dir = os.path.join(kernels.BUILD_DIR, "mas_split")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for path in paths:
        with open(path) as f:
            src = f.read()
        design = _design(src)
        name = os.path.splitext(os.path.basename(path))[0]
        for variant, cuts in [(None, [])] + list(DESIGNS[design][1].items()):
            text = src
            for cut, repl in cuts:
                if cut not in text:
                    raise ValueError(f"{path}: no '{cut.splitlines()[0].strip()}' to cut")
                text = text.replace(cut, repl)
            label = name if variant is None else f"{name}:{variant}"
            stem = os.path.join(out_dir, label.replace(":", "-"))
            with open(stem + ".cu", "w") as f:
                f.write(text)
            procs[label] = (design, stem + ".so", subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", stem + ".so", stem + ".cu"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for label, (design, so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{label}: nvcc exit {proc.returncode}\n{log}")
        fn = ctypes.CDLL(so).fgt_mas_f32
        fn.restype = ctypes.c_int
        fn.argtypes = (list(mas._ARGTYPES) if design == "warp" else
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong,
                                                                     ctypes.c_void_p])
        fns[label] = (design, fn)
    return fns


def _first_config(t_x: int, t_y: int):
    """The first design's (threads, shared bytes): a transposed 32-column
    tile, two columns, 32 floats of scratch, the bits and the path rows."""
    threads = max(32, -(-t_x // 32) * 32)
    return threads, 4 * (32 * (threads + 1) + 2 * threads + 32 + t_y * (threads // 32) + t_y)


def inputs(shape, seed: int = 0):
    """A (B, T_x, T_y) log-prior and mask on the GPU with ragged lengths,
    the first item full size and every text no longer than its mel."""
    b, t_x, t_y = shape
    gen = torch.Generator().manual_seed(seed)
    tx = torch.randint(t_x // 4, t_x + 1, (b,), generator=gen)
    ty = torch.maximum(tx, torch.randint(t_y // 3, t_y + 1, (b,), generator=gen))
    tx[0], ty[0] = t_x, t_y
    value = torch.randn(shape, generator=gen) * 10
    mask = ((torch.arange(t_x)[None, :, None] < tx[:, None, None])
            & (torch.arange(t_y)[None, None, :] < ty[:, None, None])).float()
    return value.cuda(), mask.cuda()


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    shape = (64, 256, 872)
    if "--shape" in argv:
        at = argv.index("--shape")
        shape = tuple(int(v) for v in argv[at + 1].split(","))
        del argv[at:at + 2]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("mas_split: no CUDA device", file=sys.stderr)
        return 1
    fns = build_variants(argv)
    value, mask = inputs(shape)
    b, t_x, t_y = shape
    path = torch.empty_like(value)
    stream = torch.cuda.current_stream().cuda_stream
    first = _first_config(t_x, t_y)
    warp = mas._launch_config(t_x, t_y)
    vec = int(t_y % 4 == 0)

    def launcher(label):
        design, fn = fns[label]
        args = (*first,) if design == "first" else (*warp, vec)

        def run():
            err = fn(value.data_ptr(), mask.data_ptr(), path.data_ptr(), b, t_x, t_y, *args,
                     stream)
            if err:
                raise RuntimeError(f"{label}: cudaError {err}")
        return run

    want = mas.maximum_path_ref(value, mask)
    for label in fns:
        if ":" not in label:
            launcher(label)()
            torch.cuda.synchronize()
            if not torch.equal(path, want):
                raise AssertionError(f"{label}: the path differs from the plain version")
    if not torch.equal(mas.maximum_path(value, mask), want):
        raise AssertionError("the current kernel's path differs from the plain version")
    order = [*fns, "current"]
    runs = {label: [] for label in order}
    for labels in (order, order[::-1]):
        for label in labels:
            runs[label].append(time_ms(launcher(label) if label in fns
                                       else (lambda: mas.maximum_path(value, mask))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"shape": shape, "first_config": first, "warp_config": warp,
                      "ms": runs, "order": order}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
