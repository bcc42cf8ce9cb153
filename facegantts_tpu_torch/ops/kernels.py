"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface.  At
first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``facegantts_tpu_torch/build/`` (named by a hash of the source, so an
edited source is rebuilt) and loaded with ``ctypes``.  Nothing here runs at
import time: the package imports on hosts without ``nvcc`` or a GPU, where
the wrappers take their plain torch versions for CPU tensors.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched the kernel
on the GPU, so a run can show that its path went through the kernels.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# kernel name -> source file under csrc/
SOURCES = {"gn_mish": "gn_mish.cu", "mas": "mas.cu", "groupnorm": "groupnorm.cu",
           "probe": "probe.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet.

    One ``nvcc`` per source, all started together.  Returns, per kernel,
    ``{"path", "log"}``; ``log`` holds ptxas's register and shared-memory
    report for a fresh build.  Raises if a compile fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path):
            out[name] = {"path": path, "log": "cached"}
            continue
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": path, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def recompute_vjp(fn, inputs, needs, g, *args):
    """Gradients of ``fn(*inputs, *args)`` against ``g``, recomputed under
    autograd from detached inputs: the backward of a kernel whose JAX
    counterpart is a ``custom_vjp`` over its plain version.  ``needs`` says
    which inputs want a gradient; the others get None."""
    with torch.enable_grad():
        xs = [v.detach().requires_grad_(n) for v, n in zip(inputs, needs)]
        wanted = [v for v in xs if v.requires_grad]
        grads = iter(torch.autograd.grad(fn(*xs, *args), wanted, g) if wanted else ())
    return tuple(next(grads) if v.requires_grad else None for v in xs)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name]["path"])
            _libs[name] = lib
        return lib
