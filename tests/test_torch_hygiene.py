"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package nor ``transformers``, and ``matplotlib`` only inside the functions
that plot (the GPU machine has neither), its entry points never move to the
CPU on their own, and ``chip_smoke.py`` fails (with no result line) where it
cannot run."""

import ast
import importlib
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import facegantts_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "facegantts_tpu_torch")
PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")
) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "facegantts_tpu", "transformers")
# absent on the GPU machine: a port module imports it only inside a function
LAZY = ("matplotlib",)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        facegantts_tpu_torch.__path__, "facegantts_tpu_torch."))


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONSTARTUP", None)
    return env


def test_port_imports_with_jax_blocked():
    """Every module imports in a fresh interpreter where importing jax, flax,
    the JAX package, transformers or matplotlib fails."""
    mods = _port_modules()
    assert {"facegantts_tpu_torch.synthesis", "facegantts_tpu_torch.train.loop",
            "facegantts_tpu_torch.ops.mas", "facegantts_tpu_torch.probe",
            "facegantts_tpu_torch.models.discriminator", "facegantts_tpu_torch.serve",
            "facegantts_tpu_torch.train.checkpoint", "facegantts_tpu_torch.models.wav2vec2",
            "facegantts_tpu_torch.evaluation.ssl_mos", "facegantts_tpu_torch.evaluation.analysis",
            "facegantts_tpu_torch.weights", "facegantts_tpu_torch.hyperopt"} <= set(mods)
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN + LAZY)
        + "import importlib\n"
        + f"for m in {mods!r}:\n    importlib.import_module(m)\n"
        + "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_or_jax_package_import(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    in_functions = {id(n) for fn in ast.walk(tree)
                    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                    for n in ast.walk(fn)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {n}"
            assert n.split(".")[0] not in LAZY or id(node) in in_functions, (
                f"{path}:{node.lineno} imports {n} outside a function")


def test_synthesizer_without_cuda_raises(monkeypatch):
    from facegantts_tpu_torch.config import Config
    from facegantts_tpu_torch.synthesis import Synthesizer, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesizer(Config())
    assert resolve_device("cpu") == torch.device("cpu")


def test_trainer_and_probe_without_cuda_raise(monkeypatch):
    """The training entry point and the probe default to the card, too."""
    from facegantts_tpu_torch import probe
    from facegantts_tpu_torch.config import Config
    from facegantts_tpu_torch.train import __main__ as train_main
    from facegantts_tpu_torch.train.loop import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(Config(use_gan=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(Config())  # use_gan=1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main.main(["use_gan=0", "max_steps=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main([])


def test_server_without_cuda_raises(monkeypatch, tmp_path):
    """The server defaults to the card: without one it raises before it
    reads a weight file or binds a port."""
    from facegantts_tpu_torch import serve
    from facegantts_tpu_torch.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["port=0", f"resume_from={tmp_path / 'missing'}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.SynthesisService(Config())


def test_kernel_sources_present_and_built_for_sm90a():
    from facegantts_tpu_torch.ops import kernels

    for src in kernels.SOURCES.values():
        assert os.path.exists(os.path.join(kernels.CSRC_DIR, src))
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert kernels.BUILD_DIR == os.path.join(PKG, "build")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from facegantts_tpu_torch.ops import kernels

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if shutil.which("nvcc"):
        pytest.skip("nvcc still reachable")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          env=dict(_env(), PYTHONPATH=""), cwd=cwd, timeout=300)


def test_chip_smoke_fails_without_cuda():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "cannot import the port" in out.stderr


def test_port_package_layout_mirrors_jax_package():
    """Each ported module sits at the JAX package's path."""
    for mod in ("config", "synthesis", "ops.align", "ops.gn_mish", "ops.mas",
                "ops.groupnorm", "models.unet", "models.diffusion", "models.text_encoder",
                "models.syncnet", "models.facetts", "models.hifigan", "models.discriminator",
                "text.cmudict", "models.wav2vec2", "evaluation.ssl_mos", "evaluation.analysis",
                "weights", "hyperopt",
                "utils.audio", "data.dataset", "train.state", "train.optim", "train.step",
                "train.loop", "train.checkpoint", "serve"):
        importlib.import_module(f"facegantts_tpu_torch.{mod}")
        assert os.path.exists(os.path.join(ROOT, "facegantts_tpu", *mod.split(".")) + ".py")
