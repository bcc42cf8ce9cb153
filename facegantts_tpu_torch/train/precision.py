"""Mixed precision of the training steps, as the JAX package computes it.

Port of ``_cast_floats`` / ``_mp_caster`` (JAX package, train/step.py:228-245).
JAX casts every floating leaf of the parameters and the model state to
bfloat16 inside the loss and lets flax run each layer in the promoted dtype
of its input and its parameters.  So a layer fed a bf16 activation computes
in bf16, and a layer fed an f32 one computes in f32 with its bf16-rounded
weights.  f32 enters the model wherever the package asks for f32 results
(``preferred_element_type=jnp.float32`` on every einsum of the models: the
text encoder's attention, FaceTTS's ``mu_y``, the U-Net's linear
attention); from the encoder's first attention layer on, the encoder, the
U-Net of ``compute_loss`` and the sampler's U-Net therefore run in f32 with
bf16 weights, while SyncNet's image stream, the prenet and a bf16
discriminator run in bf16.

:func:`run` calls a module the same way: through
``torch.func.functional_call`` with bf16 copies of its floating parameters
and buffers (SyncNet's BatchNorm statistics included; integer buffers pass
through), with flax's two rules in force where torch's differ:

- a Linear, Conv, ConvTranspose or norm layer computes in the promoted dtype
  of its input and its own parameters and buffers (torch raises on mixed
  ones): forward hooks on the module's layers of these types cast
  whichever side is narrower for the call;
- :func:`einsum`, which the models call for every einsum, computes and
  returns f32 when any operand is not f32.

Both act only inside :func:`run`, on its module and its thread; every other
function runs as called, with no per-op dispatch.  The casts are
differentiable, so the gradients reach the f32 masters; the optimizer
state, the gradient sums and the clip stay f32.  Not ``torch.autocast``:
autocast chooses a dtype per op from its own lists (softmax, norms and
reductions in f32) whatever the operands are, which is another
computation.  Each cast is a kernel launch, forward and backward; casting
all of a module's tensors in one concatenated kernel launched ~1300 fewer
kernels a plain step but was no faster on an H100 (PERF.md §6).
"""

import functools
import threading
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

# flax Dense / Conv / ConvTranspose and the norms: the layers that compute in
# the promoted dtype of their input and parameters
_PROMOTED = frozenset({nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d,
                       nn.GroupNorm, nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d})
_mode = threading.local()  # f32_einsum: inside run() on this thread


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Cast the floating tensors of ``tree`` (tensors, tuples, NamedTuples,
    lists, dicts) to ``dtype``; integer and bool tensors and other leaves
    pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_floats(v, dtype) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; inside :func:`run`, an einsum of any operand that is
    not f32 computes in f32 and returns f32 (the JAX models'
    ``preferred_element_type=jnp.float32``)."""
    if getattr(_mode, "f32_einsum", False) and any(o.dtype != torch.float32
                                                   for o in operands):
        operands = tuple(o.float() for o in operands)
    return torch.einsum(equation, *operands)


def _promote(swapped: Dict, module: nn.Module, args):
    """Forward pre-hook: the input and the layer's own floating tensors in
    their promoted dtype, the originals kept in ``swapped`` for
    :func:`_restore`."""
    x = args[0]
    own = {k: t for d in (module._parameters, module._buffers) for k, t in d.items()
           if t is not None and t.is_floating_point()}
    dtype = x.dtype
    for t in own.values():
        dtype = torch.promote_types(dtype, t.dtype)
    if any(t.dtype != dtype for t in own.values()):
        swapped[module] = dict(module._parameters), dict(module._buffers)
        for d in (module._parameters, module._buffers):
            for k in d:
                if k in own:
                    d[k] = own[k].to(dtype)
    return None if x.dtype == dtype else (x.to(dtype), *args[1:])


def _restore(swapped: Dict, module: nn.Module, args, out):
    saved = swapped.pop(module, None)
    if saved is not None:
        module._parameters.update(saved[0])
        module._buffers.update(saved[1])


class _Method(torch.nn.Module):
    """``functional_call`` calls ``forward``: this one calls a named method."""

    def __init__(self, module: torch.nn.Module, method: str):
        super().__init__()
        self.m, self.method = module, method

    def forward(self, *args, **kwargs):
        return getattr(self.m, self.method)(*args, **kwargs)


def run(module: torch.nn.Module, dtype: torch.dtype, *args, method: str = "forward",
        **kwargs):
    """``module.<method>(*args, **kwargs)`` with every floating parameter and
    buffer cast to ``dtype`` (differentiably), under flax's promotion rules;
    the arguments are passed as they are."""
    tensors = {f"m.{n}": cast_floats(t, dtype) for n, t in
               list(module.named_parameters()) + list(module.named_buffers())}
    swapped: Dict = {}
    hooks = [h for m in module.modules() if type(m) in _PROMOTED
             for h in (m.register_forward_pre_hook(functools.partial(_promote, swapped)),
                       m.register_forward_hook(functools.partial(_restore, swapped)))]
    outer, _mode.f32_einsum = getattr(_mode, "f32_einsum", False), True
    try:
        return torch.func.functional_call(_Method(module, method), tensors, args, kwargs)
    finally:
        _mode.f32_einsum = outer
        for h in hooks:
            h.remove()


def call_as_is(module: torch.nn.Module, *args, method: str = "forward", **kwargs):
    """``module.<method>(*args, **kwargs)``: the ``call`` of a disabled caster."""
    return getattr(module, method)(*args, **kwargs)


def mp_caster(enabled: bool) -> Tuple[Callable, Callable, Callable]:
    """(down, up, call) of ``train_bf16`` (or ``disc_bf16`` for the D phase):
    ``down`` casts floating tensors to bf16, ``up`` back to f32, ``call(module,
    *args, method=..., **kwargs)`` runs a module as :func:`run` does.  All
    three leave their arguments as they are when ``enabled`` is false."""
    if not enabled:
        return (lambda t: t), (lambda t: t), call_as_is

    def down(tree):
        return cast_floats(tree, torch.bfloat16)

    def up(tree):
        return cast_floats(tree, torch.float32)

    def call(module, *args, method="forward", **kwargs):
        return run(module, torch.bfloat16, *args, method=method, **kwargs)

    return down, up, call
