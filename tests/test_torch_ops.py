"""PyTorch port ops against the JAX package: kernel K1's plain version
(``gn_mish_mask_ref``) against ``_xla_chain`` and the Pallas kernel in
interpret mode, its closed-form backward (``gn_mish_mask_bwd_ref``, the
backward kernel's plain version) against ``jax.vjp`` of ``_xla_chain``, its
gradient through the wrapper against the JAX ``custom_vjp``, the K1
wrapper's CPU route, its checks and its launch plan; K2's GroupNorm (statistics, output and gradient)
against the JAX Pallas path and ``_xla_group_norm``; the probes P1 and P2
against a numpy transcription of the Pallas bodies; and ``ops/align`` held
to exact equality.  MAS against JAX is in ``tests/test_torch_train.py``.

Inputs come from numpy with a seed and go through both frameworks; layouts
are permuted NHWC <-> NCHW at the boundary.  The CUDA kernel itself runs
only on a GPU (``gpu`` marker).  JAX is imported inside the tests, so the
``gpu`` tests also run where JAX is absent:
``python -m pytest --noconftest tests/test_torch_ops.py -m gpu``."""

import numpy as np
import pytest
import torch

from facegantts_tpu_torch.ops import align as talign
from facegantts_tpu_torch.ops import gn_mish as tgn
from facegantts_tpu_torch.ops import kernels
from torch_cpu import torch_threads_started  # noqa: F401


def _gn_inputs(shape, seed, dtype=np.float32):
    """NHWC (B, F, T, C) numpy inputs with partial lengths."""
    rng = np.random.default_rng(seed)
    b, f, t, c = shape
    x = (rng.standard_normal(shape) * 2 - 0.5).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.5 + 1).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    lens = np.array([t - 3, t, max(1, t // 2)][:b], np.int32)
    return x, scale, bias, lens


def _torch_gn(x, scale, bias, lens, dtype=torch.float32):
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype)  # NCHW
    y = tgn.gn_mish_mask_ref(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                             torch.from_numpy(lens))
    return y.float().numpy().transpose(0, 2, 3, 1)


# Pallas shapes of tests/test_ops.py plus C=32, which the TPU kernel does
# not take (it falls back to _xla_chain) but the CUDA kernel does
@pytest.mark.parametrize("shape", [(2, 8, 26, 64), (1, 4, 16, 128), (2, 4, 10, 256),
                                   (3, 6, 20, 32)])
def test_gn_mish_ref_matches_jax_f32(shape):
    import jax.numpy as jnp

    from facegantts_tpu.ops.gn_mish import _fused_chain, _xla_chain

    x, scale, bias, lens = _gn_inputs(shape, seed=sum(shape))
    got = _torch_gn(x, scale, bias, lens)
    want = np.asarray(_xla_chain(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                 jnp.asarray(lens), 8, 1e-5))
    # f32 sums in another order: a few ulp of the normalised values
    np.testing.assert_allclose(got, want, atol=3e-5)
    if shape[-1] in (64, 128, 256):
        pallas = np.asarray(_fused_chain(jnp.asarray(x), jnp.asarray(scale),
                                         jnp.asarray(bias), jnp.asarray(lens), 8, 1e-5,
                                         interpret=True))
        np.testing.assert_allclose(got, pallas, atol=3e-5)
    # the masked tail is exactly zero
    for i, n in enumerate(lens):
        assert not got[i, :, n:].any()


def test_gn_mish_ref_matches_jax_bf16():
    import jax.numpy as jnp

    from facegantts_tpu.ops.gn_mish import _fused_chain, _xla_chain

    x, scale, bias, lens = _gn_inputs((2, 8, 32, 64), seed=5)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = _torch_gn(np.asarray(xb.astype(jnp.float32)), scale, bias, lens,
                    dtype=torch.bfloat16)
    want = _xla_chain(xb, jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(lens), 8, 1e-5)
    pallas = _fused_chain(xb, jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(lens),
                          8, 1e-5, interpret=True)
    # one bf16 rounding of the output (values up to ~10): tests/test_ops.py's bar
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=0.05)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), atol=0.05)


def test_gn_mish_wrapper_cpu_takes_plain_version():
    x, scale, bias, lens = _gn_inputs((2, 4, 12, 64), seed=9)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    args = (torch.from_numpy(scale), torch.from_numpy(bias), torch.from_numpy(lens))
    before = kernels.LAUNCHES[tgn.NAME]
    got = tgn.gn_mish_mask(xt, *args)
    assert torch.equal(got, tgn.gn_mish_mask_ref(xt, *args))
    assert kernels.LAUNCHES[tgn.NAME] == before  # no kernel launched on the CPU


def test_gn_mish_wrapper_refuses_other_devices():
    x = torch.zeros(1, 8, 2, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tgn.gn_mish_mask(x, torch.ones(8), torch.zeros(8), torch.ones(1, dtype=torch.int32))


def test_mish_matches_jax():
    import jax.numpy as jnp

    from facegantts_tpu.models.unet import mish as jmish
    from facegantts_tpu_torch.models.unet import mish as tmish

    x = np.linspace(-100, 100, 20001, dtype=np.float32)
    got = tmish(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmish(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_mish_cuda_kernel_matches_plain(dtype):
    """The CUDA kernel against its plain version on the card (skips without
    one; chip_smoke.py runs the same check at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch_dtype = getattr(torch, dtype)
    # (2, 3, 5, 24): slabs of 45 elements, not 16-byte aligned: plain copies
    for shape in [(2, 8, 26, 64), (1, 4, 16, 128), (2, 4, 10, 256), (3, 6, 20, 32),
                  (2, 3, 5, 24)]:
        x, scale, bias, lens = _gn_inputs(shape, seed=1)
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to("cuda", torch_dtype)
        # the same values in a view at an odd offset: plain copies as well
        shifted = torch.empty(xt.numel() + 1, dtype=torch_dtype, device="cuda")[1:]
        shifted = shifted.view(xt.shape).copy_(xt)
        args = [torch.from_numpy(a).cuda() for a in (scale, bias, lens)]
        want = tgn.gn_mish_mask_ref(xt, *args).float()
        atol = 1e-4 if dtype == "float32" else 0.05
        for v in (xt, shifted):
            got = tgn.gn_mish_mask(v, *args).float()
            torch.cuda.synchronize()
            assert (got - want).abs().max().item() <= atol


@pytest.mark.gpu
def test_gn_mish_cuda_wrapper_refuses_bad_inputs():
    """On a CUDA tensor the wrapper launches the kernel or raises: no plain
    fallback for shapes, types or layouts the kernel does not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.randn(2, 64, 4, 10, device="cuda")
    scale, bias = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    lens = torch.full((2,), 10, dtype=torch.int32, device="cuda")
    before = kernels.LAUNCHES[tgn.NAME]
    with pytest.raises(TypeError):
        tgn.gn_mish_mask(x.half(), scale, bias, lens)
    with pytest.raises(ValueError, match="contiguous"):
        tgn.gn_mish_mask(x.transpose(2, 3), scale, bias, lens)
    with pytest.raises(ValueError, match="divisible"):
        tgn.gn_mish_mask(x, scale, bias, lens, num_groups=7)
    with pytest.raises(ValueError, match="lens"):
        tgn.gn_mish_mask(x, scale, bias, lens.long())
    assert kernels.LAUNCHES[tgn.NAME] == before
    with torch.no_grad():
        tgn.gn_mish_mask(x, scale, bias, lens)
    assert kernels.LAUNCHES[tgn.NAME] == before + 1
    # an input that needs a gradient launches the forward kernel too, and
    # its backward launches the backward kernel once
    bwd_before = kernels.LAUNCHES[tgn.BWD_NAME]
    tgn.gn_mish_mask(x.requires_grad_(), scale, bias, lens).sum().backward()
    assert kernels.LAUNCHES[tgn.NAME] == before + 2 and x.grad is not None
    assert kernels.LAUNCHES[tgn.BWD_NAME] == bwd_before + 1


def _k1_grads(fn, x, scale, bias, lens):
    """Gradients of sum(sin(fn(...))) w.r.t. x, scale, bias (NCHW torch)."""
    args = [v.clone().requires_grad_() for v in (x, scale, bias)]
    torch.sin(fn(*args, lens)).sum().backward()
    return [v.grad for v in args]


def test_gn_mish_grad_matches_jax():
    """K1's gradient through the port's wrapper (the plain chain on the CPU)
    against jax.grad of the JAX gn_mish_mask (custom_vjp), as
    tests/test_ops.py holds the JAX backward."""
    import jax
    import jax.numpy as jnp

    from facegantts_tpu.ops.gn_mish import gn_mish_mask as jgn

    x, scale, bias, lens = _gn_inputs((2, 4, 12, 64), seed=13)
    want = jax.grad(
        lambda a, s, b: jnp.sum(jnp.sin(jgn(a, s, b, jnp.asarray(lens), 8, 1e-5))),
        (0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = _k1_grads(tgn.gn_mish_mask, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                    torch.from_numpy(scale), torch.from_numpy(bias), torch.from_numpy(lens))
    np.testing.assert_allclose(got[0].numpy().transpose(0, 2, 3, 1), np.asarray(want[0]),
                               atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def _bwd_inputs(shape, seed):
    """NHWC inputs whose affine pushes z = xn * scale + bias past +20 and
    below -20 (both sides of Mish's clamp), and an upstream gradient."""
    x, _, _, lens = _gn_inputs(shape, seed)
    rng = np.random.default_rng(seed + 1)
    c = shape[-1]
    scale = (rng.standard_normal(c) * 8).astype(np.float32)
    bias = (rng.standard_normal(c) * 12).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, lens, g


@pytest.mark.parametrize("shape", [(2, 8, 26, 64), (1, 4, 16, 128), (2, 4, 10, 256),
                                   (3, 6, 20, 32)])
def test_gn_mish_bwd_ref_matches_jax_vjp(shape):
    """The closed-form backward (the backward kernel's plain version)
    against jax.vjp of _xla_chain, the JAX custom_vjp backward, including
    the masked tail, where dx is not zero.  Tolerance 2e-5 of the largest
    value: f32 sums in another order."""
    import jax
    import jax.numpy as jnp

    from facegantts_tpu.ops.gn_mish import _xla_chain

    x, scale, bias, lens, g = _bwd_inputs(shape, seed=sum(shape))
    _, vjp = jax.vjp(lambda a, s, b: _xla_chain(a, s, b, jnp.asarray(lens), 8, 1e-5),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]

    def nchw(a):
        return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())

    xt, st, bt, lt = nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), torch.from_numpy(lens)
    stats = tgn.group_stats(xt, 8, 1e-5)
    z = tgn._normalized(xt, stats, 8) * st[None, :, None, None] + bt[None, :, None, None]
    assert (z > 20).any() and (z < -20).any()
    dx, dscale, dbias = tgn.gn_mish_mask_bwd_ref(nchw(g), xt, st, bt, lt, stats, 8)
    got = [dx.numpy().transpose(0, 2, 3, 1), dscale.numpy(), dbias.numpy()]
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(a, w, rtol=0, atol=2e-5 * np.abs(w).max(), err_msg=name)
    for i, n in enumerate(lens):  # the masked tail: statistics cover it
        tail_got, tail_want = got[0][i, :, n:], want[0][i, :, n:]
        if tail_want.size:
            assert np.abs(tail_want).max() > 0
            np.testing.assert_allclose(tail_got, tail_want, rtol=0,
                                       atol=2e-5 * np.abs(want[0]).max())


@pytest.mark.parametrize("shape", [(2, 8, 26, 64), (1, 4, 16, 128), (2, 4, 10, 256),
                                   (3, 6, 20, 32)])
def test_gn_mish_bwd_ref_matches_jax_vjp_bf16(shape):
    """The closed-form backward for a bf16 x and upstream gradient (the
    mixed-precision paths' dtype) against jax.vjp of _xla_chain in bf16:
    both upcast x and g exactly and compute in f32, so dscale and dbias
    keep the f32 bar (2e-5 of the largest) and dx differs by at most one
    rounding to bf16 (2^-7 of each value, plus the f32 bar)."""
    import jax
    import jax.numpy as jnp

    from facegantts_tpu.ops.gn_mish import _xla_chain

    x, scale, bias, lens, g = _bwd_inputs(shape, seed=sum(shape) + 1)
    xb, gb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, s, b: _xla_chain(a, s, b, jnp.asarray(lens), 8, 1e-5),
                     xb, jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(gb)
    assert want[0].dtype == jnp.bfloat16
    want = [np.asarray(w, np.float32) for w in want]

    def nchw(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32)).transpose(0, 3, 1, 2)
                                .copy()).to(torch.bfloat16)

    xt, st, bt, lt = nchw(xb), torch.from_numpy(scale), torch.from_numpy(bias), torch.from_numpy(lens)
    stats = tgn.group_stats(xt, 8, 1e-5)
    dx, dscale, dbias = tgn.gn_mish_mask_bwd_ref(nchw(gb), xt, st, bt, lt, stats, 8)
    assert dx.dtype == torch.bfloat16 and dscale.dtype == dbias.dtype == torch.float32
    got = [dx.float().numpy().transpose(0, 2, 3, 1), dscale.numpy(), dbias.numpy()]
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        rtol = 2**-7 if name == "dx" else 0
        np.testing.assert_allclose(a, w, rtol=rtol, atol=2e-5 * np.abs(w).max(), err_msg=name)


def test_gn_mish_grad_matches_jax_bf16():
    """K1's gradient through the port's wrapper for a bf16 x (the plain
    chain on the CPU) against jax.grad of the JAX gn_mish_mask in bf16:
    dx within one bf16 rounding of each value (2^-7) plus 2e-5 of the
    largest, dscale and dbias (f32) within 2e-3 of the largest (the
    upstream sin(y) rounds y to bf16 on each side, and its cosine then
    differs by up to 2^-8 of a value)."""
    import jax
    import jax.numpy as jnp

    from facegantts_tpu.ops.gn_mish import gn_mish_mask as jgn

    x, scale, bias, lens = _gn_inputs((2, 4, 12, 64), seed=14)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax.grad(
        lambda a, s, b: jnp.sum(jnp.sin(jgn(a, s, b, jnp.asarray(lens), 8, 1e-5)
                                        .astype(jnp.float32))),
        (0, 1, 2))(xb, jnp.asarray(scale), jnp.asarray(bias))
    assert want[0].dtype == jnp.bfloat16
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32)).transpose(0, 3, 1, 2).copy())
    args = [v.clone().requires_grad_() for v in (xt.to(torch.bfloat16), torch.from_numpy(scale),
                                                 torch.from_numpy(bias))]
    torch.sin(tgn.gn_mish_mask(*args, torch.from_numpy(lens)).float()).sum().backward()
    assert args[0].grad.dtype == torch.bfloat16
    dx = args[0].grad.float().numpy().transpose(0, 2, 3, 1)
    w = np.asarray(want[0], np.float32)
    np.testing.assert_allclose(dx, w, rtol=2**-7, atol=2e-5 * np.abs(w).max())
    for g, w in zip(args[1:], want[1:]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=0, atol=2e-3 * np.abs(w).max())


def test_gn_mish_cpu_grad_goes_through_function():
    """On the CPU a gradient goes through the same autograd Function as on
    the card, with the plain forward and the closed-form backward."""
    x, scale, bias, lens, g = _bwd_inputs((2, 4, 12, 64), seed=21)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    args = (torch.from_numpy(scale), torch.from_numpy(bias), torch.from_numpy(lens))
    y = tgn.gn_mish_mask(xt, *args)
    assert type(y.grad_fn).__name__ == "_GnMishMaskBackward"
    assert torch.equal(y.detach(), tgn.gn_mish_mask_ref(xt.detach(), *args))
    gt = torch.from_numpy(g.transpose(0, 3, 1, 2).copy())
    y.backward(gt)
    plain = tgn.gn_mish_mask_bwd_ref(gt, xt.detach(), *args, tgn.group_stats(xt.detach()))
    assert torch.equal(xt.grad, plain[0])
    ref = xt.detach().clone().requires_grad_()
    tgn.gn_mish_mask_ref(ref, *args).backward(gt)
    # closed form vs autograd of the plain chain: f32 sums in another order
    torch.testing.assert_close(xt.grad, ref.grad, rtol=0,
                               atol=2e-5 * ref.grad.abs().max().item())


class _EveryClusterFits:
    """Stands in for the kernel library's occupancy query: every cluster fits."""

    @staticmethod
    def fgt_gn_mish_max_clusters(kind, cluster, smem, out):
        out._obj.value = 1
        return 0


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("shape", [(1, 64, 128, 436), (1, 64, 128, 872), (1, 256, 32, 109),
                                   (64, 64, 128, 128), (64, 128, 32, 32), (2, 64, 8, 26),
                                   (2, 24, 3, 5)])
def test_gn_mish_launch_plan(shape, elem, bwd):
    """The launch plan the CUDA wrapper computes on the host: the cluster's
    blocks cover the slab's rows (the last ones may get none, which the
    kernels allow), shared memory stays within the limit, and
    bulk copies are chosen only where every block's and tile's first row is
    16-byte aligned; the ints passed to the kernel are the plan's."""
    b, c, f, t = shape
    plan = tgn._make_plan(_EveryClusterFits, shape, 8, elem, bwd, 132)
    rows = c // 8 * f
    assert 1 <= plan.cluster <= 16 and plan.cluster * plan.rpb >= rows
    assert 1 <= plan.rpt <= plan.rpb and plan.smem <= tgn._MAX_SMEM
    if plan.vec:
        assert t * elem >= 16
        assert all(n * t * elem % 16 == 0 for n in (rows, plan.rpb, plan.rpt))
    assert list(plan.args) == [elem == 2, plan.vec, b, 8, c // 8, f, t, plan.cluster, plan.rpb,
                               plan.rpt, plan.smem]
    if shape == (1, 64, 128, 872):  # 3.57 MB f32 slabs stream through a 16-block cluster
        assert plan.cluster == 16 and (plan.rpt < plan.rpb) == (elem == 4 or bwd)


# The backward's shapes in a GAN step (B=16, 436 and 872 frames) and a plain
# step (B=64, the 128-frame crop), f32
K1_BWD_SHAPES = [(16, 64, 128, 436), (16, 128, 64, 218), (16, 64, 64, 218), (16, 256, 32, 109),
                 (16, 128, 32, 109), (16, 64, 128, 872), (64, 64, 128, 128), (64, 128, 64, 64),
                 (64, 64, 64, 64), (64, 256, 32, 32), (64, 128, 32, 32)]


@pytest.mark.parametrize("shape", K1_BWD_SHAPES)
def test_gn_mish_bwd_plan(shape):
    """The backward keeps every block's rows of x and g whole in shared
    memory (one tile, so both cross device memory once) wherever they fit
    two blocks an SM: all these shapes but the full-resolution GAN slab,
    whose 3.57 MB (436 frames) and 7.1 MB (872) stream in tiles; the
    shared memory is the kernel's layout, slice partials included."""
    b, c, f, t = shape
    plan = tgn._make_plan(_EveryClusterFits, shape, 8, 4, True, 132)
    assert plan.cluster * plan.rpb >= c // 8 * f and plan.smem <= tgn._MAX_SMEM and plan.vec
    assert (plan.rpt < plan.rpb) == (c == 64 and f == 128 and t in (436, 872))
    assert plan.smem == tgn._smem_bytes(shape, 8, 4, True, plan.rpb, plan.rpt)
    # two blocks an SM: 228 KB of shared memory, 1 KB of it reserved a block
    assert 2 * (plan.smem + 1024) <= 228 * 1024


def _bwd_check(shape, dtype, seed):
    """Backward kernel vs gn_mish_mask_bwd_ref and vs autograd of
    gn_mish_mask_ref on the card; returns the launches it made."""
    x, scale, bias, lens, g = _bwd_inputs(shape, seed)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to("cuda", dtype)
    gt = torch.from_numpy(g.transpose(0, 3, 1, 2).copy()).to("cuda", dtype)
    st, bt, lt = (torch.from_numpy(a).cuda() for a in (scale, bias, lens))
    before = kernels.LAUNCHES[tgn.BWD_NAME]
    args = [v.clone().requires_grad_() for v in (xt, st, bt)]
    tgn.gn_mish_mask(*args, lt).backward(gt)
    got = [v.grad.float() for v in args]
    launches = kernels.LAUNCHES[tgn.BWD_NAME] - before
    stats = tgn.group_stats(xt)
    plain = [v.float() for v in tgn.gn_mish_mask_bwd_ref(gt, xt, st, bt, lt, stats)]
    ref_args = [v.clone().requires_grad_() for v in (xt, st, bt)]
    tgn.gn_mish_mask_ref(*ref_args, lt).backward(gt)
    auto = [v.grad.float() for v in ref_args]
    torch.cuda.synchronize()
    for a, w, p in zip(got, auto, plain):
        top = max(1.0, w.abs().max().item())
        if dtype == torch.float32:  # f32 sums in another order
            assert (a - p).abs().max().item() <= 1e-4 * top
            assert (a - w).abs().max().item() <= 1e-4 * top
        else:  # dx rounded to bf16 once: 2^-8 of the largest, and the sums
            assert (a - p).abs().max().item() <= 1e-2 * top
    return launches


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_mish_cuda_backward_matches_plain(dtype):
    """K1's backward kernel on the card against its plain version
    (gn_mish_mask_bwd_ref) and against autograd of the plain chain, with z
    past both sides of Mish's clamp; one backward launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for shape in [(2, 8, 26, 64), (1, 4, 16, 128), (3, 6, 20, 32), (2, 128, 128, 64),
                  (2, 3, 5, 24)]:
        assert _bwd_check(shape, getattr(torch, dtype), seed=2) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_mish_cuda_kernel_streams_large_slab(dtype):
    """(1, 64, 128, 872), the top mel bucket's full-resolution shape: in f32
    a block's rows exceed its shared memory, so the forward streams tiles
    (the second read from L2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch_dtype = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn(1, 64, 128, 872, generator=gen, device="cuda") * 2 + 0.5).to(torch_dtype)
    scale = torch.randn(64, generator=gen, device="cuda") * 0.5 + 1
    bias = torch.randn(64, generator=gen, device="cuda")
    lens = torch.tensor([800], dtype=torch.int32, device="cuda")
    plan = tgn._plan(x, 8, False)
    assert (plan.rpt < plan.rpb) == (dtype == "float32")
    got = tgn.gn_mish_mask(x, scale, bias, lens).float()
    want = tgn.gn_mish_mask_ref(x, scale, bias, lens).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= (1e-4 if dtype == "float32" else 0.05)


def _bwd_kernel_check(shape, dtype, lens, seed, offset=False):
    """The backward kernel alone (``gn_mish_mask_bwd``) against its plain
    version on the card, one launch; x and g optionally views at an odd
    offset (element copies).  Bar: f32 1e-4 of the largest value (sums in
    another order); bf16 1e-2 (dx rounded to bf16 once, 2^-8 relative)."""
    b, c, f, t = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def tensor(scale_, shift):
        v = (torch.randn(shape, generator=gen, device="cuda") * scale_ + shift).to(dtype)
        if not offset:
            return v
        view = torch.empty(v.numel() + 1, dtype=dtype, device="cuda")[1:].view(shape)
        return view.copy_(v)

    x, g = tensor(2.0, 0.5), tensor(1.0, 0.0)
    scale = torch.randn(c, generator=gen, device="cuda") * 6
    bias = torch.randn(c, generator=gen, device="cuda") * 8
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    stats = tgn.group_stats(x)
    before = kernels.LAUNCHES[tgn.BWD_NAME]
    got = tgn.gn_mish_mask_bwd(g, x, scale, bias, lens, stats)
    assert kernels.LAUNCHES[tgn.BWD_NAME] == before + 1
    want = tgn.gn_mish_mask_bwd_ref(g, x, scale, bias, lens, stats)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        a, w = a.float(), w.float()
        assert a.shape == w.shape and torch.isfinite(a).all(), name
        top = max(1.0, w.abs().max().item())
        assert (a - w).abs().max().item() <= tol * top, (name, shape, dtype)


def _ragged(b, t):
    return [(t - 3, t, t // 2, 1)[i % 4] if t > 3 else (t, 1)[i % 2] for i in range(b)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", K1_BWD_SHAPES)
def test_gn_mish_cuda_backward_step_shapes(shape, dtype):
    """The backward kernel at the GAN and plain steps' shapes (the 872-frame
    slab streams, the others stay whole in the cluster), ragged lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _bwd_kernel_check(shape, getattr(torch, dtype), _ragged(shape[0], shape[3]), seed=7)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K1_BWD_SHAPES[6:])
def test_gn_mish_cuda_bf16_grad_plain_crop_shapes(shape):
    """K1's bf16 backward through the autograd Function at the plain step's
    five shapes (B=64, the 128-frame crop), ragged lengths: one backward
    launch, its gradients against the plain backward on the same forward
    statistics (dx 2^-8 of the largest value, one bf16 rounding; dscale and
    dbias 1e-4, f32 sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    b, c, f, t = shape
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    scale = torch.randn(c, generator=gen, device="cuda") * 6
    bias = torch.randn(c, generator=gen, device="cuda") * 8
    lens = torch.tensor(_ragged(b, t), dtype=torch.int32, device="cuda")
    args = [v.clone().requires_grad_() for v in (x, scale, bias)]
    before = kernels.LAUNCHES[tgn.BWD_NAME]
    tgn.gn_mish_mask(*args, lens).backward(g)
    assert kernels.LAUNCHES[tgn.BWD_NAME] == before + 1
    assert args[0].grad.dtype == torch.bfloat16
    want = tgn.gn_mish_mask_bwd_ref(g, x, scale, bias, lens, tgn.group_stats(x))
    torch.cuda.synchronize()
    for name, a, w, tol in zip(("dx", "dscale", "dbias"), (v.grad for v in args), want,
                               (2**-8, 1e-4, 1e-4)):
        a, w = a.float(), w.float()
        top = max(1.0, w.abs().max().item())
        assert (a - w).abs().max().item() <= tol * top, (name, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_mish_cuda_backward_edges(dtype):
    """The backward kernel at T of 1, 3, 32 and 109 (a 16-byte unit then
    spans rows, or the slab is not 16-byte aligned), lengths of 0, 1 and T,
    views at an odd offset, and the streaming 872-frame slab at batch 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dt = getattr(torch, dtype)
    for t in (1, 3, 32, 109):
        for shape in ((2, 16, 8, t), (3, 64, 32, t)):
            for lens in ([0] * shape[0], [1] * shape[0], [t] * shape[0], [0, t, 1][:shape[0]]):
                _bwd_kernel_check(shape, dt, lens, seed=t)
            _bwd_kernel_check(shape, dt, _ragged(shape[0], t), seed=t + 1, offset=True)
    _bwd_kernel_check((1, 64, 128, 872), dt, [800], seed=8)
    _bwd_kernel_check((2, 64, 128, 436), dt, [0, 436], seed=9, offset=True)


def _gan_inputs(shape, seed, dtype):
    """K1 inputs at a GAN-step shape on the card: ragged lengths over the
    batch, the affine past both sides of Mish's clamp, an upstream gradient."""
    b, c, f, t = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    scale = torch.randn(c, generator=gen, device="cuda") * 6
    bias = torch.randn(c, generator=gen, device="cuda") * 8
    lens = torch.tensor([(t - 3, t, t // 2, 1)[i % 4] for i in range(b)], dtype=torch.int32,
                        device="cuda")
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return x, scale, bias, lens, g


# The GAN step's full-resolution U-Net slab at batch 16 (n_mels 128; also at
# 80 mel bins): the G phase runs K1 forward and backward in f32 over the
# whole mel bucket (436 to 872 frames), the bf16 sampler runs its forward
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 64, 128, 872), (16, 64, 80, 872), (16, 64, 128, 436)])
def test_gn_mish_cuda_gan_shapes_f32_forward_backward(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, scale, bias, lens, g = _gan_inputs(shape, 4, torch.float32)
    before = dict(kernels.LAUNCHES)
    args = [v.clone().requires_grad_() for v in (x, scale, bias)]
    y = tgn.gn_mish_mask(*args, lens)
    y.backward(g)
    assert kernels.LAUNCHES[tgn.NAME] - before.get(tgn.NAME, 0) == 1
    assert kernels.LAUNCHES[tgn.BWD_NAME] - before.get(tgn.BWD_NAME, 0) == 1
    ref = [v.clone().requires_grad_() for v in (x, scale, bias)]
    y_ref = tgn.gn_mish_mask_ref(*ref, lens)
    y_ref.backward(g)
    plain = tgn.gn_mish_mask_bwd_ref(g, x, scale, bias, lens, tgn.group_stats(x))
    torch.cuda.synchronize()
    assert (y - y_ref).abs().max().item() <= 1e-4
    for a, w, p in zip([v.grad for v in args], [v.grad for v in ref], plain):
        top = max(1.0, w.abs().max().item())
        assert (a - w).abs().max().item() <= 1e-4 * top
        assert (a - p).abs().max().item() <= 1e-4 * top


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 64, 128, 436), (16, 64, 80, 436)])
def test_gn_mish_cuda_gan_shapes_bf16_forward(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, scale, bias, lens, _ = _gan_inputs(shape, 5, torch.bfloat16)
    # an O(1) affine (f32, as the U-Net passes it), as the other bf16
    # checks, whose bar (0.05) this keeps
    scale, bias = scale / 12 + 1, bias / 8
    got = tgn.gn_mish_mask(x, scale, bias, lens).float()
    want = tgn.gn_mish_mask_ref(x, scale, bias, lens).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_maximum_path_cuda_kernel_equals_plain(seed):
    """The MAS kernel against its plain version on the card, exactly:
    ragged lengths, length-1 edges, T_x = T_y, integer values (ties), and
    the text widths of the training buckets."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from facegantts_tpu_torch.ops import mas as tmas

    rng = np.random.default_rng(seed)
    for b, t_x, t_y, tx, ty in [(4, 12, 40, [12, 7, 1, 9], [40, 33, 1, 30]),
                                (3, 16, 16, [16, 10, 4], [16, 10, 4]),
                                (2, 40, 300, [40, 33], [300, 97]),
                                # training buckets: 128 and 192 threads per block
                                (2, 128, 256, [128, 70], [256, 131]),
                                (2, 192, 436, [192, 150], [436, 301])]:
        value = rng.standard_normal((b, t_x, t_y)) * 3
        if seed:
            value = np.round(value)
        mask = ((np.arange(t_x)[None, :, None] < np.asarray(tx)[:, None, None])
                & (np.arange(t_y)[None, None, :] < np.asarray(ty)[:, None, None]))
        v = torch.tensor(value, dtype=torch.float32, device="cuda")
        m = torch.tensor(mask, dtype=torch.float32, device="cuda")
        before = kernels.LAUNCHES[tmas.NAME]
        got = tmas.maximum_path(v, m)
        assert kernels.LAUNCHES[tmas.NAME] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, tmas.maximum_path_ref(v, m))


# (B, T_x, T_y, text lengths, mel lengths): T_x of every rows-per-lane R
# (1, 31 -> 1; 33 -> 2; 100 -> 4; 256 -> 8; 512 -> 16; 1024 -> 32), T_y
# below 32 and not a multiple of 4 (element loads), and texts longer than
# their mels (an empty band)
_MAS_EDGES = [(2, 1, 40, [1, 1], [40, 17]), (3, 31, 29, [31, 20, 5], [29, 29, 3]),
              (2, 33, 70, [33, 17], [70, 33]), (3, 8, 20, [8, 3, 1], [20, 5, 1]),
              (2, 5, 7, [5, 2], [7, 7]), (2, 100, 257, [100, 64], [257, 100]),
              (2, 256, 872, [256, 200], [872, 500]), (2, 512, 600, [512, 300], [600, 450]),
              (2, 1024, 960, [900, 1024], [960, 960])]


@pytest.mark.gpu
def test_maximum_path_cuda_bf16_log_prior():
    """A bf16 log-prior (and a bf16 mask, as the mixed-precision step's
    masks are) upcasts to f32 on the card: one launch, the path of the f32
    kernel on the upcast values, returned in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from facegantts_tpu_torch.ops import mas as tmas

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, t_x, t_y = 4, 40, 200
    v = (torch.randn(b, t_x, t_y, generator=gen, device="cuda") * 3).to(torch.bfloat16)
    tx = torch.tensor([40, 31, 7, 1], device="cuda")
    ty = torch.tensor([200, 150, 60, 9], device="cuda")
    m = ((torch.arange(t_x, device="cuda")[None, :, None] < tx[:, None, None])
         & (torch.arange(t_y, device="cuda")[None, None, :] < ty[:, None, None]))
    before = kernels.LAUNCHES[tmas.NAME]
    got = tmas.maximum_path(v, m.to(torch.bfloat16))
    assert kernels.LAUNCHES[tmas.NAME] == before + 1 and got.dtype == torch.bfloat16
    want = tmas.maximum_path_ref(v.float(), m.float())
    torch.cuda.synchronize()
    assert torch.equal(got.float(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["real", "integer", "holes"])
def test_maximum_path_cuda_kernel_edges(kind):
    """The MAS kernel against its plain version on the card, exactly, at
    the edges of its design: every rows-per-lane, unaligned and short mel
    rows, empty bands, integer values (ties) and a mask with holes inside
    the text x mel rectangle, where the value is large (the kernel must
    fold the mask into the value, not only take the lengths from it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from facegantts_tpu_torch.ops import mas as tmas

    rng = np.random.default_rng(7)
    for b, t_x, t_y, tx, ty in _MAS_EDGES:
        value = rng.standard_normal((b, t_x, t_y)) * 3
        if kind == "integer":
            value = np.round(value)
        mask = ((np.arange(t_x)[None, :, None] < np.asarray(tx)[:, None, None])
                & (np.arange(t_y)[None, None, :] < np.asarray(ty)[:, None, None]))
        if kind == "holes":  # away from the first row and column, which give the lengths
            holes = rng.random(mask.shape) < 0.1
            holes[:, 0, :] = holes[:, :, 0] = False
            value = np.where(holes, 100.0, value)
            mask = mask & ~holes
        v = torch.tensor(value, dtype=torch.float32, device="cuda")
        m = torch.tensor(mask, dtype=torch.float32, device="cuda")
        got = tmas.maximum_path(v, m)
        torch.cuda.synchronize()
        assert torch.equal(got, tmas.maximum_path_ref(v, m)), (b, t_x, t_y)


@pytest.mark.parametrize("t_y", [7, 29, 256, 436, 656, 872])
def test_maximum_path_launch_config(t_y):
    """The MAS launch for every T_x <= 1024 at the mel buckets and short
    mel lengths: R rows a lane, the least power of two with 32 R >= T_x; a
    ring of three tiles of 32, 16 or 8 columns, the widest that fits; shared
    memory within one block's 232,448 bytes, as csrc/mas.cu lays it out (the
    ring, a word of bits per row slot and column, the path rows).  Beyond
    that, no configuration, and the wrapper raises."""
    from facegantts_tpu_torch.ops import mas as tmas

    for t_x in range(1, 1025):
        r, w, smem = tmas._launch_config(t_x, t_y)
        assert r in (1, 2, 4, 8, 16, 32) and 32 * r >= t_x and (r == 1 or 16 * r < t_x)
        assert w in (32, 16, 8) and smem <= 232448
        stride = tmas._col_stride(r)
        assert stride >= 33 * r - 1 and stride % 32 == 1  # holds rows (R-1)*33 + 31
        header = 6 * 8 + 32 * 4 + 8 * 4 + 7 * 64 * 4  # barriers, scratch, counters, rings
        tile = 4 * w * stride
        assert smem == header + 3 * tile + 4 * t_y * r + 4 * t_y
        if w < 32:  # the wider tile would not fit
            assert smem + 3 * tile > 232448
    assert tmas._launch_config(256, t_y)[1] == 32  # the training text buckets take 32 columns
    assert tmas._launch_config(1024, 1000) is None


def test_mas_split_cuts_match_the_kernel_source():
    """``mas_split`` finds its design in csrc/mas.cu and every text it cuts
    out of it, exactly once (a cut that no longer matches would raise on
    the card)."""
    import os

    from facegantts_tpu_torch import mas_split

    with open(os.path.join(kernels.CSRC_DIR, kernels.SOURCES["mas"])) as f:
        src = f.read()
    design = mas_split._design(src)
    assert design == "warp"
    for variant, cuts in mas_split.DESIGNS[design][1].items():
        assert [src.count(cut) for cut, _ in cuts] == [1] * len(cuts), variant


def test_kernel_entry_resolved_once(monkeypatch):
    """The C entries: ``kernels.entry`` sets restype and argtypes on the
    library's function (stub library here), each wrapper resolves its entry
    once into a module-level handle, and every pointer and stream argument
    is a c_void_p (an int would cut a 64-bit address)."""
    import ctypes

    from facegantts_tpu_torch import probe
    from facegantts_tpu_torch.ops import groupnorm as tgnorm
    from facegantts_tpu_torch.ops import mas as tmas

    class Fn:
        def __init__(self):
            self.sets, self.restype, self._argtypes = 0, None, None

        @property
        def argtypes(self):
            return self._argtypes

        @argtypes.setter
        def argtypes(self, v):
            self.sets += 1
            self._argtypes = v

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, Fn())

    libs = {n: Lib() for n in ("mas", "probe", "groupnorm")}
    for n, lib in libs.items():
        monkeypatch.setitem(kernels._libs, n, lib)
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cases = [(tmas, "_entry", tmas._resolve, "mas", "fgt_mas_f32", [p] * 3 + [i] * 7 + [p]),
             (probe, "_p1", probe._resolve_p1, "probe", "fgt_probe_trivial_f32", [p, p, q, p]),
             (probe, "_p2", probe._resolve_p2, "probe", "fgt_probe_dp_loop_f32",
              [p, p, i, i, i, i, p]),
             (tgnorm, "_entry", tgnorm._resolve, "groupnorm", "fgt_channel_sums_f32",
              [p, p, i, i, q, p])]
    for module, handle, resolve, lib, symbol, want in cases:
        monkeypatch.setattr(module, handle, None)
        fn = resolve()
        assert fn is libs[lib].fns[symbol] and getattr(module, handle) is fn
        assert list(fn.argtypes) == want and fn.restype is ctypes.c_int and fn.sets == 1
        # the wrappers call ``handle or resolve()``: a set handle is used as it is
        assert (getattr(module, handle) or resolve()) is fn and fn.sets == 1


# ---------------------------------------------------------------------------
# ops/groupnorm (K2)


@pytest.mark.parametrize("shape", [(2, 8, 26, 64), (1, 4, 16, 128), (2, 4, 64, 32),
                                   (2, 3, 5, 96)])
def test_group_norm_matches_jax(shape):
    """The port's group_norm (statistics from K2's plain version on the CPU)
    against the JAX Pallas path in interpret mode and _xla_group_norm, as
    tests/test_ops.py holds them; its gradient against jax.grad through the
    JAX custom_vjp.  C=96 is a shape the TPU kernel does not take."""
    import jax
    import jax.numpy as jnp

    from facegantts_tpu.ops.groupnorm import (
        _fast_group_norm,
        _shape_supported,
        _xla_group_norm,
        group_norm as jgroup_norm,
    )

    from facegantts_tpu_torch.ops import groupnorm as tgnorm

    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 2 - 0.5).astype(np.float32)
    c = shape[-1]
    scale = (rng.standard_normal(c) + 1).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    jx, js, jb = jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)

    sums = tgnorm.channel_sums(xt).numpy()  # (B, 2, C)
    np.testing.assert_allclose(sums[:, 0], x.sum(axis=(1, 2)), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(sums[:, 1], (x * x).sum(axis=(1, 2)), rtol=1e-5, atol=1e-3)

    got = tgnorm.group_norm(xt, st, bt, 8, 1e-6).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(_xla_group_norm(jx, js, jb, 8, 1e-6)),
                               atol=2e-5)
    if _shape_supported(jx):
        np.testing.assert_allclose(
            got, np.asarray(_fast_group_norm(jx, js, jb, 8, 1e-6, interpret=True)), atol=2e-5)
    np.testing.assert_allclose(
        tgnorm.group_norm_ref(xt, st, bt, 8, 1e-6).numpy().transpose(0, 2, 3, 1), got,
        atol=2e-5)

    want = jax.grad(lambda a, s, b: jnp.sum(jnp.sin(jgroup_norm(a, s, b, 8, 1e-6))),
                    (0, 1, 2))(jx, js, jb)
    args = [v.clone().requires_grad_() for v in (xt, st, bt)]
    torch.sin(tgnorm.group_norm(*args, 8, 1e-6)).sum().backward()
    np.testing.assert_allclose(args[0].grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want[0]), atol=2e-5)
    for g, w in zip(args[1:], want[1:]):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), atol=1e-4)


def test_fused_group_norm_module_matches_nn_group_norm():
    from facegantts_tpu_torch.models.unet import FusedGroupNorm

    torch.manual_seed(0)
    x = torch.randn(2, 32, 6, 10) * 3 + 1
    ref = torch.nn.GroupNorm(8, 32, eps=1e-5)
    mod = FusedGroupNorm(32)
    with torch.no_grad():
        for m in (ref, mod):
            m.weight.copy_(torch.linspace(0.5, 1.5, 32))
            m.bias.copy_(torch.linspace(-1, 1, 32))
    torch.testing.assert_close(mod(x), ref(x), atol=2e-5, rtol=0)


@pytest.mark.gpu
def test_channel_sums_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from facegantts_tpu_torch.ops import groupnorm as tgnorm

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in [(2, 64, 8, 26), (1, 128, 4, 16), (3, 32, 5, 7), (2, 96, 3, 5)]:
        x = torch.randn(shape, generator=gen, device="cuda") * 2 - 0.5
        before = kernels.LAUNCHES[tgnorm.NAME]
        got = tgnorm.channel_sums(x)
        assert kernels.LAUNCHES[tgnorm.NAME] == before + 1
        want = tgnorm.channel_sums_ref(x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="float32"):
        tgnorm.channel_sums(x.half())


# ---------------------------------------------------------------------------
# probe (P1, P2)


def _dp_loop_numpy(v):
    """numpy transcription of scripts/pallas_probe.py's probe_dp_loop body,
    with np.roll for pltpu.roll."""
    prev = np.zeros(v.shape[1:], np.float32)
    out = np.empty_like(v)
    for y in range(v.shape[0]):
        prev = v[y] + np.maximum(prev, np.roll(prev, 1, axis=1))
        out[y] = prev
    return out


def test_probe_plain_versions_match_numpy():
    from facegantts_tpu_torch import probe

    x = np.random.default_rng(0).standard_normal(probe.P1_SHAPE).astype(np.float32)
    np.testing.assert_array_equal(probe.probe_trivial(torch.from_numpy(x)).numpy(),
                                  x * 2.0 + 1.0)
    v = np.random.default_rng(1).standard_normal((40, 3, 16)).astype(np.float32)
    got = probe.probe_dp_loop(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, _dp_loop_numpy(v))
    # the roll wraps: column 1 of x = 0 sees column 0's x = T_x - 1
    assert got[1, 0, 0] == v[1, 0, 0] + max(got[0, 0, 0], got[0, 0, -1])


def test_probe_entry_point_cpu(capsys):
    from facegantts_tpu_torch import probe

    probe.main(["device=cpu"])
    out = capsys.readouterr().out
    assert "trivial kernel" in out and "DP loop kernel" in out


@pytest.mark.gpu
def test_probe_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from facegantts_tpu_torch import probe

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(probe.P1_SHAPE, generator=gen, device="cuda")
    assert torch.equal(probe.probe_trivial(x), probe.probe_trivial_ref(x))
    for shape in [probe.P2_SHAPE, (40, 3, 16), (17, 2, 100)]:
        v = torch.randn(shape, generator=gen, device="cuda")
        assert torch.equal(probe.probe_dp_loop(v), probe.probe_dp_loop_ref(v))


def _assert_same_dp(got, want):
    """Exactly equal, NaN where the plain version has NaN."""
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.where(want.isnan(), 0.0, got), torch.where(want.isnan(), 0.0, want))


@pytest.mark.gpu
@pytest.mark.parametrize("t_x", [1, 31, 33, 100, 128, 1024])
def test_probe_dp_loop_cuda_shapes(t_x):
    """P2 exactly equal to its plain version at T_x of 1 to 1024 (rows a
    lane 1 to 32; 33 and 100 put x = T_x - 1 off a lane's last row), T_y of
    1, 17 and 256 and B of 1 and 8 (one warp an item, four items a block),
    each with one launch; and on a view at an odd offset (4-byte copies)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from facegantts_tpu_torch import probe

    gen = torch.Generator(device="cuda").manual_seed(t_x)
    for t_y in (1, 17, 256):
        for b in (1, 8):
            v = torch.randn((t_y, b, t_x), generator=gen, device="cuda")
            before = kernels.LAUNCHES[probe.P2_NAME]
            got = probe.probe_dp_loop(v)
            assert kernels.LAUNCHES[probe.P2_NAME] == before + 1
            _assert_same_dp(got, probe.probe_dp_loop_ref(v))
    base = torch.randn(17 * 8 * t_x + 1, generator=gen, device="cuda")
    v = base[1:].view(17, 8, t_x)
    _assert_same_dp(probe.probe_dp_loop(v), probe.probe_dp_loop_ref(v))


@pytest.mark.gpu
def test_probe_dp_loop_cuda_nan():
    """A NaN in the input spreads as torch.maximum spreads it: along its
    row and, through the roll, to the next row (x = 0 after x = T_x - 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from facegantts_tpu_torch import probe

    gen = torch.Generator(device="cuda").manual_seed(5)
    for t_x, where in ((128, (3, 2, 127)), (100, (0, 0, 99)), (33, (10, 5, 7))):
        v = torch.randn((40, 8, t_x), generator=gen, device="cuda")
        v[where] = float("nan")
        got, want = probe.probe_dp_loop(v), probe.probe_dp_loop_ref(v)
        assert want.isnan().sum() > 1
        _assert_same_dp(got, want)


@pytest.mark.gpu
def test_probe_trivial_cuda_edges():
    """P1 where its 16-byte path does not cover everything: sizes that are
    not a multiple of 4, a size past one round of the grid, and contiguous
    views that start off a 16-byte boundary (x and y then aligned unalike,
    so every element is scalar), each with one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from facegantts_tpu_torch import probe

    gen = torch.Generator(device="cuda").manual_seed(1)
    base = torch.randn(3 * 2**20 + 7, generator=gen, device="cuda")
    for x in [base[:1], base[:3], base[:5], base[:1023], base[:65537], base,
              base[1:], base[3:1030], base.view(-1)[2:].view(-1, 1)[:-1]]:
        assert x.is_contiguous()
        before = kernels.LAUNCHES[probe.P1_NAME]
        got = probe.probe_trivial(x)
        assert kernels.LAUNCHES[probe.P1_NAME] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, probe.probe_trivial_ref(x)), (x.numel(), x.data_ptr() % 16)
    with pytest.raises(ValueError, match="contiguous"):
        probe.probe_trivial(base[:7000].view(-1, 7)[:, ::2])


# ---------------------------------------------------------------------------
# ops/align: exact


def test_sequence_mask_and_fix_len_exact():
    import jax.numpy as jnp

    from facegantts_tpu.ops import align as jalign

    lens = np.array([0, 3, 7, 9], np.int32)
    got = talign.sequence_mask(torch.from_numpy(lens), 9).numpy()
    np.testing.assert_array_equal(got, np.asarray(jalign.sequence_mask(jnp.asarray(lens), 9)))
    for n in (1, 4, 5, 255, 436, 437, 873):
        assert talign.fix_len_compatibility(n) == jalign.fix_len_compatibility(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_path_and_lengths_exact(seed):
    """Float cumsum of ceil(w) * 0.91 and the truncated float length sum,
    as FaceTTS.encode/decode compute them, equal JAX's exactly."""
    import jax.numpy as jnp

    from facegantts_tpu.ops import align as jalign

    rng = np.random.default_rng(seed)
    b, tx, ty = 3, 17, 96
    logw = rng.standard_normal((b, tx, 1)).astype(np.float32) * 1.5
    x_mask = (np.arange(tx)[None, :, None] < np.array([17, 11, 5])[:, None, None]).astype(np.float32)

    w_ceil_t = torch.ceil(torch.exp(torch.from_numpy(logw)) * torch.from_numpy(x_mask)) * 0.91
    w_ceil_j = jnp.ceil(jnp.exp(jnp.asarray(logw)) * jnp.asarray(x_mask)) * 0.91
    np.testing.assert_array_equal(w_ceil_t.numpy(), np.asarray(w_ceil_j))
    ylen_t = torch.clamp(w_ceil_t.sum(dim=(1, 2)), min=1.0).clamp(max=ty).to(torch.int32)
    ylen_j = jnp.minimum(jnp.clip(jnp.sum(w_ceil_j, axis=(1, 2)), min=1.0), ty).astype(jnp.int32)
    np.testing.assert_array_equal(ylen_t.numpy(), np.asarray(ylen_j))

    y_mask = talign.sequence_mask(ylen_t, ty).float()[:, None, :]
    attn_mask = torch.from_numpy(x_mask) * y_mask
    got = talign.generate_path(w_ceil_t[..., 0], attn_mask).numpy()
    want = np.asarray(jalign.generate_path(w_ceil_j[..., 0], jnp.asarray(attn_mask.numpy())))
    np.testing.assert_array_equal(got, want)
