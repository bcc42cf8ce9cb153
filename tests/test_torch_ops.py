"""PyTorch port ops against the JAX package: kernel K1's plain version
(``gn_mish_mask_ref``) against ``_xla_chain`` and the Pallas kernel in
interpret mode, its gradient against the JAX ``custom_vjp``, the K1 wrapper's
CPU route and its checks; K2's GroupNorm (statistics, output and gradient)
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
    for shape in [(2, 8, 26, 64), (1, 4, 16, 128), (2, 4, 10, 256), (3, 6, 20, 32)]:
        x, scale, bias, lens = _gn_inputs(shape, seed=1)
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to("cuda", torch_dtype)
        args = [torch.from_numpy(a).cuda() for a in (scale, bias, lens)]
        got = tgn.gn_mish_mask(xt, *args).float()
        want = tgn.gn_mish_mask_ref(xt, *args).float()
        torch.cuda.synchronize()
        atol = 1e-4 if dtype == "float32" else 0.05
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
    # an input that needs a gradient launches the kernel too (its backward
    # recomputes the plain chain); the backward launches nothing
    tgn.gn_mish_mask(x.requires_grad_(), scale, bias, lens).sum().backward()
    assert kernels.LAUNCHES[tgn.NAME] == before + 2 and x.grad is not None


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


@pytest.mark.gpu
def test_gn_mish_cuda_backward_matches_plain():
    """K1's forward kernel plus the recomputed backward on the card against
    autograd of the plain chain (f32 sums in another order: 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for shape in [(2, 8, 26, 64), (1, 4, 16, 128), (3, 6, 20, 32)]:
        x, scale, bias, lens = _gn_inputs(shape, seed=2)
        args = [torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).cuda(),
                *(torch.from_numpy(a).cuda() for a in (scale, bias)),
                torch.from_numpy(lens).cuda()]
        before = kernels.LAUNCHES[tgn.NAME]
        got = _k1_grads(tgn.gn_mish_mask, *args)
        assert kernels.LAUNCHES[tgn.NAME] == before + 1
        want = _k1_grads(tgn.gn_mish_mask_ref, *args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item())


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
