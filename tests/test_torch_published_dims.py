"""The PyTorch port at the PUBLISHED checkpoint widths against the JAX
package (``tests/test_e2e_parity.py:test_torch_vs_jax_full_pipeline_published_dims``
with the port in the torch replica's place).

The weights are the torch replica at ``DIMS_FULL`` (encoder 192/768/6
layers, U-Net dec_dim 64, SyncNet 512) at its untouched default init,
loaded into the port by ``load_state_dict`` and into JAX by
``import_facetts``; the same ``_inputs()`` noise goes to both through
``decode(noise=...)``, at ``FULL_DIMS_TEMPERATURE`` (8, which keeps a
randomly initialised full-width reverse ODE finite).  Torch runs strict
f32.  Bars (the JAX test's): equal ``y_lengths``, a max gap under
3e-5 * scale + 2e-3 and a mean gap under 3e-6 * scale + 2e-4, with scale
the largest |mel| over the valid frames, and a zero tail.  Slow, as the
JAX test is."""

import numpy as np
import pytest
import torch

from facegantts_tpu_torch.models.facetts import FaceTTS
from tests.test_e2e_parity import (
    DIMS_FULL,
    FULL_DIMS_TEMPERATURE,
    RECIPE,
    Y_MAX,
    _inputs,
    _run_jax,
    _stable_torch_replica,
)
from torch_cpu import torch_threads_started  # noqa: F401

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True)
def _strict_f32():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def test_port_vs_jax_published_dims(tmp_path):
    from facegantts_tpu.train.checkpoint import import_facetts

    replica = _stable_torch_replica(DIMS_FULL, est_scale=None, final_scale=None)
    ckpt = tmp_path / "replica_full.pt"
    torch.save({"state_dict": replica.state_dict()}, ckpt)
    params, batch_stats = import_facetts(str(ckpt))

    d = DIMS_FULL
    port = FaceTTS(
        n_vocab=d["n_vocab"], n_feats=d["n_feats"], n_enc_channels=d["n_channels"],
        filter_channels=d["filter_channels"], filter_channels_dp=d["filter_channels_dp"],
        n_heads=d["n_heads"], n_enc_layers=d["n_layers"], enc_kernel=d["kernel_size"],
        enc_dropout=0.0, window_size=d["window_size"], dec_dim=d["dec_dim"], beta_min=0.05,
        beta_max=20.0, pe_scale=float(d["pe_scale"]), vid_emb_dim=d["spk_emb_dim"],
    ).eval()
    missing, unexpected = port.load_state_dict(replica.state_dict(), strict=False)
    assert not unexpected
    # the replica carries SyncNet's video stream only (the face path)
    assert all(k.startswith(("syncnet.netcnnaud.", "syncnet.netfcaud.")) for k in missing)

    x, x_len, face, noise = _inputs()
    with torch.no_grad():
        _, mel, _, y_len = port(
            torch.from_numpy(x).long(), torch.from_numpy(x_len).long(), RECIPE["n_timesteps"],
            Y_MAX, FULL_DIMS_TEMPERATURE, spk=torch.from_numpy(face),
            length_scale=RECIPE["length_scale"], noise=torch.from_numpy(noise))
    mel, y_len = mel.numpy(), y_len.numpy()
    assert np.isfinite(mel).all()
    j_mel, j_ylen = _run_jax(params, x, x_len, face, noise, spk_is_embedding=False,
                             batch_stats=batch_stats, dims=DIMS_FULL,
                             temperature=FULL_DIMS_TEMPERATURE)

    np.testing.assert_array_equal(y_len, j_ylen)
    n = int(j_ylen[0])
    gap = np.abs(mel[0, :, :n] - j_mel[0, :, :n])
    scale = max(1.0, float(np.abs(j_mel[0, :, :n]).max()))
    print(f"published dims: {n} frames, scale {scale:.2f}, max gap {gap.max():.3e}, "
          f"mean gap {gap.mean():.3e}")
    assert gap.max() < 3e-5 * scale + 2e-3, f"max |port - jax| = {gap.max():.2e} ({scale:.1f})"
    assert gap.mean() < 3e-6 * scale + 2e-4, f"mean |port - jax| = {gap.mean():.2e}"
    assert not mel[0, :, n:].any(), "masked tail is not exactly zero"
    np.testing.assert_array_equal(j_mel[0, :, n:], 0.0)
