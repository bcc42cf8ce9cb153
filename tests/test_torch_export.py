"""Export of the PyTorch port (``facegantts_tpu_torch/export.py``) and K1's
registered operator, on the CPU.

- ``torch.library.opcheck`` on ``facegantts::gn_mish_mask``, whose CPU
  kernel equals ``gn_mish_mask_ref``.
- One bucket pair (16, 64) exported at ``test_e2e_parity.py``'s reduced
  widths (``DIMS``), ``use_bf16=0``, ``spk_emb=face``, as
  ``tests/test_export.py`` exports the JAX bundle, with weights carried
  from JAX by ``convert.py``: the graph holds K1 as 25 * T nodes of the op;
  a loaded call equals the live ``Synthesizer.synthesize`` with the same
  seed (bars of ``test_export.py``: wav 1e-5, mel 5e-4); the program fed
  the noise directly matches JAX's FaceTTS + HiFi-GAN (mel at
  ``test_e2e_parity.py``'s bars, equal ``y_len``, a zero tail); the
  manifest has the JAX bundle's keys.

Torch runs strict f32."""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from facegantts_tpu_torch import convert
from facegantts_tpu_torch.config import default_config
from facegantts_tpu_torch.ops import gn_mish
from tests.test_e2e_parity import DIMS, EST_SCALE, RECIPE, Y_MAX
from tests.test_torch_models import _random_variables
from torch_cpu import torch_threads_started  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 3  # sampler steps of the exported program: 75 K1 nodes
TX = 16
SYNC_WIDTH = 0.25
CFG = dict(n_enc_channels=DIMS["n_channels"], filter_channels=DIMS["filter_channels"],
           filter_channels_dp=DIMS["filter_channels_dp"], n_enc_layers=DIMS["n_layers"],
           dec_dim=DIMS["dec_dim"], vid_emb_dim=DIMS["spk_emb_dim"],
           syncnet_width_mult=SYNC_WIDTH, spk_emb="face", use_bf16=0, fused_gn_mish=1,
           timesteps=T, temperature=RECIPE["temperature"], length_scale=RECIPE["length_scale"],
           text_buckets=(TX,), mel_buckets=(Y_MAX,))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread here: the parallel test run starts several
    workers on one host, and these small ops lose more to thread hand-offs
    between oversubscribed cores than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _strict_f32():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_mish_op_opcheck(dtype):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 16, 8, 12)).astype(np.float32)).to(dtype)
    scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(16).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.standard_normal(16).astype(np.float32))
    lens = torch.tensor([12, 5], dtype=torch.int32)
    args = (x, scale, bias, lens, 8, 1e-5)
    torch.library.opcheck(torch.ops.facegantts.gn_mish_mask.default, args)
    assert torch.equal(gn_mish.gn_mish_mask_op(*args), gn_mish.gn_mish_mask_ref(*args))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """JAX FaceTTS and HiFi-GAN variables (seeded), the port Synthesizer
    holding them, its bundle written and loaded."""
    from facegantts_tpu.models.facetts import FaceTTS as JFaceTTS
    from facegantts_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
    from facegantts_tpu_torch.export import export_bundle, load_bundle
    from facegantts_tpu_torch.synthesis import Synthesizer

    jm = JFaceTTS(
        n_vocab=DIMS["n_vocab"], n_feats=DIMS["n_feats"], n_enc_channels=DIMS["n_channels"],
        filter_channels=DIMS["filter_channels"], filter_channels_dp=DIMS["filter_channels_dp"],
        n_heads=DIMS["n_heads"], n_enc_layers=DIMS["n_layers"], enc_kernel=DIMS["kernel_size"],
        enc_dropout=0.0, window_size=DIMS["window_size"], dec_dim=DIMS["dec_dim"],
        beta_min=0.05, beta_max=20.0, pe_scale=float(DIMS["pe_scale"]),
        vid_emb_dim=DIMS["spk_emb_dim"], syncnet_width_mult=SYNC_WIDTH, fused_gn=1)
    x = np.zeros((1, TX), np.int32)
    x[0, :12] = np.random.default_rng(0).integers(1, 148, 12)
    x_len = np.array([12], np.int32)
    face = np.random.default_rng(1).standard_normal((1, 224, 224, 3)).astype(np.float32)
    variables = _random_variables(jm, x, x_len, 2, 16, 1.0, False, face, 1.0,
                                  jax.random.PRNGKey(0), seed=11)
    # keep the reverse ODE finite and the alignment long, as test_torch_e2e does
    variables["params"]["decoder"] = jax.tree.map(
        lambda a: a * np.float32(EST_SCALE), variables["params"]["decoder"])
    proj = variables["params"]["encoder"]["proj_w"]["proj"]
    proj["bias"] = proj["bias"] + np.float32(2.5)
    jh = JHiFiGAN()
    hp = _random_variables(jh, np.zeros((1, 128, 4), np.float32), seed=4)["params"]

    cfg = default_config(env={}, overrides=CFG)
    synth = Synthesizer(cfg, device="cpu")
    missing, unexpected = synth.model.load_state_dict(convert.facetts_state_dict(variables),
                                                      strict=False)
    assert not unexpected and all(k.startswith("syncnet.netcnnaud.") or
                                  k.startswith("syncnet.netfcaud.") for k in missing)
    synth.vocoder.load_state_dict(convert.hifigan_state_dict(hp), strict=True)
    out = tmp_path_factory.mktemp("bundle")
    manifest = export_bundle(synth, str(out))
    loaded_manifest, fns = load_bundle(str(out))
    assert loaded_manifest == manifest
    return dict(jm=jm, jh=jh, variables=variables, hp=hp, synth=synth, out=out, fns=fns,
                manifest=manifest, x=x, x_len=x_len, face=face)


def test_graph_holds_k1_as_its_op(bundle):
    program = torch.export.load(os.path.join(bundle["out"], f"synth_tx{TX}_ty{Y_MAX}.pt2"))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert sum(t == "facegantts.gn_mish_mask.default" for t in targets) == 25 * T
    assert not any("group_norm" in t or "mish" in t.replace("gn_mish", "") for t in targets)


def test_loaded_call_equals_live_call(bundle):
    synth, cfg = bundle["synth"], bundle["synth"].cfg
    x, x_len, face = bundle["x"], bundle["x_len"], bundle["face"]
    fn = bundle["fns"][(TX, Y_MAX)]
    wav, mel, y_len = fn(x, x_len, face, np.int32(7))
    ref_wav, ref_mel = synth.synthesize(x[0, :int(x_len[0])], synth.prepare_face(face[0]), seed=7)
    n = int(y_len[0])
    got = np.clip(wav[0, : n * cfg.hop_len].numpy(), -1, 1)
    assert n < Y_MAX and len(got) == len(ref_wav)
    np.testing.assert_allclose(got, ref_wav, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mel[0, :, :n].numpy(), ref_mel, rtol=0, atol=5e-4)
    wav2, _, _ = fn(x, x_len, face, 8)  # another seed, another draw
    assert not torch.equal(wav, wav2)


def test_program_matches_jax(bundle):
    """The program on injected noise against JAX's encode + decode(noise) +
    HiFi-GAN on the same weights."""
    x, x_len, face = bundle["x"], bundle["x_len"], bundle["face"]
    noise = np.random.default_rng(2).standard_normal((1, 128, Y_MAX)).astype(np.float32)
    jm, jh, variables = bundle["jm"], bundle["jh"], bundle["variables"]
    _, j_mel, _, j_ylen = jax.jit(
        lambda v, x_, xl, f, n: jm.apply(v, x_, xl, T, Y_MAX, RECIPE["temperature"], False, f,
                                         RECIPE["length_scale"], jax.random.PRNGKey(0), False, n)
    )(variables, x, x_len, face, noise)
    j_wav = np.asarray(jax.jit(jh.apply)({"params": bundle["hp"]}, j_mel))
    j_mel, j_ylen = np.asarray(j_mel), np.asarray(j_ylen)

    program = torch.export.load(os.path.join(bundle["out"], f"synth_tx{TX}_ty{Y_MAX}.pt2"))
    with torch.no_grad():
        wav, mel, y_len = program.module()(torch.from_numpy(x), torch.from_numpy(x_len),
                                           torch.from_numpy(face), torch.from_numpy(noise))
    mel, wav = mel.numpy(), wav.numpy()
    assert np.isfinite(mel).all() and np.isfinite(wav).all()
    np.testing.assert_array_equal(y_len.numpy(), j_ylen.astype(np.int32))
    n = int(j_ylen[0])
    assert 32 <= n < Y_MAX
    d = np.abs(mel[0, :, :n] - j_mel[0, :, :n])
    assert d.max() < 2e-3 and d.mean() < 2e-4, (d.max(), d.mean())
    assert not mel[0, :, n:].any(), "masked tail is not exactly zero"
    # the vocoder over the whole bucket: the mel's gap carried through
    # HiFi-GAN (test_torch_models.py holds the vocoder alone to 1e-4)
    np.testing.assert_allclose(wav, j_wav, rtol=0, atol=1e-3)


def _jax_manifest():
    """The JAX bundle's manifest keys, its entries' keys and its signature,
    read from ``facegantts_tpu/export.py``'s dict literals."""
    with open(os.path.join(ROOT, "facegantts_tpu", "export.py")) as f:
        tree = ast.parse(f.read())
    dicts = [{k.value: v for k, v in zip(n.keys, n.values)} for n in ast.walk(tree)
             if isinstance(n, ast.Dict) and n.keys
             and all(isinstance(k, ast.Constant) for k in n.keys)]
    manifest = next(d for d in dicts if "signature" in d)
    entry = next(d for d in dicts if "platforms" in d)
    return set(manifest), set(entry), manifest["signature"].value


def test_manifest_has_jax_keys(bundle):
    from facegantts_tpu.export import MANIFEST as JAX_MANIFEST

    from facegantts_tpu_torch.export import MANIFEST

    keys, entry_keys, signature = _jax_manifest()
    m = bundle["manifest"]
    assert MANIFEST == JAX_MANIFEST and set(m) == keys and m["signature"] == signature
    assert [set(e) for e in m["entries"]] == [entry_keys]
    assert m["entries"][0]["platforms"] == ["cpu"] and m["n_timesteps"] == T


def test_export_cli_from_a_migrated_checkpoint(tmp_path):
    """``python -m facegantts_tpu_torch.migrate_checkpoint`` turns a reference
    file into a port checkpoint directory; ``python -m
    facegantts_tpu_torch.export resume_from=<that dir>`` exports it; a loaded
    call equals a Synthesizer holding the same weights."""
    from facegantts_tpu_torch import export, migrate_checkpoint
    from facegantts_tpu_torch.models.facetts import FaceTTS
    from facegantts_tpu_torch.synthesis import Synthesizer
    from facegantts_tpu_torch.train.checkpoint import generator_state_dict

    tiny = dict(n_enc_channels="16", filter_channels="32", filter_channels_dp="16",
                n_enc_layers="1", dec_dim="8", vid_emb_dim="32", syncnet_width_mult="0.125",
                spk_emb="face", use_gan="0", use_bf16="0", timesteps="2", temperature="8",
                text_buckets="16", mel_buckets="64")
    args = [f"{k}={v}" for k, v in tiny.items()] + ["device=cpu"]
    cfg = default_config(env={}, overrides=tiny)
    torch.manual_seed(3)
    sd = FaceTTS.from_config(cfg).state_dict()
    torch.save({"state_dict": {**sd, "discriminator.w": torch.ones(3)}}, tmp_path / "ref.pt")
    migrate_checkpoint.main([f"src={tmp_path / 'ref.pt'}", f"dst={tmp_path / 'ckpt'}", *args])
    export.main([f"out_dir={tmp_path / 'bundle'}", f"resume_from={tmp_path / 'ckpt'}", *args])

    _, fns = export.load_bundle(str(tmp_path / "bundle"))
    synth = Synthesizer(cfg, state_dict=generator_state_dict(cfg, str(tmp_path / "ckpt")),
                        device="cpu")
    assert all(torch.equal(synth.model.state_dict()[k], v) for k, v in sd.items())
    ids = np.arange(1, 6, dtype=np.int32)
    x = np.zeros((1, 16), np.int32)
    x[0, :5] = ids
    face = np.zeros((1, 224, 224, 3), np.float32)
    wav, mel, y_len = fns[(16, 64)](x, np.array([5], np.int32), face, 3)
    ref_wav, ref_mel = synth.synthesize(ids, face[0], seed=3)
    n = int(y_len[0])
    assert n == ref_mel.shape[1] < 64
    np.testing.assert_allclose(np.clip(wav[0, :n * cfg.hop_len].numpy(), -1, 1), ref_wav,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(mel[0, :, :n].numpy(), ref_mel, rtol=0, atol=5e-4)
