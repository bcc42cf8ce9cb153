"""The PyTorch port's SSL MOS model (``models/wav2vec2.py``,
``evaluation/ssl_mos.py``) against the JAX package's, on the CPU, at the
tiny dims of ``tests/test_ssl_mos.py`` (hidden 24, 2 layers, 2 heads, FFN
48, conv dims (16, 16) with kernels (10, 3) and strides (5, 2), positional
conv in 2 groups, conditioning 6, BiLSTM 10, projection 32):

- each wav2vec2 module (conv feature encoder, feature projection,
  positional conv at an even and an odd kernel, transformer layer, the whole
  encoder), the BiLSTM and the whole ``UTMOSStrong`` on the same seeded
  inputs, with the weights carried both ways: JAX -> port by
  ``convert.utmos_state_dict``, port -> JAX by the JAX package's
  ``import_utmos_strong`` of the port's weights in HuggingFace naming.  Norm
  scales and every bias are moved off their initial values first.  Bars:
  MOS within 1e-5, features within 1e-4;
- the importer on HuggingFace- and fairseq-named files, with the positional
  conv's weight norm as ``parametrizations`` and as ``weight_g`` /
  ``weight_v``, and foreign keys: the same weights and the same
  ``unmapped`` list as JAX's importer, the same MOS;
- ``model_sizes`` against JAX's ``model_from_params`` (head-count rule
  included), the predictor at 16 and 8 kHz against JAX's, and
  ``make_mos_predictor``'s branches as in JAX (an SSL file, a linear head,
  a broken SSL file, no file); without CUDA an SSL file raises rather than
  fall back to the proxy;
- where ``transformers`` imports, HuggingFace's ``Wav2Vec2Model`` with its
  norms at 1e-6 holding the port's weights gives the port's features.

Torch runs on one thread, strict f32 (no TF32)."""

import numpy as np
import pytest
import torch

import jax
from facegantts_tpu.evaluation import ssl_mos as jssl
from facegantts_tpu.evaluation import utmos as jutmos
from facegantts_tpu.models import wav2vec2 as jw2v
from facegantts_tpu_torch import convert
from facegantts_tpu_torch.evaluation import ssl_mos, utmos
from torch_cpu import torch_threads_started  # noqa: F401

TINY = dict(hidden=24, layers=2, heads=2, ffn=48, conv_dims=(16, 16), cond_dim=6,
            blstm_hidden=10, proj_hidden=32, pos_groups=2)
MOS_BAR, FEAT_BAR = 1e-5, 1e-4
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
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


def _wav(seed=0, n=800, batch=2):
    return (np.random.default_rng(seed).standard_normal((batch, n)) * 0.1).astype(np.float32)


def _jax_params(pos_kernel, seed=0):
    """JAX ``UTMOSStrong`` params from its own init, norm scales moved off 1
    and every bias off 0 (seeded numpy)."""
    model = jssl.UTMOSStrong(**TINY, pos_kernel=pos_kernel)
    params = model.init(jax.random.PRNGKey(seed), _wav(batch=1))["params"]
    rng = np.random.default_rng(seed + 100)

    def move(path, leaf):
        leaf = np.asarray(leaf, np.float32)
        name = path[-1].key
        if name == "scale":
            return leaf + np.float32(0.1) * rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "bias" or name.startswith("b_"):
            return np.float32(0.1) * rng.standard_normal(leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(move, params)


def _port_model(seed=0, **sizes):
    """The port's ``UTMOSStrong`` from torch's init (seeded), norm weights and
    every bias moved as in :func:`_jax_params`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ssl_mos.UTMOSStrong(**sizes)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name and name.endswith("weight"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
            elif "bias" in name:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model.eval()


_PAIRS = {}


def _pair(direction, pos_kernel):
    """(JAX params, port model) holding the same weights."""
    key = (direction, pos_kernel)
    if key not in _PAIRS:
        if direction == "jax_to_port":
            jp = _jax_params(pos_kernel)
            port = ssl_mos.model_from_state_dict(convert.utmos_state_dict(jp), heads=2,
                                                 device="cpu")
        else:
            port = _port_model(**TINY, pos_kernel=pos_kernel)
            jp, info = jssl.import_utmos_strong(ssl_mos.reference_state_dict(port.state_dict()))
            assert info["unmapped"] == []
        _PAIRS[key] = (jp, port)
    return _PAIRS[key]


def _module_outputs(name, jp, port, pos_kernel):
    """(JAX output, port output) of one module on seeded inputs."""
    wav = _wav()
    feats = np.random.default_rng(1).standard_normal((2, 79, 24)).astype(np.float32)
    w = port.wav2vec2
    if name == "conv":
        j = jw2v.ConvFeatureEncoder((16, 16), (10, 3), (5, 2)).apply(
            {"params": jp["ssl"]["feature_extractor"]}, wav)
        return j, w.feature_extractor(torch.from_numpy(wav))
    if name == "projection":
        x = np.random.default_rng(2).standard_normal((2, 79, 16)).astype(np.float32)
        j = jw2v.FeatureProjection(24).apply({"params": jp["ssl"]["feature_projection"]}, x)
        return j, w.feature_projection(torch.from_numpy(x))
    if name == "pos_conv":
        j = jw2v.PositionalConvEmbedding(pos_kernel, 2).apply(
            {"params": jp["ssl"]["pos_conv_embed"]}, feats)
        return j, w.encoder["pos_conv_embed"](torch.from_numpy(feats))
    if name == "layer":
        j = jw2v.TransformerLayer(24, 2, 48).apply({"params": jp["ssl"]["layer_1"]}, feats)
        return j, w.encoder["layers"][1](torch.from_numpy(feats))
    if name == "encoder":
        j = jw2v.Wav2Vec2Encoder(hidden=24, layers=2, heads=2, ffn=48, conv_dims=(16, 16),
                                 pos_kernel=pos_kernel, pos_groups=2).apply(
            {"params": jp["ssl"]}, wav)
        return j, w(torch.from_numpy(wav))
    if name == "blstm":
        x = np.random.default_rng(3).standard_normal((2, 79, 36)).astype(np.float32)
        j = jssl.BiLSTM(10).apply({"params": jp["blstm"]}, x)
        return j, port.blstm(torch.from_numpy(x))[0]
    j = jssl.UTMOSStrong(**TINY, pos_kernel=pos_kernel).apply({"params": jp}, wav)
    return j, port(torch.from_numpy(wav))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("name, pos_kernel", [
    ("conv", 16), ("projection", 16), ("pos_conv", 16), ("pos_conv", 15), ("layer", 16),
    ("encoder", 16), ("encoder", 15), ("blstm", 16), ("utmos", 16), ("utmos", 15)])
def test_module_matches_jax(name, pos_kernel, direction):
    jp, port = _pair(direction, pos_kernel)
    with torch.no_grad():
        want, got = _module_outputs(name, jp, port, pos_kernel)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    bar = MOS_BAR if name == "utmos" else FEAT_BAR
    np.testing.assert_allclose(got, want, rtol=0, atol=bar)


def _with_foreign_keys(sd, naming):
    """A reference file's extra keys the importers must leave unmapped, and
    for fairseq a judge embedding of several listeners (row 0 is used)."""
    sd = dict(sd)
    if naming == "hf":
        sd["wav2vec2.masked_spec_embed"] = torch.zeros(24)
    else:
        sd["ssl_model.model.mask_emb"] = torch.zeros(24)
        sd["ssl_model.model.final_proj.weight"] = torch.zeros(4, 24)
        sd["judge_embedding.weight"] = torch.cat([sd["judge_embedding.weight"],
                                                  torch.ones(2, 6)])
    return sd


@pytest.mark.parametrize("weight_norm", ["parametrizations", "g_v"])
@pytest.mark.parametrize("naming", ["hf", "fairseq"])
def test_importer_matches_jax(naming, weight_norm):
    port = _port_model(**TINY, pos_kernel=16)
    own = port.state_dict()
    src = _with_foreign_keys(ssl_mos.reference_state_dict(own, naming, weight_norm), naming)
    if naming == "fairseq":
        assert "ssl_model.model.encoder.layers.0.fc1.weight" in src
        assert "ssl_model.model.post_extract_proj.weight" in src
    pos = ("wav2vec2.encoder.pos_conv_embed.conv" if naming == "hf"
           else "ssl_model.model.encoder.pos_conv.0")
    assert pos + ".weight" not in src and (
        pos + (".weight_g" if weight_norm == "g_v" else ".parametrizations.weight.original0")
        in src)
    got, info = ssl_mos.import_utmos_strong(src)
    jp, jinfo = jssl.import_utmos_strong(src)
    assert info["unmapped"] == jinfo["unmapped"] != []
    assert set(got) == set(own)
    for k, v in own.items():  # only the folded positional conv is not bitwise
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6 if "pos_conv" in k else 0)
    theirs = convert.utmos_state_dict(jax.tree.map(np.asarray, jp))
    for k in own:
        if "bias_hh" in k:
            continue
        if "bias_ih" in k:  # JAX folds the two biases
            want = got[k] + got[k.replace("bias_ih", "bias_hh")]
        else:
            want = got[k]
        np.testing.assert_allclose(theirs[k].numpy(), want.numpy(), rtol=0, atol=1e-7)
    wav = _wav()
    jm = jssl.model_from_params(jp, heads=2)
    with torch.no_grad():
        mos = ssl_mos.model_from_state_dict(got, heads=2, device="cpu")(torch.from_numpy(wav))
    np.testing.assert_allclose(mos.numpy(), np.asarray(jm.apply({"params": jp}, wav)),
                               rtol=0, atol=MOS_BAR)


@pytest.mark.parametrize("sizes", [
    TINY, dict(TINY, hidden=20, pos_groups=4), dict(TINY, hidden=30, pos_groups=3, layers=3),
    dict(TINY, conv_dims=(8, 12), cond_dim=3, blstm_hidden=7, proj_hidden=5)])
@pytest.mark.parametrize("pos_kernel", [16, 15])
def test_model_sizes_match_model_from_params(sizes, pos_kernel):
    port = _port_model(**sizes, pos_kernel=pos_kernel)
    jp, _ = jssl.import_utmos_strong(ssl_mos.reference_state_dict(port.state_dict()))
    jm = jssl.model_from_params(jp)
    got = ssl_mos.model_sizes(port.state_dict())
    assert got == {k: getattr(jm, k) for k in got}
    assert got["heads"] == {24: 12, 20: 4, 30: 6}[sizes["hidden"]]
    assert ssl_mos.model_sizes(port.state_dict(), heads=2)["heads"] == jssl.model_from_params(
        jp, heads=2).heads == 2


@pytest.mark.parametrize("sr", [16000, 8000])
def test_predictor_matches_jax(sr):
    jp, port = _pair("port_to_jax", 16)
    wav = _wav(seed=4, n=1601, batch=1)[0]
    if sr != SR:
        wav = wav[::2]
    ours = ssl_mos.SSLMOSPredictor(port)
    theirs = jssl.SSLMOSPredictor(jp, jssl.model_from_params(jp, heads=2))
    got, want = ours(wav, sr), theirs(wav, sr)
    assert isinstance(got, float) and ours.device == torch.device("cpu")
    assert abs(got - want) <= MOS_BAR, (got, want)


def _ssl_file(tmp_path, naming="hf"):
    port = _port_model(**TINY, pos_kernel=16)
    path = tmp_path / f"utmos_{naming}.pt"
    torch.save({"state_dict": ssl_mos.reference_state_dict(port.state_dict(), naming)}, path)
    return str(path)


@pytest.mark.parametrize("kind", ["ssl_hf", "ssl_fairseq", "head", "broken_ssl", "missing"])
def test_make_mos_predictor_branches_match_jax(kind, tmp_path, capsys):
    """The JAX factory's order: an SSL file gives the SSL model, a linear head
    the head, a file that does not import the next backend down."""
    if kind.startswith("ssl"):
        path = _ssl_file(tmp_path, kind[4:])
    elif kind == "missing":
        path = str(tmp_path / "none.pt")
    else:
        sd = {"head.weight": torch.tensor([[0.5, -1.0, -0.8, -0.3, 0.9]]),
              "head.bias": torch.tensor([3.1])}
        if kind == "broken_ssl":  # detected as SSL, but no projection to size it by
            sd["ssl_model.model.feature_extractor.conv_layers.0.conv.weight"] = torch.zeros(
                4, 1, 10)
        path = str(tmp_path / f"{kind}.pt")
        torch.save({"state_dict": sd}, path)
    ours, theirs = utmos.make_mos_predictor(path, device="cpu"), jutmos.make_mos_predictor(path)
    want_type = {"head": "LinearHeadMOSPredictor", "broken_ssl": "LinearHeadMOSPredictor",
                 "missing": "DSPMOSPredictor"}.get(kind, "SSLMOSPredictor")
    assert type(ours).__name__ == type(theirs).__name__ == want_type
    if kind.startswith("ssl"):
        assert isinstance(ours, ssl_mos.SSLMOSPredictor)
        assert {p.device.type for p in ours.model.parameters()} == {"cpu"}
    out = capsys.readouterr().out
    if kind == "broken_ssl":
        assert out.count("SSL MOS import failed") == 2
    if kind == "missing":
        assert out.count("using DSP proxy") == 2
    wav = _wav(seed=5, n=1600, batch=1)[0]
    assert abs(ours(wav, SR) - theirs(wav, SR)) <= MOS_BAR


def test_make_mos_predictor_without_cuda_raises(tmp_path, monkeypatch):
    """The SSL model goes to the GPU by default: without one the factory
    raises, and does not fall back to the linear head or the DSP proxy."""
    path = _ssl_file(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        utmos.make_mos_predictor(path)


def test_port_matches_huggingface_wav2vec2():
    """HuggingFace's ``Wav2Vec2Model`` (norms set to the JAX package's 1e-6)
    holding the port's encoder weights gives the port's features, and the
    port's head over them its MOS."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.Wav2Vec2Config(
        hidden_size=24, num_hidden_layers=2, num_attention_heads=2, intermediate_size=48,
        conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), num_feat_extract_layers=2,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2, feat_extract_norm="group",
        do_stable_layer_norm=False, conv_bias=False, hidden_act="gelu", hidden_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, activation_dropout=0.0, layerdrop=0.0,
        layer_norm_eps=1e-6)
    hf = transformers.Wav2Vec2Model(cfg).eval()
    for m in hf.modules():
        if isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            m.eps = 1e-6
    port = _port_model(**TINY, pos_kernel=16)
    ref = ssl_mos.reference_state_dict(port.state_dict())
    enc = {k[len("wav2vec2."):]: v for k, v in ref.items() if k.startswith("wav2vec2.")}
    missing, unexpected = hf.load_state_dict(enc, strict=False)
    assert missing == ["masked_spec_embed"] and unexpected == []
    wav = torch.from_numpy(_wav())
    with torch.no_grad():
        feats = hf(wav).last_hidden_state
        np.testing.assert_allclose(feats.numpy(), port.wav2vec2(wav).numpy(), rtol=0,
                                   atol=FEAT_BAR)
        cond = torch.cat([port.domain_emb.weight[0], port.judge_emb.weight[0]])
        x, _ = port.blstm(torch.cat([feats, cond.expand(*feats.shape[:2], -1)], -1))
        mos = port.projection(x)[..., 0].mean(-1) * 2 + 3
        np.testing.assert_allclose(mos.numpy(), port(wav).numpy(), rtol=0, atol=MOS_BAR)
