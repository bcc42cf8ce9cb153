"""The PyTorch port's serving slice on the CPU: streaming, weight swaps and
the HTTP server.

- ``Synthesizer.stream_vocode``: the chunks concatenate to one vocoder call
  on the whole mel, to 1e-6 in f32 (a few ulp: oneDNN blocks a convolution
  by its length, so two lengths sum in another order) and to 0.05 in bf16
  (the bar of the JAX package's bf16 streaming test,
  ``tests/test_synthesis.py``); a margin far too small misses by more than
  1e-3; a mel no longer than a window is one call; chunk by chunk it equals
  the JAX ``stream_vocode`` of the same weights to 1e-5 (the vocoder import
  bar of ``tests/test_torch_checkpoint.py``);
- ``synthesize_streaming`` against the vocoder on the same mel;
- ``update_params``: the same waveform as a Synthesizer built with those
  weights, the duration cache cleared, bf16 modules kept in bf16;
- the server (``facegantts_tpu_torch.serve``): the endpoints and error
  paths of ``tests/test_serve.py``, ``/synthesize`` against a direct call,
  ``/synthesize_stream`` against ``/synthesize``, a per-request face
  without PIL answered 400, every request's synthesis on the service's one
  worker thread, and ``main`` loading a checkpoint directory and a bshall
  vocoder file.

Dims: the JAX train tests' TINY generator, the Config's vocoder, buckets
(16,) and (64,), 2 reverse steps; torch on one thread."""

import base64
import http.client
import io
import json
import sys
import threading
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facegantts_tpu.config import default_config as jax_default_config
from facegantts_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from facegantts_tpu.synthesis import Synthesizer as JSynthesizer
from facegantts_tpu.train.checkpoint import import_hifigan_state_dict
from facegantts_tpu_torch import serve
from facegantts_tpu_torch.config import default_config
from facegantts_tpu_torch.models.hifigan import HiFiGANGenerator
from facegantts_tpu_torch.serve import SynthesisService, make_server, wav_bytes
from facegantts_tpu_torch.synthesis import Synthesizer
from facegantts_tpu_torch.train import checkpoint as ck
from test_torch_train import TINY
from torch_cpu import torch_threads_started  # noqa: F401

SYNTH = dict(TINY, spk_emb="face", use_bf16="0")
# a small HiFi-GAN (tests/test_import.py's _THifi): 4 samples a frame
SMALL_VOC = dict(in_channels=16, upsample_initial_channel=32, upsample_rates=(2, 2),
                 upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3, 5),
                 resblock_dilations=((1, 3, 5), (1, 3, 5)))
SMALL_HOP = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    env = dict(SYNTH, **{k: str(v) for k, v in kw.items()})
    return default_config(env=env).replace(text_buckets=(16,), mel_buckets=(64,))


def _synth(**kw) -> Synthesizer:
    return Synthesizer(_cfg(**kw), device="cpu")


def _mel(n_mels, frames, seed=0):
    return np.random.default_rng(seed).standard_normal((n_mels, frames)).astype(np.float32)


def _vocode(synth, mel):
    with torch.inference_mode():
        m = torch.as_tensor(mel)[None].to(synth.dtype)
        return np.clip(synth.vocoder(m).float()[0].numpy(), -1.0, 1.0)


# ---------------------------------------------------------------------------
# streaming


def test_stream_vocode_matches_full_call():
    synth = _synth()
    assert synth.vocoder.margin_frames() == 24
    mel = _mel(synth.cfg.n_mels, 200)
    full = _vocode(synth, mel)
    chunks = list(synth.stream_vocode(mel, chunk_frames=48))
    assert [len(c) for c in chunks] == [48 * 160] * 4 + [8 * 160]
    got = np.concatenate(chunks)
    assert got.dtype == np.float32 and len(got) == len(full) == 200 * synth.cfg.hop_len
    np.testing.assert_allclose(got, full, rtol=0, atol=1e-6)
    # the margin has teeth: one far too small misses
    bad = np.concatenate(list(synth.stream_vocode(mel, chunk_frames=48, margin=1)))
    assert np.abs(bad - full).max() > 1e-3


def test_stream_vocode_short_mel_is_one_call():
    synth = _synth()
    mel = _mel(synth.cfg.n_mels, 40, seed=1)
    chunks = list(synth.stream_vocode(mel, chunk_frames=64))
    assert len(chunks) == 1 and len(chunks[0]) == 40 * synth.cfg.hop_len
    np.testing.assert_array_equal(chunks[0], _vocode(synth, mel))


def test_stream_vocode_bf16_within_bar():
    synth = _synth(use_bf16=1)
    assert next(synth.vocoder.parameters()).dtype == torch.bfloat16
    mel = _mel(synth.cfg.n_mels, 150, seed=2)
    got = np.concatenate(list(synth.stream_vocode(mel, chunk_frames=32)))
    full = _vocode(synth, mel)
    assert len(got) == len(full)
    np.testing.assert_allclose(got, full, rtol=0, atol=0.05)


@pytest.mark.parametrize("chunk_frames", [8, 13])
def test_stream_vocode_matches_jax(chunk_frames):
    """The port's and the JAX ``stream_vocode`` on one small HiFi-GAN, the
    weights carried to JAX by ``import_hifigan_state_dict``: the same
    windows, each chunk within 1e-5."""
    torch.manual_seed(5)
    voc = HiFiGANGenerator(**SMALL_VOC).eval()
    synth = _synth()
    synth.vocoder, synth.cfg = voc, synth.cfg.replace(hop_len=SMALL_HOP)
    jcfg = jax_default_config(env=SYNTH).replace(hop_len=SMALL_HOP)
    jsynth = JSynthesizer(jcfg, params={}, vocoder_params=import_hifigan_state_dict(
        voc.state_dict()))
    jsynth.vocoder = JHiFiGAN(**SMALL_VOC)
    assert voc.margin_frames() == jsynth.vocoder.margin_frames()
    mel = _mel(16, 70, seed=3)
    got = list(synth.stream_vocode(mel, chunk_frames=chunk_frames))
    want = list(jsynth.stream_vocode(jnp.asarray(mel), chunk_frames=chunk_frames))
    assert [len(c) for c in got] == [len(c) for c in want] and len(got) > 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.concatenate(got), _vocode(synth, mel), rtol=0, atol=1e-6)


def test_synthesize_streaming_matches_vocode_of_same_mel():
    synth = _synth()
    face = np.zeros((224, 224, 3), np.float32)
    ids = np.arange(1, 11, dtype=np.int32)
    wav, mel = synth.synthesize(ids, face, seed=5)
    got = np.concatenate(list(synth.synthesize_streaming(ids, face, seed=5, chunk_frames=16)))
    assert len(got) == len(wav) == mel.shape[1] * synth.cfg.hop_len
    np.testing.assert_allclose(got, _vocode(synth, mel), rtol=0, atol=1e-6)
    # /synthesize vocodes the bucket-padded mel: equal away from its tail
    m = synth.vocoder.margin_frames() * synth.cfg.hop_len
    np.testing.assert_allclose(got[:-m], wav[:-m], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# update_params


@pytest.mark.parametrize("use_bf16", [0, 1])
def test_update_params_equals_built_synthesizer(use_bf16):
    cfg = _cfg(use_bf16=use_bf16)
    donor = Synthesizer(cfg, seed=7, device="cpu")
    sd = {k: v.float() for k, v in donor.model.state_dict().items()}  # f32, as from a file
    vsd = {k: v.float() for k, v in donor.vocoder.state_dict().items()}
    built = Synthesizer(cfg, state_dict=sd, vocoder_state_dict=vsd, device="cpu")
    live = Synthesizer(cfg, seed=0, device="cpu")
    face = np.zeros((224, 224, 3), np.float32)
    before, _ = live.synthesize("hello world", face, seed=1)
    assert live._ty_cache
    live.update_params(state_dict=sd, vocoder_state_dict=vsd)
    assert not live._ty_cache
    want = torch.bfloat16 if use_bf16 else torch.float32
    for mod in (live.model.decoder, live.vocoder):
        assert {p.dtype for p in mod.parameters()} == {want}
    assert {p.dtype for p in live.model.encoder.parameters()} == {torch.float32}
    got, _ = live.synthesize("hello world", face, seed=1)
    ref, _ = built.synthesize("hello world", face, seed=1)
    np.testing.assert_array_equal(got, ref)
    assert len(before) != len(got) or not np.array_equal(before, got)


# ---------------------------------------------------------------------------
# the server


@pytest.fixture(scope="module")
def server():
    service = SynthesisService(_cfg(), device="cpu")
    srv = make_server(service, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, service
    srv.shutdown()
    srv.server_close()
    service.close()


def _request(srv, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection(*srv.server_address)
    conn.request(method, path, body=raw if raw is not None else
                 (json.dumps(body) if body is not None else None),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


def _parse_wav(data: bytes):
    with wave.open(io.BytesIO(data), "rb") as w:
        assert w.getnchannels() == 1 and w.getsampwidth() == 2
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), np.int16)


def _face_b64():
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((64, 64, 3), 128, np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_health(server):
    srv, _ = server
    resp, data = _request(srv, "GET", "/health")
    assert resp.status == 200
    h = json.loads(data)
    assert h["status"] == "ok" and h["platform"] == "cpu" and h["device"] == "cpu"


def test_synthesis_runs_on_one_worker_thread(server, monkeypatch):
    """Every request's synthesis runs on the service's one worker thread
    (PyTorch keeps cuDNN's execution plans per thread), never on the
    handler's thread of that request."""
    srv, service = server
    seen, orig = [], Synthesizer.synthesize

    def synthesize(self, *a, **k):
        seen.append(threading.get_ident())
        return orig(self, *a, **k)

    monkeypatch.setattr(Synthesizer, "synthesize", synthesize)
    for _ in range(3):
        assert _request(srv, "POST", "/synthesize", {"text": "hi"})[0].status == 200
    assert len(seen) == 3 and len(set(seen)) == 1
    assert seen[0] != threading.get_ident()
    assert seen[0] == service._run(threading.get_ident)


def test_synthesize_wav_equals_direct_call(server):
    srv, service = server
    before = service.requests
    resp, data = _request(srv, "POST", "/synthesize", {"text": "hello world", "seed": 3})
    assert resp.status == 200 and resp.getheader("Content-Type") == "audio/wav"
    sr, pcm = _parse_wav(data)
    assert sr == service.cfg.sample_rate
    assert len(pcm) > 0 and len(pcm) % service.cfg.hop_len == 0
    assert service.requests == before + 1
    wav, _ = service.synth.synthesize("hello world", service.default_face, seed=3)
    assert data == wav_bytes(wav, sr)
    h = json.loads(_request(srv, "GET", "/health")[1])
    assert h["requests"] >= 1 and h["audio_seconds"] > 0 and h["rtf"] > 0


def test_synthesize_json_format_and_determinism(server):
    srv, _ = server
    req = {"text": "hello world", "format": "json", "seed": 7}
    r1 = json.loads(_request(srv, "POST", "/synthesize", req)[1])
    r2 = json.loads(_request(srv, "POST", "/synthesize", req)[1])
    assert r1["sample_rate"] == r2["sample_rate"] and r1["wav_b64"] == r2["wav_b64"]
    _, pcm = _parse_wav(base64.b64decode(r1["wav_b64"]))
    assert abs(len(pcm) / r1["sample_rate"] - r1["seconds"]) < 0.01


def test_per_request_face(server):
    srv, _ = server
    base = {"text": "hello world", "format": "json", "seed": 0}
    with_face = json.loads(_request(srv, "POST", "/synthesize",
                                    dict(base, face_b64=_face_b64()))[1])
    without = json.loads(_request(srv, "POST", "/synthesize", base)[1])
    assert with_face["wav_b64"] != without["wav_b64"]


def test_per_request_face_without_pil_is_400(server, monkeypatch):
    srv, _ = server
    face = _face_b64()
    monkeypatch.setitem(sys.modules, "PIL", None)
    resp, data = _request(srv, "POST", "/synthesize", {"text": "hello world", "face_b64": face})
    assert resp.status == 400 and "PIL" in json.loads(data)["error"]
    resp, _ = _request(srv, "POST", "/synthesize", {"text": "hello world"})
    assert resp.status == 200  # the default face still serves


def test_synthesize_batch(server):
    srv, service = server
    resp, data = _request(srv, "POST", "/synthesize_batch",
                          {"texts": ["hello world", "a much longer test sentence"]})
    assert resp.status == 200
    out = json.loads(data)
    assert len(out["wavs_b64"]) == 2
    for b in out["wavs_b64"]:
        sr, pcm = _parse_wav(base64.b64decode(b))
        assert sr == service.cfg.sample_rate and len(pcm) > 0


def test_error_paths(server):
    srv, _ = server
    assert _request(srv, "POST", "/synthesize", {})[0].status == 400  # no text
    assert _request(srv, "GET", "/nope")[0].status == 404
    assert _request(srv, "POST", "/nope", {"text": "x"})[0].status == 404
    assert _request(srv, "POST", "/synthesize_batch", {"texts": []})[0].status == 400
    assert _request(srv, "POST", "/synthesize", raw="{not json")[0].status == 400


def test_warmup_runs_every_bucket_pair(server):
    _, service = server
    cfg = service.cfg
    assert service.warmup() == len(cfg.text_buckets) * len(cfg.mel_buckets)


def test_wav_bytes_roundtrip():
    y = np.sin(np.linspace(0, 40 * np.pi, 1600)).astype(np.float32) * 0.5
    sr, pcm = _parse_wav(wav_bytes(y, 16000))
    assert sr == 16000 and len(pcm) == 1600
    np.testing.assert_allclose(pcm / 32767.0, y, atol=1e-3)


def test_synthesize_stream_matches_synthesize(server):
    srv, service = server
    body = {"text": "hello world", "seed": 7}
    resp, data = _request(srv, "POST", "/synthesize", body)
    sr, ref = _parse_wav(data)
    resp, data = _request(srv, "POST", "/synthesize_stream", dict(body, chunk_frames=16))
    assert resp.status == 200
    assert resp.getheader("X-Sample-Rate") == str(sr)
    assert resp.getheader("X-PCM-Format") == "s16le"
    got = np.frombuffer(data, "<i2")  # http.client undoes the chunking
    m = service.synth.vocoder.margin_frames() * service.cfg.hop_len
    assert len(got) == len(ref)
    # away from /synthesize's bucket-padding tail: at most 1 LSB, from
    # rounding floats equal to a few ulp
    assert np.abs(got[:-m].astype(np.int32) - ref[:-m].astype(np.int32)).max() <= 1


def test_serve_main_loads_weight_files(tmp_path, monkeypatch):
    """``main`` with ``resume_from`` a port checkpoint directory and
    ``vocoder_ckpt`` a bshall file serves those weights; ``serve_mesh=1``
    and a missing checkpoint raise."""
    from facegantts_tpu_torch.train.state import TrainState
    from facegantts_tpu_torch.train.step import init_state

    cfg = _cfg()
    state = init_state(cfg.replace(use_gan=0), "cpu")
    ck.save_checkpoint(str(tmp_path / "ckpt"), state, step=3)
    assert isinstance(state, TrainState)
    torch.manual_seed(9)
    voc = HiFiGANGenerator(in_channels=cfg.n_mels)
    for m in voc.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            torch.nn.utils.weight_norm(m)
    torch.save({"generator": voc.state_dict()}, tmp_path / "hifigan.pt")

    made = []
    orig_init = SynthesisService.__init__

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        made.append(self)

    def serve_forever(self, *a, **k):
        raise KeyboardInterrupt

    monkeypatch.setattr(SynthesisService, "__init__", init)
    monkeypatch.setattr(serve.ThreadingHTTPServer, "serve_forever", serve_forever)
    args = [f"{k}={v}" for k, v in SYNTH.items()] + [
        "device=cpu", "port=0", "host=127.0.0.1", "text_buckets=16", "mel_buckets=64",
        f"resume_from={tmp_path / 'ckpt'}", f"vocoder_ckpt={tmp_path / 'hifigan.pt'}"]
    serve.main(args)
    (service,) = made
    for k, v in state.model.state_dict().items():
        assert torch.equal(service.synth.model.state_dict()[k], v), k
    folded = ck.load_hifigan_state_dict(str(tmp_path / "hifigan.pt"))
    for k, v in service.synth.vocoder.state_dict().items():
        assert torch.equal(v, folded[k]), k
    with torch.no_grad():
        mel = torch.randn(1, cfg.n_mels, 12)
        np.testing.assert_allclose(service.synth.vocoder(mel).numpy(), voc(mel).numpy(),
                                   rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="serve_mesh=1"):
        serve.main(args + ["serve_mesh=1"])
    with pytest.raises(FileNotFoundError, match="resume_from"):
        serve.main(args[:-2] + [f"resume_from={tmp_path / 'missing'}"])
