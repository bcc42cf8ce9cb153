"""HTTP synthesis server of the PyTorch port: text (+ face) -> 16 kHz wav
over the wire (the JAX package's ``serve.py``, standard library only).

One :class:`Synthesizer` per process on one device (the GPU unless
``device=cpu``).  Requests are served by a thread each (ThreadingHTTPServer);
synthesis is serialised by a lock, since the process drives one card, and
runs on one worker thread that lives as long as the service: PyTorch keeps
cuDNN's execution plans per thread, so a fresh thread per request would
build every convolution's plan again.

Endpoints:
  GET  /health            -> {"status": "ok", platform ("gpu" / "cpu"),
                              device, requests, audio_seconds, rtf}
  POST /synthesize        {"text": str, "face_b64"?: str, "n_timesteps"?,
                           "temperature"?, "seed"?} -> audio/wav bytes
                           (or JSON {"wav_b64", "sample_rate", "seconds"}
                           with {"format": "json"})
  POST /synthesize_stream {"text": str, "face_b64"?, "chunk_frames"?, ...}
                          -> chunked-transfer raw s16le PCM (the sample rate
                          in the X-Sample-Rate header), vocoded window by
                          window (``Synthesizer.synthesize_streaming``)
  POST /synthesize_batch  {"texts": [str], "face_b64"?, ...} ->
                           {"wavs_b64": [...], "sample_rate": N}

Usage:
  python -m facegantts_tpu_torch.serve port=8080 resume_from=<ckpt> \\
      vocoder_ckpt=<hifigan.pt> test_faceimg=test/face.png [warmup_buckets=1] \\
      [device=cpu]

``resume_from`` and ``vocoder_ckpt`` load as in
``python -m facegantts_tpu_torch.inference``.  ``warmup_buckets=1`` runs one
request in every (text, mel) bucket pair at start-up (nothing compiles: it
settles cuDNN's algorithm choice and the allocator's pools).  A per-request
``face_b64`` needs PIL; without it such a request is answered 400 and the
default face still serves.  ``serve_mesh=1`` (data-parallel serving) is not
ported yet and raises.
"""

from __future__ import annotations

import base64
import io
import json
import os
import sys
import threading
import time
import wave
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from facegantts_tpu_torch.config import Config, default_config, parse_cli_overrides


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """float [-1, 1] -> RIFF/WAV int16 PCM bytes."""
    pcm = (np.clip(np.asarray(wav, np.float32), -1.0, 1.0) * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


class SynthesisService:
    """Synthesizer + default face + serving stats behind one lock."""

    def __init__(self, cfg: Config, state_dict=None, vocoder_state_dict=None, cmudict=None,
                 default_face: Optional[np.ndarray] = None, device=None):
        from facegantts_tpu_torch.synthesis import Synthesizer

        self.cfg = cfg
        self.synth = Synthesizer(cfg, state_dict=state_dict,
                                 vocoder_state_dict=vocoder_state_dict, cmudict=cmudict,
                                 device=device)
        if default_face is None:
            default_face = np.zeros((cfg.image_size, cfg.image_size, 3), np.float32)
        self.default_face = self.synth.prepare_face(default_face)
        self.lock = threading.Lock()
        self._worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="synthesis")
        self.requests = 0
        self.audio_seconds = 0.0
        self.busy_seconds = 0.0

    def _run(self, fn, *args, **kw):
        """fn(*args, **kw) on the worker thread; its result or its error."""
        return self._worker.submit(fn, *args, **kw).result()

    def close(self) -> None:
        self._worker.shutdown()

    def decode_face(self, face_b64: Optional[str]):
        if not face_b64:
            return self.default_face
        try:
            from PIL import Image
        except ImportError:
            raise ValueError("face_b64 needs the PIL package (pillow), which is not "
                             "installed here; send no face_b64 for the default face") from None

        img = Image.open(io.BytesIO(base64.b64decode(face_b64)))
        img = img.convert("RGB").resize((self.cfg.image_size, self.cfg.image_size),
                                        Image.BILINEAR)
        # BGR 0..255, the SyncNet input convention (synthesis.load_face)
        face = np.asarray(img, np.float32)[..., ::-1].copy()
        return self.synth.prepare_face(face)

    def warmup(self) -> int:
        """One request in every (text, mel) bucket pair; returns how many."""
        with self.lock:
            return self._run(self._warm_buckets)

    @torch.inference_mode()
    def _warm_buckets(self) -> int:
        cfg, synth = self.cfg, self.synth
        n = 0
        for tx in cfg.text_buckets:
            x = np.ones((1, tx), np.int32)
            enc = synth._encode(x, np.array([tx], np.int32), self.default_face)
            for ty in cfg.mel_buckets:
                synth._decode_vocode(enc, ty, cfg.timesteps, cfg.temperature, False, 0)
                n += 1
        return n

    def _account(self, t0: float, n_requests: int, n_samples: int) -> None:
        self.busy_seconds += time.monotonic() - t0
        self.requests += n_requests
        self.audio_seconds += n_samples / self.cfg.sample_rate

    def synthesize(self, text, face, **kw) -> np.ndarray:
        t0 = time.monotonic()
        with self.lock:
            wav, _ = self._run(self.synth.synthesize, text, face, return_mel=False, **kw)
        self._account(t0, 1, len(wav))
        return wav

    def synthesize_streaming(self, text, face, chunk_frames: int = 64, **kw):
        """Yield float32 wav chunks under the service lock (the generator is
        drained inside the lock: one card, one stream of launches)."""
        t0 = time.monotonic()
        total = 0
        with self.lock:
            chunks = self.synth.synthesize_streaming(text, face, chunk_frames=chunk_frames, **kw)
            try:
                while (chunk := self._run(next, chunks, None)) is not None:
                    total += len(chunk)
                    yield chunk
            finally:
                self._run(chunks.close)
        self._account(t0, 1, total)

    def synthesize_batch(self, texts, face, **kw):
        t0 = time.monotonic()
        with self.lock:
            wavs = self._run(self.synth.synthesize_batch, texts, face, **kw)
        self._account(t0, len(texts), sum(len(w) for w in wavs))
        return wavs

    def health(self) -> dict:
        dev = self.synth.device
        on_gpu = dev.type == "cuda"
        return {
            "status": "ok",
            "platform": "gpu" if on_gpu else "cpu",
            "device": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
            "requests": self.requests,
            "audio_seconds": round(self.audio_seconds, 3),
            # serving-side RTF: busy time per generated audio second
            "rtf": round(self.busy_seconds / self.audio_seconds, 4)
            if self.audio_seconds else None,
        }


class _Handler(BaseHTTPRequestHandler):
    service: SynthesisService  # set by make_server
    # HTTP/1.1 for Transfer-Encoding: chunked on /synthesize_stream; every
    # other response sends Content-Length, so keep-alive framing holds
    protocol_version = "HTTP/1.1"
    # the headers and the body go out in separate writes: with Nagle's
    # algorithm the body waits for the client's delayed ACK of the headers
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # quiet by default
        if os.environ.get("SERVE_VERBOSE"):
            super().log_message(fmt, *args)

    def _json(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/health":
            self._json(200, self.service.health())
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            return self._json(400, {"error": f"bad JSON: {e}"})
        try:
            if self.path == "/synthesize":
                return self._synthesize(req)
            if self.path == "/synthesize_stream":
                return self._synthesize_stream(req)
            if self.path == "/synthesize_batch":
                return self._synthesize_batch(req)
            return self._json(404, {"error": f"unknown path {self.path}"})
        except (KeyError, TypeError, ValueError) as e:
            return self._json(400, {"error": str(e)})

    @staticmethod
    def _sampling_kw(req: dict) -> dict:
        kw = {}
        if "n_timesteps" in req:
            kw["n_timesteps"] = int(req["n_timesteps"])
        if "temperature" in req:
            kw["temperature"] = float(req["temperature"])
        if "seed" in req:
            kw["seed"] = int(req["seed"])
        return kw

    def _synthesize(self, req: dict):
        text = req["text"]
        face = self.service.decode_face(req.get("face_b64"))
        wav = self.service.synthesize(text, face, **self._sampling_kw(req))
        sr = self.service.cfg.sample_rate
        body = wav_bytes(wav, sr)
        if req.get("format") == "json":
            return self._json(200, {"wav_b64": base64.b64encode(body).decode(),
                                    "sample_rate": sr, "seconds": round(len(wav) / sr, 3)})
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _synthesize_stream(self, req: dict):
        """Chunked transfer of raw little-endian int16 mono PCM, flushed
        chunk by chunk as the tiled vocoder emits it."""
        text = req["text"]
        face = self.service.decode_face(req.get("face_b64"))
        chunk_frames = int(req.get("chunk_frames", 64))
        gen = self.service.synthesize_streaming(text, face, chunk_frames=chunk_frames,
                                                **self._sampling_kw(req))
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("X-Sample-Rate", str(self.service.cfg.sample_rate))
        self.send_header("X-PCM-Format", "s16le")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for chunk in gen:
                pcm = (np.clip(chunk, -1.0, 1.0) * 32767).astype("<i2").tobytes()
                self.wfile.write(b"%x\r\n%s\r\n" % (len(pcm), pcm))
            self.wfile.write(b"0\r\n\r\n")
        finally:
            gen.close()  # a client gone mid-stream releases the lock now

    def _synthesize_batch(self, req: dict):
        texts = req["texts"]
        if not isinstance(texts, list) or not texts:
            raise ValueError("texts must be a non-empty list")
        face = self.service.decode_face(req.get("face_b64"))
        wavs = self.service.synthesize_batch(texts, face, **self._sampling_kw(req))
        sr = self.service.cfg.sample_rate
        return self._json(200, {
            "wavs_b64": [base64.b64encode(wav_bytes(w, sr)).decode() for w in wavs],
            "sample_rate": sr,
        })


def make_server(service: SynthesisService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    overrides = parse_cli_overrides(argv if argv is not None else sys.argv[1:])
    host = overrides.pop("host", "0.0.0.0")
    port = int(overrides.pop("port", 8080))
    warmup = int(overrides.pop("warmup_buckets", 0))
    if int(overrides.pop("serve_mesh", 0)):
        raise NotImplementedError(
            "serve_mesh=1: data-parallel serving is not ported yet (ROADMAP item 9 of "
            "section 1, data parallelism)")
    device = overrides.pop("device", None)
    cfg = default_config(overrides=overrides)

    from facegantts_tpu_torch.inference import load_weights
    from facegantts_tpu_torch.synthesis import load_face, resolve_device
    from facegantts_tpu_torch.text.cmudict import default_cmudict

    resolve_device(device)  # no card: raise before reading any weights
    state_dict, vocoder_state_dict = load_weights(cfg)
    face = None
    if os.path.exists(cfg.test_faceimg):
        try:
            face = load_face(cfg.test_faceimg, cfg.image_size)
        except ImportError:
            print(f"[WARN] PIL is not installed: {cfg.test_faceimg} is not read; the "
                  "default face is all zeros")
    service = SynthesisService(cfg, state_dict=state_dict,
                               vocoder_state_dict=vocoder_state_dict,
                               cmudict=default_cmudict(cfg.cmudict_path), default_face=face,
                               device=device)
    if warmup:
        print(f"######## Warmed {service.warmup()} bucket pairs")
    server = make_server(service, host, port)
    print(f"######## Serving on http://{host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
