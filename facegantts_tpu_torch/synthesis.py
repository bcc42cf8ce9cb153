"""End-to-end synthesis: text + face image -> 16 kHz waveform, in torch.

Port of the JAX package's ``synthesis.py`` (reference inference.py:22-185):
face -> SyncNet embedding, text -> interspersed symbol ids, FaceTTS encode
and decode, HiFi-GAN vocoder.  Inputs are padded to the same text and mel
buckets as the JAX package, so both run the same shapes.

Runs on the GPU unless the caller asks for another device: with
``device=None`` a missing CUDA device raises, it never moves to the CPU on
its own.  With ``cfg.use_bf16`` the diffusion decoder and the vocoder run in
bfloat16 (the encoder and SyncNet stay f32) and the waveform is returned in
f32, as the JAX package's ``use_bf16`` does.  ``update_params`` swaps
weights in place; ``stream_vocode`` and ``synthesize_streaming`` vocode
window by window, the chunks concatenating to one vocoder call.
"""

import hashlib
import os
import weakref
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from facegantts_tpu_torch.config import Config
from facegantts_tpu_torch.models.facetts import FaceTTS
from facegantts_tpu_torch.models.hifigan import HiFiGANGenerator
from facegantts_tpu_torch.ops.align import fix_len_compatibility
from facegantts_tpu_torch.text import CMUDict, intersperse, text_to_sequence


def load_face(path: str, image_size: int = 224) -> np.ndarray:
    """PNG/JPG -> (H, W, 3) float32 in BGR channel order, 0..255 scale
    (the reference feeds raw cv2.imread output to SyncNet,
    inference.py:90-93)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((image_size, image_size), Image.BILINEAR)
    rgb = np.asarray(img, dtype=np.float32)
    return rgb[..., ::-1].copy()  # -> BGR


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return fix_len_compatibility(n)


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Synthesizer:
    """Holds the generator and vocoder on one device and serves utterances."""

    def __init__(
        self,
        cfg: Config,
        state_dict=None,
        vocoder_state_dict=None,
        cmudict: Optional[CMUDict] = None,
        seed: int = 0,
        device=None,
    ):
        """``state_dict`` / ``vocoder_state_dict``: the port's torch weights
        (see ``convert.py``); without them both models keep their random
        initialisation from ``seed`` -- the whole pipeline runs without
        checkpoints."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cmu = cmudict
        # initialise on the CPU so a seed gives the same weights everywhere
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = FaceTTS.from_config(cfg)
            vocoder = HiFiGANGenerator(in_channels=cfg.n_mels)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        if vocoder_state_dict is not None:
            vocoder.load_state_dict(vocoder_state_dict)
        self.model = model.eval().to(self.device)
        self.vocoder = vocoder.eval().to(self.device)
        self.dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        self.model.decoder.to(self.dtype)
        self.vocoder.to(self.dtype)
        # duration cache: (ids, face content digest) -> exact mel frames.
        # Durations are deterministic, so a repeated (text, face) pair has a
        # known mel bucket and synthesize() skips the mid-pipeline host sync.
        # LRU-bounded; entries pin no device memory.
        self._ty_cache: OrderedDict = OrderedDict()
        self._ty_cache_max = 4096
        # id(device tensor) -> (weakref, content digest) for prepare_face
        self._face_digests: dict = {}
        self._text_memo: OrderedDict = OrderedDict()
        self._text_memo_max = 4096

    # ------------------------------------------------------------- helpers
    def encode_text(self, text: str) -> np.ndarray:
        """text -> interspersed symbol ids, memoized (serving repeats prompts)."""
        ids = self._text_memo.get(text)
        if ids is None:
            seq = text_to_sequence(text, dictionary=self.cmu)
            if self.cfg.add_blank:
                seq = intersperse(seq)
            ids = np.asarray(seq, dtype=np.int32)
            self._text_memo[text] = ids
            if len(self._text_memo) > self._text_memo_max:
                self._text_memo.popitem(last=False)
        return ids

    @staticmethod
    def _face_digest(face: np.ndarray) -> str:
        return hashlib.blake2b(
            np.ascontiguousarray(face, np.float32).tobytes(), digest_size=16
        ).hexdigest()

    def prepare_face(self, face: np.ndarray) -> torch.Tensor:
        """Upload a face image once; pass the result to repeated synthesize
        calls to skip the per-call host-to-device copy."""
        arr = torch.as_tensor(np.asarray(face, np.float32)[None], device=self.device)
        if len(self._face_digests) > 512:  # prune dead weakrefs
            self._face_digests = {
                k: v for k, v in self._face_digests.items() if v[0]() is not None
            }
        self._face_digests[id(arr)] = (weakref.ref(arr), self._face_digest(face))
        return arr

    def _ids(self, text) -> np.ndarray:
        return self.encode_text(text) if isinstance(text, str) else np.asarray(text, np.int32)

    def _encode(self, x: np.ndarray, x_len: np.ndarray, face: torch.Tensor):
        return self.model.encode(
            torch.as_tensor(x, dtype=torch.long, device=self.device),
            torch.as_tensor(x_len, dtype=torch.long, device=self.device),
            face, self.cfg.length_scale,
        )

    def _decode(self, enc, ty: int, n_timesteps: int, temperature: float, stoc: bool,
                seed: int, noise: Optional[torch.Tensor] = None):
        """Diffusion decode at mel bucket ``ty`` in ``self.dtype``; returns
        (mel, y_lengths).  The initial noise is drawn from a generator seeded
        with ``seed``, or is ``noise`` (B, n_mels, ty) where given."""
        mu_x, w_ceil, x_mask, y_lengths, spk_e = enc
        mu_x, w_ceil, x_mask, spk_e = (t.to(self.dtype) for t in (mu_x, w_ceil, x_mask, spk_e))
        gen = torch.Generator(device=self.device).manual_seed(seed) if noise is None else None
        _, dec, _, y_len = self.model.decode(
            mu_x, w_ceil, x_mask, y_lengths, spk_e, n_timesteps, ty, temperature, stoc,
            generator=gen, noise=noise,
        )
        return dec, y_len

    def _decode_vocode(self, enc, ty: int, n_timesteps: int, temperature: float,
                       stoc: bool, seed: int, noise: Optional[torch.Tensor] = None):
        """:meth:`_decode` + vocoder; returns (wav f32, mel f32, y_lengths)."""
        dec, y_len = self._decode(enc, ty, n_timesteps, temperature, stoc, seed, noise)
        wav = self.vocoder(dec)
        return wav.float(), dec.float(), y_len

    def _prepare_text(self, text) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """ids, and the (1, T_x bucket) padded ids and their length."""
        ids = self._ids(text)
        x = np.zeros((1, pick_bucket(len(ids), self.cfg.text_buckets)), np.int32)
        x[0, : len(ids)] = ids
        return ids, x, np.array([len(ids)], np.int32)

    # -------------------------------------------------------------- public
    def update_params(self, state_dict=None, vocoder_state_dict=None) -> None:
        """Swap in new weights without rebuilding the Synthesizer: loaded in
        place into the live modules, which keep their device and dtype (the
        decoder and vocoder stay in ``self.dtype``).  The duration cache is
        cleared: new weights predict new durations."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        if vocoder_state_dict is not None:
            self.vocoder.load_state_dict(vocoder_state_dict)
        self._ty_cache.clear()

    @torch.inference_mode()
    def synthesize(
        self,
        text,
        face,
        n_timesteps: Optional[int] = None,
        temperature: Optional[float] = None,
        stoc: bool = False,
        seed: int = 0,
        return_mel: bool = True,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """One utterance -> (waveform float32 in [-1, 1], log-mel (n_mels, T)).

        ``text`` is a sentence or an int array of interspersed symbol ids;
        ``face`` a numpy image or a tensor from :meth:`prepare_face`."""
        cfg = self.cfg
        n_timesteps = n_timesteps or cfg.timesteps
        temperature = cfg.temperature if temperature is None else temperature

        ids, x, x_len = self._prepare_text(text)
        if isinstance(face, torch.Tensor):
            face_b = face
            ent = self._face_digests.get(id(face_b))
            digest = ent[1] if ent is not None and ent[0]() is face_b else None
        else:
            digest = self._face_digest(face)
            face_b = self.prepare_face(face)

        enc = self._encode(x, x_len, face_b)
        # content-keyed duration cache: a hit knows the mel bucket without
        # reading y_lengths back; faces of unknown provenance skip it
        cache_key = (ids.tobytes(), digest) if digest is not None else None
        frames = self._ty_cache.get(cache_key) if cache_key else None
        if frames is not None:
            self._ty_cache.move_to_end(cache_key)
        else:
            frames = int(np.ceil(float(enc[3][0])))  # the only host sync
            if cache_key is not None:
                self._ty_cache[cache_key] = frames
                if len(self._ty_cache) > self._ty_cache_max:
                    self._ty_cache.popitem(last=False)
        ty = pick_bucket(frames, cfg.mel_buckets)
        wav, dec, y_len = self._decode_vocode(enc, ty, n_timesteps, temperature, stoc, seed)
        n_frames = int(y_len[0])
        out = np.clip(wav[0, : n_frames * cfg.hop_len].cpu().numpy(), -1.0, 1.0)
        mel = dec[0, :, :n_frames].cpu().numpy() if return_mel else None
        return out, mel

    @torch.inference_mode()
    def stream_vocode(self, mel, chunk_frames: int = 64, margin: Optional[int] = None):
        """Tiled (streaming) vocoding: yield float32 waveform chunks, in
        order, of a log-mel of any length, one vocoder call of
        ``margin + chunk_frames + margin`` frames a chunk.

        HiFi-GAN is convolutional, so an output sample depends only on mel
        frames within ``vocoder.margin_frames()`` of its own.  The emitted
        region of each window stays ``margin`` frames from a window edge
        unless that edge is the signal's (the first window starts at frame
        0, the last ends at the last frame), so the chunks concatenate to
        one call on the whole mel; a mel no longer than a window is one
        call.  ``mel``: (n_mels, T) or (1, n_mels, T), numpy or a tensor,
        trimmed to its true length."""
        mel = torch.as_tensor(mel, device=self.device)
        if mel.ndim == 2:
            mel = mel[None]
        mel = mel.to(self.dtype)
        T = mel.shape[-1]
        hop = self.cfg.hop_len
        M = self.vocoder.margin_frames() if margin is None else margin
        S = chunk_frames + 2 * M
        if T <= S:
            wav = self.vocoder(mel).float()[0]
            yield np.clip(wav.cpu().numpy(), -1.0, 1.0)
            return
        for e in range(0, T, chunk_frames):
            p = max(0, min(e - M, T - S))
            wav = self.vocoder(mel[:, :, p:p + S]).float()
            lo, hi = e - p, min(e + chunk_frames, T) - p
            yield np.clip(wav[0, lo * hop:hi * hop].cpu().numpy(), -1.0, 1.0)

    @torch.inference_mode()
    def synthesize_streaming(
        self,
        text,
        face,
        n_timesteps: Optional[int] = None,
        temperature: Optional[float] = None,
        stoc: bool = False,
        seed: int = 0,
        chunk_frames: int = 64,
    ):
        """Streaming :meth:`synthesize`: encode and decode (the sampler needs
        the whole mel), then :meth:`stream_vocode` of the trimmed mel, so
        the first audio comes after one window's vocoder call.  The chunks
        concatenate to the vocoder's output on that mel."""
        cfg = self.cfg
        n_timesteps = n_timesteps or cfg.timesteps
        temperature = cfg.temperature if temperature is None else temperature
        _, x, x_len = self._prepare_text(text)
        face_b = face if isinstance(face, torch.Tensor) else self.prepare_face(face)
        enc = self._encode(x, x_len, face_b)
        ty = pick_bucket(int(np.ceil(float(enc[3][0]))), cfg.mel_buckets)
        dec, y_len = self._decode(enc, ty, n_timesteps, temperature, stoc, seed)
        yield from self.stream_vocode(dec[:, :, :int(y_len[0])], chunk_frames)

    @torch.inference_mode()
    def synthesize_batch(
        self,
        texts: List,
        face,
        n_timesteps: Optional[int] = None,
        temperature: Optional[float] = None,
        stoc: bool = False,
        seed: int = 0,
    ) -> List[np.ndarray]:
        """Many utterances with one face: one encode per text bucket, then
        one decode + vocode per mel bucket.  Returns wavs in input order."""
        cfg = self.cfg
        n_timesteps = n_timesteps or cfg.timesteps
        temperature = cfg.temperature if temperature is None else temperature
        face_b = face if isinstance(face, torch.Tensor) else self.prepare_face(face)

        all_ids = [self._ids(t) for t in texts]
        by_tx: dict = {}
        for i, ids in enumerate(all_ids):
            by_tx.setdefault(pick_bucket(len(ids), cfg.text_buckets), []).append(i)

        wavs: List[Optional[np.ndarray]] = [None] * len(texts)
        for tx, idxs in by_tx.items():
            x = np.zeros((len(idxs), tx), np.int32)
            x_len = np.zeros((len(idxs),), np.int32)
            for r, i in enumerate(idxs):
                x[r, : len(all_ids[i])] = all_ids[i]
                x_len[r] = len(all_ids[i])
            enc = self._encode(x, x_len, face_b.expand(len(idxs), *face_b.shape[1:]))
            frames = np.ceil(enc[3].cpu().numpy()).astype(np.int32)
            by_ty: dict = {}
            for r in range(len(idxs)):
                by_ty.setdefault(pick_bucket(int(frames[r]), cfg.mel_buckets), []).append(r)
            for ty, rows in by_ty.items():
                sel = torch.as_tensor(rows, device=self.device)
                wav, _, y_len = self._decode_vocode(
                    tuple(t[sel] for t in enc), ty, n_timesteps, temperature, stoc, seed)
                wav, y_len = wav.cpu().numpy(), y_len.cpu().numpy()
                for k, r in enumerate(rows):
                    n = int(y_len[k]) * cfg.hop_len
                    wavs[idxs[r]] = np.clip(wav[k, :n], -1.0, 1.0)
        return wavs  # type: ignore[return-value]

    def synthesize_file(self, texts: List[str], face_path: str, out_dir: str,
                        tag: str = "face", **kw) -> List[str]:
        """Sentences x one face -> wav files named {tag}_sample_{i}.wav
        (reference inference.py:162-185)."""
        from facegantts_tpu_torch.utils.audio import save_wav

        face = load_face(face_path, self.cfg.image_size)
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for i, text in enumerate(texts):
            wav, _ = self.synthesize(text, face, **kw)
            p = os.path.join(out_dir, f"{tag}_sample_{i}.wav")
            save_wav(p, wav, self.cfg.sample_rate)
            paths.append(p)
        return paths
