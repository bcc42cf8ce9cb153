"""SSL-based MOS prediction: the UTMOS22 "strong learner" in torch, with a
checkpoint importer.

Port of the JAX package's ``evaluation/ssl_mos.py``.  The reference reports
UTMOS from the ``tarepan/SpeechMOS`` torch.hub export of the UTokyo-SaruLab
VoiceMOS'22 strong learner (reference evaluation/eval.py:209-211):

    raw 16 kHz wave
      -> wav2vec2 BASE encoder (models/wav2vec2.py)        (B, T, 768)
      -> concat [features, domain embedding, judge (listener) embedding]
                                                           (B, T, 1024)
      -> 1-layer bidirectional LSTM, hidden 512            (B, T, 1024)
      -> Linear 1024 -> 2048 -> ReLU -> Linear 2048 -> 1   (B, T, 1)
      -> mean over frames * 2 + 3                          MOS in [1, 5]

(The hub export pins the single training domain and the mean-judge
embedding, so inference needs no ids: row 0 of each embedding.)  The
weights live on an external hub; given the file,
:func:`import_utmos_strong` maps a state_dict in HuggingFace wav2vec2
naming (``feature_extractor.conv_layers...``, ``encoder.layers.N.attention``)
or fairseq naming (``self_attn``, ``fc1``/``fc2``, ``post_extract_proj``)
onto :class:`UTMOSStrong`'s own names, folding weight norm on the
positional conv, with the JAX importer's semantics and ``unmapped`` list.
:func:`reference_state_dict` writes the port's weights back in either
naming, with the positional conv in either weight-norm form.
``evaluation/utmos.py: make_mos_predictor`` detects such checkpoints and
prefers this backend over the linear head and the DSP proxy.

The BiLSTM is ``torch.nn.LSTM`` (gates ``[i, f, g, o]``, as in JAX) with
torch's two biases; the JAX package folds them into one
(``b = bias_ih + bias_hh``).
"""

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from facegantts_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder

W2V = "wav2vec2."  # the encoder's prefix in UTMOSStrong's state_dict


class UTMOSStrong(nn.Module):
    """UTMOS22 strong-learner head over a wav2vec2 encoder."""

    def __init__(self, hidden: int = 768, layers: int = 12, heads: int = 12, ffn: int = 3072,
                 conv_dims: Tuple[int, ...] = (512,) * 7, cond_dim: int = 128,
                 blstm_hidden: int = 512, proj_hidden: int = 2048, pos_kernel: int = 128,
                 pos_groups: int = 16):
        super().__init__()
        self.wav2vec2 = Wav2Vec2Encoder(hidden=hidden, layers=layers, heads=heads, ffn=ffn,
                                        conv_dims=conv_dims, pos_kernel=pos_kernel,
                                        pos_groups=pos_groups)
        # domain and judge embeddings, pinned at inference
        self.domain_emb = nn.Embedding(1, cond_dim)
        self.judge_emb = nn.Embedding(1, cond_dim)
        self.blstm = nn.LSTM(hidden + 2 * cond_dim, blstm_hidden, batch_first=True,
                             bidirectional=True)
        self.projection = nn.Sequential(nn.Linear(2 * blstm_hidden, proj_hidden), nn.ReLU(),
                                        nn.Linear(proj_hidden, 1))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, S) float waveform at 16 kHz -> (B,) MOS in [1, 5]."""
        feat = self.wav2vec2(wav)
        b, t, _ = feat.shape
        cond = torch.cat([self.domain_emb.weight[0], self.judge_emb.weight[0]])
        x = torch.cat([feat, cond.to(feat.dtype).expand(b, t, -1)], dim=-1)
        x, _ = self.blstm(x)
        scores = self.projection(x)[..., 0]
        return scores.mean(dim=-1) * 2.0 + 3.0


# ---------------------------------------------------------------------------
# checkpoint import
# ---------------------------------------------------------------------------

_PREFIXES = ("model.", "ssl_model.model.", "ssl_model.", "wav2vec2.",
             "ssl.", "feature_extractors.0.", "encoder_model.")

# a positional conv weight's weight-norm form -> its (g, v) key suffixes
_WN_KEYS = {"parametrizations": (".parametrizations.weight.original0",
                                  ".parametrizations.weight.original1"),
            "g_v": (".weight_g", ".weight_v")}

# the port's (HuggingFace) names -> fairseq's, wav2vec2 prefix removed
_FAIRSEQ = (
    (r"^feature_extractor\.conv_layers\.(\d+)\.conv\.", r"feature_extractor.conv_layers.\1.0."),
    (r"^feature_extractor\.conv_layers\.0\.layer_norm\.", "feature_extractor.conv_layers.0.2."),
    (r"^feature_projection\.layer_norm\.", "layer_norm."),
    (r"^feature_projection\.projection\.", "post_extract_proj."),
    (r"^encoder\.pos_conv_embed\.conv\.", "encoder.pos_conv.0."),
    (r"^(encoder\.layers\.\d+)\.attention\.", r"\1.self_attn."),
    (r"^(encoder\.layers\.\d+)\.layer_norm\.", r"\1.self_attn_layer_norm."),
    (r"^(encoder\.layers\.\d+)\.feed_forward\.intermediate_dense\.", r"\1.fc1."),
    (r"^(encoder\.layers\.\d+)\.feed_forward\.output_dense\.", r"\1.fc2."),
    (r"^domain_emb\.", "domain_embedding."),
    (r"^judge_emb\.", "judge_embedding."),
)


def _strip(key: str) -> str:
    changed = True
    while changed:
        changed = False
        for p in _PREFIXES:
            if key.startswith(p):
                key = key[len(p):]
                changed = True
    return key


def _t(a) -> torch.Tensor:
    return torch.as_tensor(a).detach().float()


def _fold_weight_norm(sd: Dict, base: str) -> Optional[torch.Tensor]:
    """The effective conv weight for ``base``, folding weight norm
    (``weight_g``/``weight_v``, or torch>=2 ``parametrizations.original0/1``)
    over the dims where ``g`` has size 1 (HF's and fairseq's positional conv
    use ``dim=2``: ``g`` is (1, 1, k))."""
    if base + ".weight" in sd:
        return _t(sd[base + ".weight"])
    for gs, vs in _WN_KEYS.values():
        gk, vk = base + gs, base + vs
        if gk in sd and vk in sd:
            g, v = _t(sd[gk]), _t(sd[vk])
            dims = tuple(i for i, s in enumerate(g.shape) if s == 1)
            norm = v.square().sum(dim=dims, keepdim=True).sqrt() + 1e-12
            return g * v / norm
    return None


def import_utmos_strong(sd: Dict) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Map a torch UTMOS-strong / wav2vec2 state_dict onto
    :class:`UTMOSStrong`'s ``state_dict`` names (f32).

    Returns (state_dict, info) where ``info["unmapped"]`` lists the source
    keys (prefixes stripped) that were not used, as the JAX importer lists
    them.  Accepts HF naming (``attention.q_proj`` /
    ``feed_forward.intermediate_dense``) and fairseq naming
    (``self_attn.q_proj`` / ``fc1`` / ``fc2``); the wav2vec2 subtree may carry
    any of the usual prefixes (``wav2vec2.``, ``ssl_model.model.``, ...)."""
    sd = {_strip(k): v for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}
    used = set()

    def take(key):
        used.add(key)
        return _t(sd[key])

    def pair(dst, src):  # a norm's or a linear layer's weight and bias
        if src + ".weight" in sd:
            out[dst + ".weight"] = take(src + ".weight")
            out[dst + ".bias"] = take(src + ".bias")
            return True
        return False

    # --- conv feature encoder -------------------------------------------
    i = 0
    while True:
        base = f"feature_extractor.conv_layers.{i}"
        dst = f"{W2V}{base}"
        cand = next((c for c in (base + ".conv", base + ".0") if c + ".weight" in sd), None)
        if cand is None:
            break
        out[dst + ".conv.weight"] = take(cand + ".weight")
        if i == 0:
            for gn in (base + ".layer_norm", base + ".2"):
                if pair(dst + ".layer_norm", gn):
                    break
        i += 1

    # --- feature projection ----------------------------------------------
    fp = W2V + "feature_projection"
    if not pair(fp + ".layer_norm", "feature_projection.layer_norm"):
        pair(fp + ".layer_norm", "layer_norm")  # fairseq: top-level pre-projection LN
    if not pair(fp + ".projection", "feature_projection.projection"):
        pair(fp + ".projection", "post_extract_proj")

    # --- positional conv (weight-normed, grouped) ------------------------
    for cand in ("encoder.pos_conv_embed.conv", "encoder.pos_conv.0"):
        w = _fold_weight_norm(sd, cand)
        if w is not None:
            used.update(cand + s for s in (".weight", ".bias", *_WN_KEYS["g_v"],
                                           *_WN_KEYS["parametrizations"]))
            out[W2V + "encoder.pos_conv_embed.conv.weight"] = w
            out[W2V + "encoder.pos_conv_embed.conv.bias"] = _t(sd[cand + ".bias"])
            break

    # --- transformer stack ------------------------------------------------
    pair(W2V + "encoder.layer_norm", "encoder.layer_norm")
    i = 0
    while f"encoder.layers.{i}.final_layer_norm.weight" in sd:
        base = f"encoder.layers.{i}"
        dst = W2V + base
        attn = base + (".attention" if base + ".attention.q_proj.weight" in sd
                       else ".self_attn")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            pair(f"{dst}.attention.{proj}", f"{attn}.{proj}")
        hf = base + ".feed_forward.intermediate_dense.weight" in sd
        pair(dst + ".feed_forward.intermediate_dense",
              base + (".feed_forward.intermediate_dense" if hf else ".fc1"))
        pair(dst + ".feed_forward.output_dense",
              base + (".feed_forward.output_dense" if hf else ".fc2"))
        if not pair(dst + ".layer_norm",
                  base + (".layer_norm" if hf or base + ".layer_norm.weight" in sd
                          else ".self_attn_layer_norm")):
            pair(dst + ".layer_norm", base + ".self_attn_layer_norm")
        pair(dst + ".final_layer_norm", base + ".final_layer_norm")
        i += 1

    # --- head -------------------------------------------------------------
    for name, keys in (("domain_emb", ("domain_emb.weight", "domain_embedding.weight")),
                       ("judge_emb", ("judge_emb.weight", "judge_embedding.weight"))):
        for k in keys:
            if k in sd:
                emb = take(k)
                out[name + ".weight"] = (emb if emb.dim() == 1 else emb[0]).reshape(1, -1)
                break
    if "blstm.weight_ih_l0" in sd:
        for suf in ("", "_reverse"):
            for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                out[f"blstm.{kind}_l0{suf}"] = take(f"blstm.{kind}_l0{suf}")
    for dst, cands in (("projection.0", ("projection.0", "decoder.0", "output_layers.0")),
                       ("projection.2", ("projection.3", "projection.2",
                                         "decoder.3", "output_layers.2"))):
        for c in cands:
            if pair(dst, c):
                break

    return out, {"unmapped": sorted(k for k in sd if k not in used)}


def load_utmos_checkpoint(ckpt_path: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """``torch.load`` (weights_only) a UTMOS-strong checkpoint and import it."""
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return import_utmos_strong(sd)


def looks_like_ssl_checkpoint(sd: Dict) -> bool:
    return any("feature_extractor.conv_layers" in _strip(k) for k in sd)


def model_sizes(sd: Dict[str, torch.Tensor], heads: Optional[int] = None) -> Dict:
    """:class:`UTMOSStrong`'s constructor arguments inferred from an imported
    state_dict's shapes, as the JAX ``model_from_params`` infers them.  The
    head count is not recoverable from shapes: 12 when it divides the
    hidden size (wav2vec2 base), else the largest of 8, 6, 4, 2, 1 that does."""
    hidden = sd[W2V + "feature_projection.projection.weight"].shape[0]
    layers = len({k.split(".")[3] for k in sd if k.startswith(W2V + "encoder.layers.")})
    ffn = (sd[W2V + "encoder.layers.0.feed_forward.intermediate_dense.weight"].shape[0]
           if layers else 4 * hidden)
    n_conv = len({k.split(".")[3] for k in sd
                  if k.startswith(W2V + "feature_extractor.conv_layers.")
                  and k.endswith(".conv.weight")})
    conv_dims = tuple(sd[f"{W2V}feature_extractor.conv_layers.{i}.conv.weight"].shape[0]
                      for i in range(n_conv))
    if heads is None:
        heads = 12 if hidden % 12 == 0 else max(h for h in (8, 6, 4, 2, 1) if hidden % h == 0)
    pos = sd.get(W2V + "encoder.pos_conv_embed.conv.weight")
    pos_in = pos.shape[1] if pos is not None else hidden // 16
    return dict(
        hidden=hidden, layers=layers, heads=heads, ffn=ffn, conv_dims=conv_dims,
        cond_dim=sd["domain_emb.weight"].shape[1] if "domain_emb.weight" in sd else 128,
        blstm_hidden=(sd["blstm.weight_hh_l0"].shape[1] if "blstm.weight_hh_l0" in sd
                      else 512),
        proj_hidden=(sd["projection.0.weight"].shape[0] if "projection.0.weight" in sd
                     else 2048),
        pos_kernel=pos.shape[2] if pos is not None else 128,
        pos_groups=max(1, hidden // max(1, pos_in)))


def model_from_state_dict(sd: Dict[str, torch.Tensor], heads: Optional[int] = None,
                          device=None) -> UTMOSStrong:
    """A :class:`UTMOSStrong` of :func:`model_sizes` holding ``sd`` (every
    key, strictly), in eval mode on ``device`` (the GPU unless the caller
    asks for the CPU)."""
    from facegantts_tpu_torch.synthesis import resolve_device

    dev = resolve_device(device)
    with torch.device("meta"):
        model = UTMOSStrong(**model_sizes(sd, heads))
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(dev).eval()


def reference_state_dict(sd: Dict[str, torch.Tensor], naming: str = "hf",
                         weight_norm: str = "parametrizations") -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` as a reference checkpoint names it, the
    inverse of :func:`import_utmos_strong`: ``naming="hf"`` keeps the
    HuggingFace names under ``wav2vec2.``; ``"fairseq"`` writes fairseq's
    (:data:`_FAIRSEQ`) under ``ssl_model.model.``.  The positional conv's
    weight goes out as ``weight_norm(dim=2)`` holds it:
    ``weight_norm="parametrizations"`` (``original0`` / ``original1``) or
    ``"g_v"`` (``weight_g`` / ``weight_v``)."""
    if naming not in ("hf", "fairseq") or weight_norm not in _WN_KEYS:
        raise ValueError(f"naming={naming!r}, weight_norm={weight_norm!r}")
    g_key, v_key = _WN_KEYS[weight_norm]
    out = {}
    for k, v in sd.items():
        enc = k.startswith(W2V)
        k = k[len(W2V):] if enc else k
        if naming == "fairseq":
            for pat, rep in _FAIRSEQ:
                k = re.sub(pat, rep, k)
        if enc:
            k = (W2V if naming == "hf" else "ssl_model.model.") + k
        if k.endswith(("pos_conv_embed.conv.weight", "pos_conv.0.weight")):
            base = k[:-len(".weight")]
            out[base + g_key] = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
            out[base + v_key] = v
        else:
            out[k] = v
    return out


class SSLMOSPredictor:
    """Callable (wav, sr) -> MOS with a :class:`UTMOSStrong` on its device."""

    def __init__(self, model: UTMOSStrong):
        self.model = model.eval()
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def __call__(self, wav: np.ndarray, sr: int) -> float:
        wav = np.asarray(wav, np.float32)
        if sr != 16000:  # linear resample; the SSL stack expects 16 kHz
            n = int(round(len(wav) * 16000 / sr))
            wav = np.interp(
                np.linspace(0.0, len(wav) - 1.0, n),
                np.arange(len(wav)), wav,
            ).astype(np.float32)
        x = torch.from_numpy(wav)[None].to(self.device)
        return float(self.model(x)[0])
