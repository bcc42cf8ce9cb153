"""SyncNet face/voice embedder (reference model/syncnet_hifigan.py:8-145), in torch.

Port of the JAX package's ``models/syncnet.py``.  The image stream takes a
224x224 face (B, 224, 224, 3), BGR 0..255, through the ``netcnnimg`` trunk
and the ``netfcimg`` 1x1-conv head to a (B, n_out) embedding.  The audio
stream takes a mel image NCHW (B, 1, n_mels, T) -- the JAX layout is NHWC
(B, n_mels, T, 1) -- through the ``netcnnaud`` trunk and the ``netfcaud``
head: ``forward_aud`` gives the (B, T', n_out) voice-embedding track and
``forward_perceptual`` the feature maps of the speaker-binding loss.

BatchNorm always runs on its running statistics (eps 1e-5), as the JAX
package runs SyncNet inside ``compute_loss`` (``use_running_average``):
:meth:`SyncNet.train` keeps the module in eval mode, so a training model's
live dropout never switches SyncNet's BatchNorm to batch statistics.

``width_mult`` scales every trunk and head channel count (1.0 = the
reference architecture); smaller values are for tests.
"""

from torch import nn


def _conv_bn_relu(c_in, c_out, kernel, stride=(1, 1), pad=(0, 0)):
    return [nn.Conv2d(c_in, c_out, kernel, stride, pad), nn.BatchNorm2d(c_out), nn.ReLU()]


def _head(c_in, hidden, n_out):
    return nn.Sequential(
        nn.Conv1d(c_in, hidden, 1), nn.BatchNorm1d(hidden), nn.ReLU(),
        nn.Conv1d(hidden, n_out, 1),
    )


class SyncNet(nn.Module):
    """Face/voice embedder with the reference's module names (Sequential
    indices match reference netcnnimg / netfcimg / netcnnaud / netfcaud)."""

    # netcnnaud indices whose outputs are the six post-ReLU conv maps
    _AUD_MAPS = (2, 6, 10, 14, 17, 21)

    def __init__(self, n_out: int = 512, stride: int = 1, width_mult: float = 1.0):
        super().__init__()

        def w(c):
            return max(1, int(round(c * width_mult)))

        self.netcnnaud = nn.Sequential(
            *_conv_bn_relu(1, w(96), (5, 5), (1, 1), (2, 2)),
            nn.MaxPool2d((3, 1), (2, 1)),
            *_conv_bn_relu(w(96), w(256), (5, 5), (2, 1), (1, 1)),
            nn.MaxPool2d((3, 3), (2, 2)),
            *_conv_bn_relu(w(256), w(384), (5, 3), (1, 1), (2, 2)),
            nn.MaxPool2d((3, 1), (2, 1)),
            *_conv_bn_relu(w(384), w(256), (3, 3), (1, 1), (1, 1)),
            *_conv_bn_relu(w(256), w(256), (3, 3), (1, 1), (1, 1)),
            nn.MaxPool2d((3, 3), (2, 2), padding=(0, 1)),
            *_conv_bn_relu(w(256), w(512), (3, 1), (1, stride), (0, 0)),
        )
        self.netfcaud = _head(w(512), w(512), n_out)
        self.netcnnimg = nn.Sequential(
            *_conv_bn_relu(3, w(96), (7, 7), (2, 2), (0, 0)),
            nn.MaxPool2d((3, 3), (2, 2)),
            *_conv_bn_relu(w(96), w(256), (5, 5), (2, 2), (1, 1)),
            nn.MaxPool2d((3, 3), (2, 2), padding=(1, 1)),
            *_conv_bn_relu(w(256), w(256), (3, 3), (1, 1), (1, 1)),
            *_conv_bn_relu(w(256), w(256), (3, 3), (1, 1), (1, 1)),
            *_conv_bn_relu(w(256), w(256), (3, 3), (1, 1), (1, 1)),
            nn.MaxPool2d((3, 3), (2, 2)),
            *_conv_bn_relu(w(256), w(512), (6, 6), (1, 1), (0, 0)),
        )
        self.netfcimg = _head(w(512), w(512), n_out)

    def forward_vid(self, face):
        """(B, 224, 224, 3) face -> (B, n_out) embedding
        (reference netcnnimg + netfcimg, syncnet_hifigan.py:55-84)."""
        h = self.netcnnimg(face.permute(0, 3, 1, 2))  # (B, C, 1, 1)
        return self.netfcimg(h.flatten(2))[..., 0]

    def train(self, mode: bool = True):
        """Stays in eval mode: BatchNorm on running statistics, always."""
        return super().train(False)

    def _aud(self, mel, collect=None):
        h = mel
        for i, layer in enumerate(self.netcnnaud):
            h = layer(h)
            if collect is not None and i in self._AUD_MAPS:
                collect.append(h)
        return h[:, :, 0]  # collapse the freq axis -> (B, 512, T')

    def forward_aud(self, mel):
        """(B, 1, n_mels, T) mel image -> (B, T', n_out) voice-embedding
        track (reference netcnnaud + netfcaud)."""
        return self.netfcaud(self._aud(mel)).transpose(1, 2)

    def forward_perceptual(self, mel):
        """Post-ReLU audio-stream feature maps and the embedding
        (reference syncnet_hifigan.py:129-145): the 6 conv maps (B, C, H, W),
        the fc map after its ReLU (B, hidden, T') and the head output
        (B, n_out, T') -- 8 tensors."""
        feats = []
        h = self._aud(mel, feats)
        head = self.netfcaud
        h = head[2](head[1](head[0](h)))
        feats.append(h)
        feats.append(head[3](h))
        return feats
