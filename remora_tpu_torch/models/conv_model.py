"""Conv-only dual-tower chunk classifier.

Counterpart of ``remora_tpu/models/conv_model.py`` (reference
``models/Conv_w_ref.py``): signal + sequence towers, four merge convs
(two strided), flatten -> linear head sized for a (50, 50) chunk context
(final temporal width 3).
"""

import functools

import torch
from torch import nn

from remora_tpu_torch.models import layers as L

NAME = "Conv_w_ref"
_variable_width_possible = False


class Conv_w_ref(nn.Module):
    def __init__(self, size=64, kmer_len=9, num_out=2, generator=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        conv = functools.partial(
            L.Conv1d, generator=generator, dtype=dtype, device=device
        )
        bn = functools.partial(L.BatchNorm, dtype=dtype, device=device)
        self.sig_conv1 = conv(1, 4, 11)
        self.sig_bn1 = bn(4)
        self.sig_conv2 = conv(4, 16, 11)
        self.sig_bn2 = bn(16)
        self.sig_conv3 = conv(16, size, 9, stride=3)
        self.sig_bn3 = bn(size)

        self.seq_conv1 = conv(kmer_len * 4, 16, 11)
        self.seq_bn1 = bn(16)
        self.seq_conv2 = conv(16, 32, 11)
        self.seq_bn2 = bn(32)
        self.seq_conv3 = conv(32, size, 9, stride=3)
        self.seq_bn3 = bn(size)

        self.merge_conv1 = conv(size * 2, size, 5)
        self.merge_bn1 = bn(size)
        self.merge_conv2 = conv(size, size, 5)
        self.merge_bn2 = bn(size)
        self.merge_conv3 = conv(size, size, 3, stride=2)
        self.merge_bn3 = bn(size)
        self.merge_conv4 = conv(size, size, 3, stride=2)
        self.merge_bn4 = bn(size)

        self.fc = L.Linear(size * 3, num_out, generator, dtype, device)

    def forward(self, sigs, seqs, train=False, channels_last_in=False):
        """sigs: (B, 1, T); seqs: (B, 4*kmer_len, T) -> f32 logits
        (B, num_out); ``channels_last_in`` as in the ConvLSTM model."""
        if train:
            raise NotImplementedError(
                "the train-mode forward is not ported yet"
            )
        if not channels_last_in:
            sigs = sigs.transpose(1, 2)
            seqs = seqs.transpose(1, 2)

        def cbs(conv, bn, x):
            return L.swish(bn(conv(x)))

        sigs_x = cbs(self.sig_conv1, self.sig_bn1, sigs)
        sigs_x = cbs(self.sig_conv2, self.sig_bn2, sigs_x)
        sigs_x = cbs(self.sig_conv3, self.sig_bn3, sigs_x)

        seqs_x = cbs(self.seq_conv1, self.seq_bn1, seqs)
        seqs_x = cbs(self.seq_conv2, self.seq_bn2, seqs_x)
        seqs_x = cbs(self.seq_conv3, self.seq_bn3, seqs_x)

        z = torch.cat(
            (sigs_x.transpose(1, 2), seqs_x.transpose(1, 2)), dim=1
        ).transpose(1, 2)
        z = cbs(self.merge_conv1, self.merge_bn1, z)
        z = cbs(self.merge_conv2, self.merge_bn2, z)
        z = cbs(self.merge_conv3, self.merge_bn3, z)
        z = cbs(self.merge_conv4, self.merge_bn4, z)

        # flatten channel-major (torch NCH semantics) so the fc weight
        # layout matches the checkpoint
        z = z.transpose(1, 2).reshape(z.shape[0], -1)
        return self.fc(z)


def init(generator=None, size=64, kmer_len=9, num_out=2,
         dtype=torch.float32, device=None):
    return Conv_w_ref(size, kmer_len, num_out, generator, dtype, device)
