"""ConvLSTM dual-tower chunk classifier (default architecture).

Counterpart of ``remora_tpu/models/conv_lstm_model.py`` (reference
``models/ConvLSTM_w_ref.py``): signal tower (3 convs), sequence tower (2
convs), merge conv, forward LSTM, reverse LSTM, final timestep -> linear
head. BatchNorm + swish after every conv.
"""

import functools

import torch
from torch import nn

from remora_tpu_torch.models import layers as L

NAME = "ConvLSTM_w_ref"
_variable_width_possible = False


class ConvLSTM_w_ref(nn.Module):
    def __init__(self, size=64, kmer_len=9, num_out=2, generator=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        conv = functools.partial(
            L.Conv1d, generator=generator, dtype=dtype, device=device
        )
        bn = functools.partial(L.BatchNorm, dtype=dtype, device=device)
        self.sig_conv1 = conv(1, 4, 5)
        self.sig_bn1 = bn(4)
        self.sig_conv2 = conv(4, 16, 5)
        self.sig_bn2 = bn(16)
        self.sig_conv3 = conv(16, size, 9, stride=3)
        self.sig_bn3 = bn(size)

        self.seq_conv1 = conv(kmer_len * 4, 16, 5)
        self.seq_bn1 = bn(16)
        self.seq_conv2 = conv(16, size, 13, stride=3)
        self.seq_bn2 = bn(size)

        self.merge_conv1 = conv(size * 2, size, 5)
        self.merge_bn = bn(size)
        lstm = functools.partial(
            L.LSTM, generator=generator, dtype=dtype, device=device
        )
        self.lstm1 = lstm(size, size)
        self.lstm2 = lstm(size, size)
        self.fc = L.Linear(size, num_out, generator, dtype, device)

    def forward(self, sigs, seqs, train=False, channels_last_in=False):
        """sigs: (B, 1, T); seqs: (B, 4*kmer_len, T) -> f32 logits
        (B, num_out). ``channels_last_in=True`` takes sigs (B, T, 1) and
        seqs (B, T, 4*kmer_len) instead."""
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

        # concatenate in the convs' (B, C, T) storage so the channels-last
        # view stays free for the merge conv
        z = torch.cat(
            (sigs_x.transpose(1, 2), seqs_x.transpose(1, 2)), dim=1
        ).transpose(1, 2)
        z = cbs(self.merge_conv1, self.merge_bn, z)

        z = z.transpose(0, 1).contiguous()  # (B, T, C) -> (T, B, C)
        # only the final forward timestep and the FIRST step of the
        # reverse LSTM reach the head: the reverse scan collapses to one
        # zero-state cell step (see the JAX model)
        z = L.swish(L.lstm_last(self.lstm1.params, z))
        z = L.swish(L.lstm_cell_step0(self.lstm2.params, z))
        return self.fc(z)


def init(generator=None, size=64, kmer_len=9, num_out=2,
         dtype=torch.float32, device=None):
    return ConvLSTM_w_ref(size, kmer_len, num_out, generator, dtype, device)
