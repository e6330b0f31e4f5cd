"""Encoded k-mer featurizer on the device (PyTorch).

Counterpart of ``remora_tpu/kernels/encoded_kmers.py``: builds the
one-hot k-mer features from the compact ragged arrays (int8 seqs, int16
maps) on the device, bit-equal to the host featurizer
(``data/encoded_kmers.py``).

The JAX package phrases this as a batched 0/1 matmul because TPU gathers
serialize; a GPU gathers well, so this is the direct formulation: a
scatter-add + cumsum gives the base covering each signal position, one
gather reads the k-mer's bases, and a compare with 0..3 one-hots them
(padding ``-1`` bases give all-zero rows, as ``jax.nn.one_hot`` does).
"""

import torch


def seq_pos_of_sig(seq_mappings, seq_lens, sig_len):
    """(B, sig_len) int64: index of the base covering each signal pos.

    Maps are monotonic by chunk invariant; bases at or past ``seq_lens``
    cover nothing, and base 0 covers from position 0.
    """
    B, Sp1 = seq_mappings.shape
    s_idx = torch.arange(1, Sp1, device=seq_mappings.device)[None, :]
    valid = s_idx < seq_lens[:, None].long()
    cols = torch.where(
        valid, seq_mappings[:, 1:].long().clamp(0, sig_len), sig_len
    )
    bumps = torch.zeros((B, sig_len + 1), dtype=torch.int64,
                        device=seq_mappings.device)
    bumps.scatter_add_(1, cols, torch.ones_like(cols))
    return torch.cumsum(bumps[:, :sig_len], dim=1)


def compute_encoded_kmer_batch(before_bases, after_bases, seqs, seq_mappings,
                               seq_lens, sig_len, out_dtype=None,
                               channels_last=False):
    """One-hot k-mer features; equivalent to the host featurizer.

    Args:
        seqs: (B, S + stored_context) int8, ``-1`` for padding
        seq_mappings: (B, S+1) int (chunk-relative)
        seq_lens: (B,) int
        sig_len: chunk width
        out_dtype: output dtype (default float32); every value is exactly
            0.0 or 1.0, so bfloat16 is lossless
        channels_last: emit (B, sig_len, 4*kmer_len) instead

    Returns (B, 4*kmer_len, sig_len) in ``out_dtype`` (or the
    channels-last orientation); channel 4*k + c is 1 where the base in
    k-mer slot k is c.
    """
    kmer_len = before_bases + after_bases + 1
    B = seqs.shape[0]
    S = seq_mappings.shape[1] - 1
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    dev = seqs.device
    # slots past the stored sequence read padding
    pad = max(0, S + kmer_len - 1 - seqs.shape[1])
    if pad:
        seqs = torch.cat(
            [seqs, seqs.new_full((B, pad), -1)], dim=1
        )
    pos = seq_pos_of_sig(seq_mappings, seq_lens, sig_len)  # (B, W)
    slots = torch.arange(kmer_len, device=dev)
    codes = torch.arange(4, dtype=seqs.dtype, device=dev)
    if channels_last:
        idx = pos[:, :, None] + slots  # (B, W, K)
        bases = seqs.gather(1, idx.reshape(B, -1)).reshape(idx.shape)
        onehot = bases[..., None] == codes  # (B, W, K, 4)
        shape = (B, sig_len, 4 * kmer_len)
    else:
        idx = pos[:, None, :] + slots[:, None]  # (B, K, W)
        bases = seqs.gather(1, idx.reshape(B, -1)).reshape(idx.shape)
        onehot = bases[:, :, None, :] == codes[:, None]  # (B, K, 4, W)
        shape = (B, 4 * kmer_len, sig_len)
    return onehot.to(out_dtype).reshape(shape)
