"""Encoded k-mer featurizer (host reference implementation).

Reference analog: ``src/remora/encoded_kmers.pyx`` (nogil C loop). Output
is (nchunks, 4*kmer_len, sig_len) float32 where channel 4*k+b is 1.0 at
signal positions covered by a base whose k-mer slot k holds base b.

Vectorized formulation (also used by the device kernel in
remora_tpu_torch.kernels.encoded_kmers): a scatter+cumsum builds the
seq-position-of-signal index map, then one gather + one-hot scatter per
k-mer slot. O(output size) work, no per-base loops.
"""

import numpy as np


def compute_seq_pos_of_sig(seq_mappings, seq_lens, sig_len):
    """(B, sig_len) int array: sequence position covering each signal pos."""
    B, Sp1 = seq_mappings.shape
    bumps = np.zeros((B, sig_len + 1), dtype=np.int32)
    rows = np.repeat(np.arange(B), Sp1 - 1)
    s_idx = np.tile(np.arange(1, Sp1), B)
    valid = s_idx < np.repeat(seq_lens, Sp1 - 1)
    cols = seq_mappings[rows[valid], s_idx[valid]]
    np.add.at(bumps, (rows[valid], np.clip(cols, 0, sig_len)), 1)
    return np.cumsum(bumps[:, :sig_len], axis=1, dtype=np.int32)


def compute_encoded_kmer_batch(
    before_context_bases, after_context_bases, seqs, seq_mappings, seq_lens
):
    """One-hot k-mer features per signal position for a batch of chunks."""
    seqs = np.ascontiguousarray(seqs)
    seq_mappings = np.ascontiguousarray(seq_mappings)
    seq_lens = np.ascontiguousarray(seq_lens)
    nchunks = seq_lens.shape[0]
    kmer_len = before_context_bases + after_context_bases + 1
    sig_len = int(seq_mappings[0, seq_lens[0]])
    out = np.zeros((nchunks, 4 * kmer_len, sig_len), dtype=np.float32)
    if nchunks == 0 or sig_len == 0:
        return out

    seq_pos = compute_seq_pos_of_sig(seq_mappings, seq_lens, sig_len)
    rows = np.arange(nchunks)[:, None]
    cols = np.arange(sig_len)[None, :]
    # positions past this chunk's mapped signal keep base from final seq pos;
    # mask them (mapping always ends at chunk width so normally none)
    for k in range(kmer_len):
        base = seqs[rows, seq_pos + k]
        valid = base >= 0
        out[
            np.broadcast_to(rows, base.shape)[valid],
            4 * k + base[valid],
            np.broadcast_to(cols, base.shape)[valid],
        ] = 1.0
    return out
