"""Adversarial inputs for the pair-mode segmented combine (numpy only).

The chunk-level arrays of PairChainScorer._meta for random chain structures,
as tests/test_pallas_combine.py generates them (chains of 1..40 blocks,
blocks of 1..12 chunks, chunk sums in [-500, 16000], gap biases in
[0, 40000) at the first chunk of every block but a chain's first), built
with array operations so that hundreds of thousands of chains take
seconds.  Imports no jax: the CPU tests, the GPU tests and chip_smoke.py
share it.
"""

import numpy as np

F_START, F_FIRST, F_SAMPLE = 1, 2, 4


def random_chains(rng, n_chains: int):
    """(blocks per chain, chunks per block) for n_chains random chains."""
    nb = rng.integers(1, 41, n_chains)
    return nb, rng.integers(1, 13, int(nb.sum()))


def edge_chains(tile: int):
    """(blocks per chain, chunks per block) with the carry's hard cases at
    tile size `tile`: three single-chunk chains; one chain of 7-chunk blocks
    spanning more than three tiles; a chain that ends on a tile's last
    chunk; then two short chains."""
    long_blocks = 3 * tile // 7 + 2
    used = 3 + 7 * long_blocks
    to_tile_end = (-used - 1) % tile + 1   # >= 1 chunk, ends a tile
    nb = np.array([1, 1, 1, long_blocks, 1, 2, 3])
    nc = np.array([1, 1, 1] + [7] * long_blocks + [to_tile_end, 5, 1, 2, 1, 12])
    return nb, nc


def combine_case(rng, nb, nc, pad_to: int = 1):
    """(s, bias, flags, start_idx, end_idx, m) for chains of nb[k] blocks of
    nc[j] chunks: int32 chunk arrays padded with inert chunks (0, 0, 0) to a
    multiple of pad_to, int64 first and last chunk of every chain, m real
    chunks."""
    nb = np.asarray(nb, np.int64)
    nc = np.asarray(nc, np.int64)
    m = int(nc.sum())
    block_first = np.cumsum(nc) - nc
    chain_first_block = np.cumsum(nb) - nb
    start_idx = block_first[chain_first_block]
    end_idx = np.r_[start_idx[1:] - 1, m - 1]
    m_pad = -(-m // pad_to) * pad_to
    flags = np.zeros(m_pad, np.int32)
    flags[block_first] |= F_FIRST
    flags[block_first + nc - 1] |= F_SAMPLE
    flags[start_idx] |= F_START
    s = np.zeros(m_pad, np.int32)
    s[:m] = rng.integers(-500, 16001, m)
    bias = np.zeros(m_pad, np.int32)
    gap_blocks = np.ones(nc.shape[0], bool)
    gap_blocks[chain_first_block] = False
    bias[block_first[gap_blocks]] = rng.integers(0, 40000,
                                                 int(gap_blocks.sum()))
    return s, bias, flags, start_idx, end_idx, m
