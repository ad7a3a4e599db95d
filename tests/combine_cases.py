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


def score_tiles(rng, s, chunk: int):
    """(len(s), chunk) int8 tile rows whose int32 row sums are s, as the pair
    packer's score tiles hold them: each s split evenly over the row, then
    zero-sum moves between neighbouring bytes, twice over, and the columns
    shuffled, so that rows mix signs and reach -128 and 127.  Every s must
    lie in [-128 * chunk, 127 * chunk]: the cases' s in [-500, 16000] fit
    rows of 128 or more; narrower rows need s clipped first."""
    s = np.asarray(s, np.int64)
    if chunk < 1 or ((s < -128 * chunk) | (s > 127 * chunk)).any():
        raise ValueError(f"a sum lies outside what {chunk} int8 bytes hold")
    out = np.empty((s.shape[0], chunk), np.int8)
    lane = np.arange(chunk)
    step = 1 << 16                    # rows built at a time
    for lo in range(0, s.shape[0], step):
        q, r = np.divmod(s[lo:lo + step], chunk)
        x = (q[:, None] + (lane < r[:, None])).astype(np.int16)
        for first in (0, 1):          # pairs (0, 1), (2, 3)...; then (1, 2)...
            n_pairs = (chunk - first) // 2
            xa = x[:, first:first + 2 * n_pairs:2]
            xb = x[:, first + 1:first + 2 * n_pairs:2]
            lo_d = np.maximum(-128 - xa, xb - 127)
            span = np.minimum(127 - xa, xb + 128) + 1 - lo_d
            d = lo_d + (rng.random(xa.shape, np.float32)
                        * span).astype(np.int16)
            xa += d
            xb -= d
        out[lo:lo + step] = x[:, rng.permutation(chunk)]
    return out


def even_tiles_torch(s, chunk: int):
    """Tile rows whose sums are s, each s split evenly over its row (no
    moves), built on the device of `s` (a torch int32 tensor): for cases too
    large to build on the host."""
    import torch
    out = torch.empty((s.numel(), chunk), dtype=torch.int8, device=s.device)
    lane = torch.arange(chunk, device=s.device)
    step = 1 << 20                    # rows built at a time
    for lo in range(0, s.numel(), step):
        part = s[lo:lo + step].to(torch.int64)
        q = torch.div(part, chunk, rounding_mode="floor")
        out[lo:lo + step] = (q[:, None] + (lane < (part - q * chunk)[:, None])
                             ).to(torch.int8)
    return out


# A 5x5 matrix [q, t] with sixteen distinct values (0 among them) and the
# int8 extremes: 4-bit tiles then use every index, and both sign bits.
WIDE_LUT = np.zeros((5, 5), np.int64)
WIDE_LUT[:4, :4] = [[127, -128, 3, -1], [0, 100, -114, 55],
                    [-31, -125, 91, 7], [-7, 64, -64, 126]]


def code_tiles(rng, m: int, chunk: int):
    """(m, chunk) uint8 combined codes q * 5 + t as alignments give them:
    t equal to q on about 80% of the bases, an N on either side on 5%, a
    byte of 25 or more (which scores 0) on 1%, and a third of the rows
    ending early, padded with 24 (N/N)."""
    shape = (m, chunk)
    q = rng.integers(0, 4, shape)
    t = np.where(rng.random(shape) < 0.8, q, rng.integers(0, 4, shape))
    n = rng.random(shape)
    q = np.where(n < 0.03, 4, q)
    t = np.where((n >= 0.03) & (n < 0.05), 4, t)
    codes = (q * 5 + t).astype(np.uint8)
    junk = rng.random(shape) < 0.01
    codes[junk] = rng.integers(25, 256, int(junk.sum()))
    length = np.where(rng.random(m) < 0.33, rng.integers(0, chunk + 1, m),
                      chunk)
    codes[np.arange(chunk) >= length[:, None]] = 24
    return codes


def code_tiles_torch(m: int, chunk: int, device, seed: int):
    """code_tiles' mix built on `device` with torch's generator, a block of
    rows at a time (for cases too large to build on the host); rows are
    full, stray bytes are 200."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((m, chunk), dtype=torch.uint8, device=device)
    step = 1 << 18                    # rows built at a time
    for lo in range(0, m, step):
        shape = (min(step, m - lo), chunk)

        def rand():
            return torch.rand(shape, generator=g, device=device)

        def codes():
            return torch.randint(0, 4, shape, generator=g, device=device,
                                 dtype=torch.uint8)
        q = codes()
        t = torch.where(rand() < 0.8, q, codes())
        n = rand()
        q = torch.where(n < 0.03, 4, q)
        t = torch.where((n >= 0.03) & (n < 0.05), 4, t)
        c = q * 5 + t
        c[rand() < 0.01] = 200
        out[lo:lo + shape[0]] = c
    return out


def _by_table(table: np.ndarray, codes):
    """table[codes] for numpy codes, or torch codes on any device (a block
    of rows at a time)."""
    if isinstance(codes, np.ndarray):
        return table[codes]
    import torch
    t = torch.from_numpy(table).to(codes.device)
    out = torch.empty(codes.shape, dtype=t.dtype, device=codes.device)
    step = 1 << 18
    for lo in range(0, codes.shape[0], step):
        out[lo:lo + step] = t[codes[lo:lo + step].to(torch.int64)]
    return out


def scored_tiles(codes, lut):
    """The int8 score tiles of the same bases: lut[q, t] where q and t are
    both below 4, else 0 (numpy or torch codes)."""
    table = np.zeros(256, np.int8)
    c = np.arange(25)
    live = (c // 5 < 4) & (c % 5 < 4)
    table[c[live]] = np.asarray(lut)[c[live] // 5, c[live] % 5]
    return _by_table(table, codes)


def nibble_tiles(codes, idx_lut25):
    """The 4-bit tiles of the same bases: idx_lut25[c] for a code below 25,
    index 0 (value 0) for any other byte, base 2i in the low nibble of byte i
    (numpy or torch codes of an even width)."""
    table = np.zeros(256, np.uint8)
    table[:25] = idx_lut25
    idx = _by_table(table, codes)
    return idx[:, 0::2] | (idx[:, 1::2] << 4)
