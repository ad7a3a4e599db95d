"""Seeded chunk descriptors for the port's K1 tests and chip_smoke.py.

`alignment_case` is the set K1's 16-byte loads are held on: every pair of
(t_off mod 16, q_off mod 16) at the lengths 0, 1, 15, 16, 17, 255 and 256,
over genomes with N runs, then for every length and alignment a chunk that
ends at the last byte of both genomes, and chunks that begin at their first
byte.  `tail_case` is the set that reaches past a genome's storage: genomes
of every length 1..48, each its own array, with a chunk of every length
ending at the last byte of both.  `direct_sums` is the definition, in numpy,
one chunk at a time.
"""

import numpy as np

LENGTHS = (0, 1, 15, 16, 17, 255, 256)


def alignment_case(seed=20261019, t_len=70_001, q_len=50_003):
    """(t, q, t_off, q_off, length): uint8 codes 0..4 and int64, int64, int32
    descriptors.  The genome lengths are odd, so the chunks that end at the
    last byte end off every alignment."""
    rng = np.random.default_rng(seed)
    genomes = []
    for size in (t_len, q_len):
        codes = rng.integers(0, 4, size).astype(np.uint8)
        for s in rng.integers(0, size, 30):
            codes[s:s + int(rng.integers(1, 300))] = 4
        genomes.append(codes)
    t, q = genomes
    t_off, q_off, length = [], [], []
    for n in LENGTHS:
        for ta in range(16):
            for qa in range(16):
                # anywhere in the genome, at this alignment
                t_off.append(16 * int(rng.integers(1, (t_len - 300) // 16))
                             + ta)
                q_off.append(16 * int(rng.integers(1, (q_len - 300) // 16))
                             + qa)
                length.append(n)
        for shift in range(16):      # ends at the last byte of both genomes
            for arr, size in ((t_off, t_len), (q_off, q_len)):
                arr.append(size - n)
            length.append(n)
            # ... and of one genome, at every alignment of the other
            t_off.append(t_len - n)
            q_off.append(1000 + shift)
            length.append(n)
            t_off.append(1000 + shift)
            q_off.append(q_len - n)
            length.append(n)
        t_off += [0, 0, 5]           # begins at the first byte
        q_off += [0, 7, 0]
        length += [n, n, n]
    return (t, q, np.array(t_off, np.int64), np.array(q_off, np.int64),
            np.array(length, np.int32))


# genome lengths of tail_case: every remainder mod 16, three times over
TAIL_LENGTHS = tuple(range(1, 49))


def tail_case(n: int, seed: int = 20261022):
    """(t, q, t_off, q_off, length) for a t of n bases and a q of n + 5 (so
    their ends lie at other alignments): one chunk of every length 0..n
    that ends at the last byte of both, then the whole of t against q's
    head.  On the card each genome is an allocation of its own size, so a
    16-byte load past the last aligned word of either leaves it."""
    rng = np.random.default_rng(seed + n)
    t = rng.integers(0, 5, n).astype(np.uint8)
    q = rng.integers(0, 5, n + 5).astype(np.uint8)
    length = np.arange(0, n + 1, dtype=np.int32)
    t_off = (n - length).astype(np.int64)
    q_off = (n + 5 - length).astype(np.int64)
    return (t, q, np.r_[t_off, 0], np.r_[q_off, 0],
            np.r_[length, n].astype(np.int32))


def direct_sums(t, q, lut, t_off, q_off, length):
    """int64 sums of lut[q][t] per chunk, codes >= 4 scoring 0."""
    lut = np.asarray(lut, np.int64)
    table = np.zeros((5, 5), np.int64)
    table[:4, :4] = lut[:4, :4]
    out = np.zeros(len(length), np.int64)
    for i, (a, b, n) in enumerate(zip(t_off, q_off, length)):
        tc = np.minimum(t[a:a + n], 4)
        qc = np.minimum(q[b:b + n], 4)
        out[i] = table[qc, tc].sum()
    return out
