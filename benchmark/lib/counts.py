"""The work of a kernel counted from its inputs, whatever implements it.

K1 (the window path's per-base score sums) reads one code byte per aligned
base on each side, a descriptor per block (target start, query start and
length, 4 bytes each) and writes one sum per chain (8 bytes)."""

K1_BLOCK_DESCRIPTOR_BYTES = 12
K1_CHAIN_RESULT_BYTES = 8


def k1_bytes(units: dict) -> int:
    """Bytes K1 must move to score every aligned base of a chain file
    once (units: aligned_bases, blocks, chains of the file)."""
    return (2 * units["aligned_bases"]
            + K1_BLOCK_DESCRIPTOR_BYTES * units["blocks"]
            + K1_CHAIN_RESULT_BYTES * units["chains"])
