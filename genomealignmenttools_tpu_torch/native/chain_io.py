"""Native-accelerated chain file parse/serialize (ctypes wrapper).

Falls back to the pure-python codec when the library is unavailable.
Results are identical; tests enforce parity.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import get_lib
from ..formats.chain import Chain


def parse_chain_text(data: bytes) -> "list[Chain] | None":
    """Parse a whole chain-file buffer natively; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr_p = lib.gat_chain_parse(data, len(data))
    try:
        arr = arr_p.contents
        err = bytes(arr.error).split(b"\0")[0]
        if err:
            raise ValueError(err.decode())
        n = arr.n_chains
        if n == 0:
            return []
        from ..utils.bigmem import big_copy
        scores = np.ctypeslib.as_array(arr.scores, shape=(n,)).copy()
        header = np.ctypeslib.as_array(arr.header_nums, shape=(n, 7)).copy()
        strands = np.ctypeslib.as_array(arr.q_strands, shape=(n,)).copy()
        name_offsets = np.ctypeslib.as_array(arr.name_offsets,
                                             shape=(2 * n + 1,)).copy()
        blob = ctypes.string_at(arr.name_blob, int(name_offsets[-1]))
        block_offsets = np.ctypeslib.as_array(arr.block_offsets,
                                              shape=(n + 1,)).copy()
        blocks = big_copy(np.ctypeslib.as_array(arr.blocks,
                                                shape=(arr.n_blocks, 4)))
    finally:
        lib.gat_chain_free(arr_p)

    chains = []
    for i in range(n):
        t_name = blob[name_offsets[2 * i]:name_offsets[2 * i + 1]].decode()
        q_name = blob[name_offsets[2 * i + 1]:name_offsets[2 * i + 2]].decode()
        h = header[i]
        chains.append(Chain(
            score=float(scores[i]), t_name=t_name, t_size=int(h[0]),
            t_start=int(h[1]), t_end=int(h[2]), q_name=q_name,
            q_size=int(h[3]), q_strand=chr(strands[i]),
            q_start=int(h[4]), q_end=int(h[5]), id=int(h[6]),
            blocks=blocks[block_offsets[i]:block_offsets[i + 1]]))
    return chains


class ChainTable:
    """Columnar (SoA) view of a parsed chain file.

    Engine fast paths (chainCleaner, scoreChain) keep the whole file in
    these arrays and only materialize python Chain objects for the few
    records they mutate; untouched records are re-serialized straight from
    the columns by the native writer (chainWrite-exact, optionally in a
    permuted chainSort order).  This is the SoA data model from SURVEY §7
    L2' applied to host I/O: no per-chain python objects on the bulk path.
    """

    __slots__ = ("scores", "header", "strands", "name_offsets", "name_blob",
                 "block_offsets", "blocks", "_names")

    def __init__(self, scores, header, strands, name_offsets, name_blob,
                 block_offsets, blocks, names=None):
        self.scores = scores          # float64[n]
        self.header = header          # int64[n,7] tSize tStart tEnd qSize qStart qEnd id
        self.strands = strands        # uint8[n] ord('+')/ord('-')
        self.name_offsets = name_offsets  # int64[2n+1]
        self.name_blob = name_blob    # bytes
        self.block_offsets = block_offsets  # int64[n+1]
        self.blocks = blocks          # int64[B,4]
        self._names = names           # ((t_ids, names), (q_ids, names))

    def __len__(self) -> int:
        return int(self.scores.shape[0])

    @property
    def ids(self) -> np.ndarray:
        return self.header[:, 6]

    def name_pair(self, i: int) -> tuple[str, str]:
        if self._names is not None:
            (t_ids, names), (q_ids, qnames) = self._names
            return names[t_ids[i]], qnames[q_ids[i]]
        o = self.name_offsets
        return (self.name_blob[o[2 * i]:o[2 * i + 1]].decode(),
                self.name_blob[o[2 * i + 1]:o[2 * i + 2]].decode())

    def names_factorized(self):
        """((t_ids, t_names), (q_ids, q_names)): per-chain name indices into
        deduplicated name lists (chain files repeat a handful of chroms)."""
        if self._names is None:
            o = self.name_offsets
            blob = self.name_blob
            interned: dict[bytes, str] = {}

            def column(which: int):
                idx_of: dict[str, int] = {}
                names: list[str] = []
                ids = np.empty(len(self), np.int32)
                for i in range(len(self)):
                    b = blob[o[2 * i + which]:o[2 * i + 1 + which]]
                    s = interned.get(b)
                    if s is None:
                        s = interned[b] = b.decode()
                    j = idx_of.get(s)
                    if j is None:
                        j = idx_of[s] = len(names)
                        names.append(s)
                    ids[i] = j
                return ids, names

            self._names = (column(0), column(1))
        return self._names

    def materialize(self, i: int) -> Chain:
        t_name, q_name = self.name_pair(i)
        h = self.header[i]
        return Chain(
            score=float(self.scores[i]), t_name=t_name, t_size=int(h[0]),
            t_start=int(h[1]), t_end=int(h[2]), q_name=q_name,
            q_size=int(h[3]), q_strand=chr(self.strands[i]),
            q_start=int(h[4]), q_end=int(h[5]), id=int(h[6]),
            blocks=self.blocks[self.block_offsets[i]:
                               self.block_offsets[i + 1]])

    def serialize(self, order: "np.ndarray | None" = None):
        """chainWrite-exact text of (a permutation of) the table."""
        return _serialize_soa(self.scores, self.header, self.strands,
                              self.name_offsets, self.name_blob,
                              self.block_offsets, self.blocks, order)

    def row_slice(self, lo: int, hi: int) -> "ChainTable":
        """Contiguous row range [lo, hi) as a new table (views where
        possible)."""
        blo, bhi = int(self.block_offsets[lo]), int(self.block_offsets[hi])
        names = None
        if self._names is not None:
            (t_ids, nms), (q_ids, qnms) = self._names
            names = ((t_ids[lo:hi], nms), (q_ids[lo:hi], qnms))
        o = self.name_offsets
        base = int(o[2 * lo])
        return ChainTable(self.scores[lo:hi], self.header[lo:hi],
                          self.strands[lo:hi],
                          o[2 * lo:2 * hi + 1] - base,
                          self.name_blob[base:int(o[2 * hi])],
                          self.block_offsets[lo:hi + 1] - blo,
                          self.blocks[blo:bhi], names=names)


def parse_chain_table(data: bytes) -> "ChainTable | None":
    """Parse a whole chain-file buffer into a ChainTable (no python Chain
    objects); None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr_p = lib.gat_chain_parse(data, len(data))
    try:
        arr = arr_p.contents
        err = bytes(arr.error).split(b"\0")[0]
        if err:
            raise ValueError(err.decode())
        n = arr.n_chains
        from ..utils.bigmem import big_copy
        if n == 0:
            return ChainTable(np.zeros(0), np.zeros((0, 7), np.int64),
                              np.zeros(0, np.uint8), np.zeros(1, np.int64),
                              b"", np.zeros(1, np.int64),
                              np.zeros((0, 4), np.int64))
        scores = np.ctypeslib.as_array(arr.scores, shape=(n,)).copy()
        header = np.ctypeslib.as_array(arr.header_nums, shape=(n, 7)).copy()
        strands = np.ctypeslib.as_array(arr.q_strands, shape=(n,)).copy()
        name_offsets = np.ctypeslib.as_array(arr.name_offsets,
                                             shape=(2 * n + 1,)).copy()
        blob = ctypes.string_at(arr.name_blob, int(name_offsets[-1]))
        block_offsets = np.ctypeslib.as_array(arr.block_offsets,
                                              shape=(n + 1,)).copy()
        blocks = big_copy(np.ctypeslib.as_array(arr.blocks,
                                                shape=(arr.n_blocks, 4)))
        t_ids = np.ctypeslib.as_array(arr.t_name_ids, shape=(n,)).copy()
        q_ids = np.ctypeslib.as_array(arr.q_name_ids, shape=(n,)).copy()
        nu = int(arr.n_uniq_names)
        uoff = np.ctypeslib.as_array(arr.uniq_name_off, shape=(nu + 1,))
        ublob = ctypes.string_at(arr.uniq_name_blob, int(uoff[nu]))
        names = [ublob[uoff[i]:uoff[i + 1]].decode() for i in range(nu)]
    finally:
        lib.gat_chain_free(arr_p)
    return ChainTable(scores, header, strands, name_offsets, blob,
                      block_offsets, blocks,
                      names=((t_ids, names), (q_ids, names)))


def _serialize_soa(scores, header, strands, name_offsets, name_blob,
                   block_offsets, blocks, order=None):
    lib = get_lib()
    if lib is None:
        return None
    n = int(scores.shape[0])
    scores = np.ascontiguousarray(scores, np.float64)
    header = np.ascontiguousarray(header, np.int64)
    strands = np.ascontiguousarray(strands, np.uint8)
    name_offsets = np.ascontiguousarray(name_offsets, np.int64)
    block_offsets = np.ascontiguousarray(block_offsets, np.int64)
    blocks = np.ascontiguousarray(blocks, np.int64)
    if order is not None:
        # order may be any subset/permutation of rows; the native writer
        # emits len(order) records
        order = np.ascontiguousarray(order, np.int64)
        order_p = order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        n = int(order.shape[0])
    else:
        order_p = None
    out_len = ctypes.c_int64()
    p = lib.gat_chain_serialize_ord(
        n,
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        header.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        strands.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        name_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        name_blob,
        block_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        order_p,
        ctypes.byref(out_len))
    try:
        from ..utils.bigmem import big_empty
        out = big_empty(out_len.value, np.uint8)
        ctypes.memmove(out.ctypes.data, p, out_len.value)
        return memoryview(out).cast("B")
    finally:
        lib.gat_free_buffer(p)


def soa_from_chains(chains: list[Chain]):
    """Pack python Chain objects into SoA columns (the serialize_chains
    prep, reusable for appending mutated chains to a ChainTable)."""
    n = len(chains)
    scores = np.fromiter((c.score for c in chains), np.float64, n)
    header = np.fromiter(
        (v for c in chains
         for v in (c.t_size, c.t_start, c.t_end, c.q_size, c.q_start,
                   c.q_end, c.id)),
        np.int64, 7 * n).reshape(n, 7)
    strands = np.fromiter((ord(c.q_strand) for c in chains), np.uint8, n)
    enc: dict[str, bytes] = {}

    def _enc(s: str) -> bytes:
        b = enc.get(s)
        if b is None:
            b = enc[s] = s.encode()
        return b

    name_parts = [b""] * (2 * n)
    name_lens = np.zeros(2 * n, np.int64)
    for i, c in enumerate(chains):
        tn = _enc(c.t_name)
        qn = _enc(c.q_name)
        name_parts[2 * i] = tn
        name_parts[2 * i + 1] = qn
        name_lens[2 * i] = len(tn)
        name_lens[2 * i + 1] = len(qn)
    name_offsets = np.zeros(2 * n + 1, np.int64)
    np.cumsum(name_lens, out=name_offsets[1:])
    blob = b"".join(name_parts)
    block_offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter((c.n_blocks for c in chains), np.int64, n),
              out=block_offsets[1:])
    if n and block_offsets[-1]:
        from ..utils.bigmem import big_empty
        blocks = big_empty((int(block_offsets[-1]), 4), np.int64)
        for i, c in enumerate(chains):
            np.copyto(blocks[block_offsets[i]:block_offsets[i + 1]],
                      c.blocks)
    else:
        blocks = np.zeros((0, 4), np.int64)
    return ChainTable(scores, header, strands, name_offsets, blob,
                      block_offsets, blocks)


def concat_tables(tables: "list[ChainTable]") -> ChainTable:
    """Concatenate ChainTables (row-wise)."""
    scores = np.concatenate([t.scores for t in tables])
    header = np.concatenate([t.header for t in tables])
    strands = np.concatenate([t.strands for t in tables])
    blob = b"".join(t.name_blob for t in tables)
    name_parts = [tables[0].name_offsets]
    blob_base = len(tables[0].name_blob)
    for t in tables[1:]:
        name_parts.append(t.name_offsets[1:] + blob_base)
        blob_base += len(t.name_blob)
    name_offsets = np.concatenate(name_parts)
    blk_parts = [tables[0].block_offsets]
    blk_base = int(tables[0].block_offsets[-1])
    for t in tables[1:]:
        blk_parts.append(t.block_offsets[1:] + blk_base)
        blk_base += int(t.block_offsets[-1])
    block_offsets = np.concatenate(blk_parts)
    blocks = np.concatenate([t.blocks for t in tables])
    return ChainTable(scores, header, strands, name_offsets, blob,
                      block_offsets, blocks)


def serialize_chains(chains: list[Chain]) -> "bytes | None":
    """Serialize chains natively (chainWrite-exact); None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(chains)
    # single flat generator pass beats per-row ndarray assignment ~4x
    scores = np.fromiter((c.score for c in chains), np.float64, n)
    header = np.fromiter(
        (v for c in chains
         for v in (c.t_size, c.t_start, c.t_end, c.q_size, c.q_start,
                   c.q_end, c.id)),
        np.int64, 7 * n).reshape(n, 7)
    strands = np.fromiter((ord(c.q_strand) for c in chains), np.uint8, n)
    # chain files repeat a handful of chrom names; encode each once
    enc: dict[str, bytes] = {}

    def _enc(s: str) -> bytes:
        b = enc.get(s)
        if b is None:
            b = enc[s] = s.encode()
        return b

    name_parts = [b""] * (2 * n)
    name_lens = np.zeros(2 * n, np.int64)
    for i, c in enumerate(chains):
        tn = _enc(c.t_name)
        qn = _enc(c.q_name)
        name_parts[2 * i] = tn
        name_parts[2 * i + 1] = qn
        name_lens[2 * i] = len(tn)
        name_lens[2 * i + 1] = len(qn)
    name_offsets = np.zeros(2 * n + 1, np.int64)
    np.cumsum(name_lens, out=name_offsets[1:])
    blob = b"".join(name_parts)
    block_offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter((c.n_blocks for c in chains), np.int64, n),
              out=block_offsets[1:])
    from ..utils.bigmem import big_empty
    if n:
        blocks = big_empty((int(block_offsets[-1]), 4), np.int64)
        for i, c in enumerate(chains):
            np.copyto(blocks[block_offsets[i]:block_offsets[i + 1]],
                      c.blocks)
    else:
        blocks = np.zeros((0, 4), np.int64)

    out_len = ctypes.c_int64()
    p = lib.gat_chain_serialize(
        n,
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        header.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        strands.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        name_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        blob,
        block_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(out_len))
    try:
        # copy into shared-mmap pages and hand back a memoryview: a bytes
        # object would pay the slow private-anon first touch twice
        out = big_empty(out_len.value, np.uint8)
        ctypes.memmove(out.ctypes.data, p, out_len.value)
        return memoryview(out).cast("B")
    finally:
        lib.gat_free_buffer(p)
