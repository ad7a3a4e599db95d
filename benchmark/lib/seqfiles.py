"""Plain writers and readers of the files the tools read and write.

Genomes are uint8 code arrays in .2bit's own order, T=0 C=1 A=2 G=3 (so
the complement of c is c ^ 2).  Chains are dicts with the header fields of
the kent chain format and their blocks as an int64 array of rows (t_start,
t_end, q_start, q_end) in the coordinates of the chain's own strands."""

from __future__ import annotations

import struct

import numpy as np

TCAG = np.frombuffer(b"TCAG", np.uint8)    # the letter of each code
TWOBIT_SIGNATURE = 0x1A412743

HEADER_FIELDS = ("score", "t_name", "t_size", "t_strand", "t_start", "t_end",
                 "q_name", "q_size", "q_strand", "q_start", "q_end", "id")


def write_twobit(path: str, name: str, codes: np.ndarray) -> None:
    """One sequence, no N blocks and no mask blocks; four bases a byte,
    the first in the high bits."""
    n = int(codes.size)
    if n % 4:
        codes = np.concatenate([codes, np.zeros(4 - n % 4, np.uint8)])
    w = np.ascontiguousarray(codes).view("<u4")
    packed = (((w & 3) << 6) | ((w >> 4) & 0x30) | ((w >> 14) & 0xC)
              | ((w >> 24) & 3)).astype(np.uint8)
    nb = name.encode()
    offset = 16 + 1 + len(nb) + 4
    with open(path, "wb") as f:
        f.write(struct.pack("<IIII", TWOBIT_SIGNATURE, 0, 1, 0))
        f.write(struct.pack("<B", len(nb)) + nb + struct.pack("<I", offset))
        f.write(struct.pack("<IIII", n, 0, 0, 0))
        f.write(packed.tobytes())


def chain_text(chains) -> str:
    """kent chainWrite's text: the header, then 'size dt dq' lines and the
    last block's size alone, then a blank line."""
    out = []
    for c in chains:
        b = c["blocks"]
        out.append("chain %s %s %d %s %d %d %s %d %s %d %d %d\n" % (
            c["score"], c["t_name"], c["t_size"], c.get("t_strand", "+"),
            b[0, 0], b[-1, 1], c["q_name"], c["q_size"], c["q_strand"],
            b[0, 2], b[-1, 3], c["id"]))
        sizes = (b[:, 1] - b[:, 0]).tolist()
        dts = (b[1:, 0] - b[:-1, 1]).tolist()
        dqs = (b[1:, 2] - b[:-1, 3]).tolist()
        out.append("".join(map("%d\t%d\t%d\n".__mod__,
                               zip(sizes[:-1], dts, dqs))))
        out.append("%d\n\n" % sizes[-1])
    return "".join(out)


def _blocks(t0: int, q0: int, rows: list) -> np.ndarray:
    """Absolute blocks from a chain's (size, dt, dq) lines."""
    a = np.array(rows, np.int64).reshape(-1, 3)
    sizes, dt, dq = a[:, 0], a[:-1, 1], a[:-1, 2]
    ts = t0 + np.concatenate([[0], np.cumsum(sizes[:-1] + dt)])
    qs = q0 + np.concatenate([[0], np.cumsum(sizes[:-1] + dq)])
    return np.stack([ts, ts + sizes, qs, qs + sizes], 1)


def parse_chains(text: str) -> list[dict]:
    """The chains of a chain file, in file order.  Raises ValueError on a
    line that is neither a header nor a block line."""
    chains = []
    head = None
    rows: list = []

    def close():
        if head is not None:
            if not rows:
                raise ValueError(f"chain {head['id']} has no blocks")
            head["blocks"] = _blocks(head["t_start"], head["q_start"], rows)
            chains.append(head)

    for ln in text.split("\n"):
        w = ln.split()
        if not w or ln.startswith("#"):
            continue
        if w[0] == "chain":
            close()
            if len(w) != 13:
                raise ValueError(f"bad chain header: {ln!r}")
            head = dict(zip(HEADER_FIELDS, w[1:]))
            head["score"] = float(head["score"])
            for k in ("t_size", "t_start", "t_end", "q_size", "q_start",
                      "q_end", "id"):
                head[k] = int(head[k])
            rows = []
        elif head is not None and len(w) in (1, 3):
            rows.append((int(w[0]), int(w[1]) if len(w) == 3 else 0,
                         int(w[2]) if len(w) == 3 else 0))
        else:
            raise ValueError(f"bad chain line: {ln!r}")
    close()
    return chains
