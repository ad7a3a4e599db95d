"""nib format: legacy one-sequence-per-file 4-bit packed DNA.

Behavioral reference: kent/src/lib/nib.c (nibOpenVerify:145, unpacking
tables at 163-230) and dnautil.c initNtVal (values T=0 C=1 A=2 G=3 N=4,
MASKED_BASE_BIT=8 -> lowercase).  Layout: int32 signature 0x6BE93D3A,
int32 base count (either byte order), then 2 bases/byte, high nibble
first.
"""

from __future__ import annotations

import struct

import numpy as np

NIB_SIG = 0x6BE93D3A
_CHARS_MASKED = b"TCAGNXXXtcagnxxx"
_CODE = {"T": 0, "C": 1, "A": 2, "G": 3, "N": 4}


def read_nib(path: str) -> bytes:
    """Whole-file nibLdPartMasked(NIB_MASK_MIXED): mixed-case chars with
    soft-masked bases lowercase."""
    with open(path, "rb") as f:
        raw = f.read()
    sig, size = struct.unpack("<ii", raw[:8])
    if sig != NIB_SIG:
        sig, size = struct.unpack(">ii", raw[:8])
        if sig != NIB_SIG:
            raise ValueError(f"{path} is not a good .nib file")
    data = np.frombuffer(raw[8:8 + (size + 1) // 2], np.uint8)
    vals = np.empty(2 * data.shape[0], np.uint8)
    vals[0::2] = data >> 4
    vals[1::2] = data & 0xF
    lut = np.frombuffer(_CHARS_MASKED, np.uint8)
    return lut[vals[:size]].tobytes()


def nib_size(path: str) -> int:
    """nibOpenVerify: just the base count from the header."""
    with open(path, "rb") as f:
        raw = f.read(8)
    sig, size = struct.unpack("<ii", raw)
    if sig != NIB_SIG:
        sig, size = struct.unpack(">ii", raw)
        if sig != NIB_SIG:
            raise ValueError(f"{path} is not a good .nib file")
    return size


def write_nib(path: str, chars: bytes) -> None:
    """nibWrite: pack mixed-case chars (lowercase = soft-masked)."""
    arr = np.frombuffer(chars, np.uint8)
    lut = np.full(256, 4, np.uint8)
    for ch, code in _CODE.items():
        lut[ord(ch)] = code
        lut[ord(ch.lower())] = code | 8
    vals = lut[arr]
    if vals.shape[0] % 2:
        vals = np.append(vals, np.uint8(0))
    packed = ((vals[0::2] << 4) | vals[1::2]).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", NIB_SIG, len(chars)))
        f.write(packed.tobytes())
