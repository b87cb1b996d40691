"""MNIST IDX binary format reader/writer (a numpy-only copy of the
reference's `data/idx.py`, bit for bit the same arrays).

Format (as parsed by the reference C loader, cnn.c:352-383):

    byte 0-1   u16 magic, must be 0
    byte 2     u8  element type code (0x08 = unsigned byte is all MNIST uses)
    byte 3     u8  ndims
    then       ndims big-endian u32 dimension sizes
    then       prod(dims) payload bytes (for type 0x08)

The reference validates magic==0, type==0x08, ndims>=1 (cnn.c:361-363) and
reads dims with be32toh (cnn.c:374). Three of its four variants malloc the
payload but never fread it (SURVEY.md 2.8) — a bug we obviously do not
reproduce. Unlike the reference we support the full IDX type-code table so
golden-file tensors can round-trip through the same container.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

# IDX type code -> numpy dtype. MNIST itself only uses 0x08.
_IDX_DTYPES = {
    0x08: np.dtype(">u1"),
    0x09: np.dtype(">i1"),
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}
_DTYPE_CODES = {v.newbyteorder("="): k for k, v in _IDX_DTYPES.items()}


class IdxError(ValueError):
    """Malformed IDX container (bad magic/type/dims or truncated payload)."""


def read_idx(path: str | Path) -> np.ndarray:
    """Read an IDX file (optionally .gz) into a little-endian numpy array.

    Validation mirrors the reference parser (cnn.c:361-363): zero magic,
    known type code, at least one dimension. Truncated payloads raise
    IdxError instead of returning uninitialized memory (reference bug,
    SURVEY.md 2.8).
    """
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        header = f.read(4)
        if len(header) != 4:
            raise IdxError(f"{path}: truncated IDX header")
        magic, type_code, ndims = struct.unpack(">HBB", header)
        if magic != 0:
            raise IdxError(f"{path}: bad IDX magic {magic:#x} (expected 0)")
        if type_code not in _IDX_DTYPES:
            raise IdxError(f"{path}: unknown IDX type code {type_code:#x}")
        if ndims < 1:
            raise IdxError(f"{path}: IDX ndims must be >= 1, got {ndims}")
        dim_bytes = f.read(4 * ndims)
        if len(dim_bytes) != 4 * ndims:
            raise IdxError(f"{path}: truncated IDX dimension table")
        dims = struct.unpack(f">{ndims}I", dim_bytes)
        dtype = _IDX_DTYPES[type_code]
        count = int(np.prod(dims, dtype=np.int64))
        payload = f.read(count * dtype.itemsize)
        if len(payload) != count * dtype.itemsize:
            raise IdxError(
                f"{path}: truncated IDX payload "
                f"({len(payload)} of {count * dtype.itemsize} bytes)"
            )
    arr = np.frombuffer(payload, dtype=dtype).reshape(dims)
    return arr.astype(dtype.newbyteorder("="))


def write_idx(path: str | Path, arr: np.ndarray) -> None:
    """Write a numpy array as an IDX file (gzipped iff path ends in .gz)."""
    arr = np.asarray(arr)
    dtype = arr.dtype.newbyteorder("=")
    if dtype not in _DTYPE_CODES:
        raise IdxError(f"dtype {arr.dtype} has no IDX type code")
    code = _DTYPE_CODES[dtype]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = struct.pack(">HBB", 0, code, arr.ndim)
    dims = struct.pack(f">{arr.ndim}I", *arr.shape)
    payload = arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wb") as f:
        f.write(header)
        f.write(dims)
        f.write(payload)
