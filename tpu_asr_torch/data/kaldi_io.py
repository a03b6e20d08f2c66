"""Kaldi ark matrix reader and writer (port of tpu_asr/data/kaldi_io.py).

An espnet data.json dump points at its features as "x.ark:offset"; this
reads one binary float ("BFM ") or double ("BDM ") matrix record there.
Compressed ark is not supported (prepare with --compress false), and any
other record raises ValueError. Double matrices read as float64; the
loader casts to float32.
"""

from __future__ import annotations

import struct

import numpy as np


def read_mat(rxspecifier: str) -> np.ndarray:
    """Read one matrix from 'path/to/file.ark:offset' (or a plain file
    positioned at a matrix record)."""
    if ":" in rxspecifier:
        path, offset = rxspecifier.rsplit(":", 1)
        offset = int(offset)
    else:
        path, offset = rxspecifier, 0
    with open(path, "rb") as f:
        f.seek(offset)
        return _read_mat_binary(f)


def _read_int32(f) -> int:
    size_byte = f.read(1)
    if size_byte != b"\x04":
        raise ValueError(f"bad int size byte {size_byte!r}")
    return struct.unpack("<i", f.read(4))[0]


def _read_mat_binary(f) -> np.ndarray:
    binary = f.read(2)
    if binary != b"\x00B":
        raise ValueError(f"not a binary kaldi record: {binary!r}")
    kind = f.read(3)
    if kind == b"FM ":
        dtype, itemsize = np.float32, 4
    elif kind == b"DM ":
        dtype, itemsize = np.float64, 8
    else:
        raise ValueError(f"unsupported matrix type {kind!r} "
                         "(compressed ark not supported)")
    rows = _read_int32(f)
    cols = _read_int32(f)
    buf = f.read(rows * cols * itemsize)
    return np.frombuffer(buf, dtype=dtype).reshape(rows, cols).copy()


def read_ark_scp(scp_path: str):
    """Iterate (utt_id, matrix) over a Kaldi .scp index file."""
    with open(scp_path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            yield parts[0], read_mat(parts[1])


def write_mat(f, mat: np.ndarray, key: str | None = None) -> int:
    """Write a binary float matrix record to the open file `f` (after
    "<key> " when a key is given); returns the record's offset, for
    building "path:offset" rxspecifiers."""
    if key is not None:
        f.write(key.encode() + b" ")
    offset = f.tell()
    f.write(b"\x00BFM ")
    for dim in mat.shape:
        f.write(b"\x04" + struct.pack("<i", dim))
    f.write(np.ascontiguousarray(mat, np.float32).tobytes())
    return offset
