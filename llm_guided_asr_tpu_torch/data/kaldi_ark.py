"""Pure-Python Kaldi ark/scp matrix IO (the port's own copy of
llm_guided_asr_tpu/data/kaldi_ark.py).

Rebuild of the ``kaldi_ark`` data type of the reference
(espnet2/train/dataset.py:247 -> kaldiio.load_mat): reads Kaldi binary
archives addressed by ``feats.scp`` lines of the form
``uttid /path/file.ark:123``.  Payloads (what ESPnet-prepared directories
hold):

- uncompressed float/double matrices (``FM``/``DM``) and vectors
  (``FV``/``DV``);
- compressed matrices ``CM`` (per-column quantile uint8), ``CM2`` (uint16,
  one global range) and ``CM3`` (uint8, one global range);
- text-mode matrices and vectors (``[ ... ]``);
- RIFF wave data embedded in an ark (Kaldi wav.scp style).

Writers: float32 matrices and vectors (``KaldiArkWriter``, with an
optional scp) and compressed matrices (``write_compressed_matrix``), in
the public Kaldi serialization (kaldi-matrix's compressed layout).
"""

from __future__ import annotations

import io
import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np


def _read_token(f) -> str:
    """Read a space-terminated binary-mode Kaldi token."""
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok += c
    return tok.decode()


def _expect_basic_type(f, size: int) -> int:
    """Kaldi basic types are written as <size-byte><payload>."""
    (n,) = struct.unpack("<b", f.read(1))
    if n != size:
        raise ValueError(f"expected {size}-byte int marker, got {n}")
    return int(np.frombuffer(f.read(size), dtype=f"<i{size}")[0])


def _read_compressed(f, fmt: str) -> np.ndarray:
    # GlobalHeader: min_value, range (float32), num_rows, num_cols (int32)
    min_value, rng = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    if fmt == "CM2":  # uint16, global range
        data = np.frombuffer(f.read(rows * cols * 2), dtype="<u2").reshape(rows, cols)
        return (min_value + rng * data.astype(np.float32) / 65535.0).astype(np.float32)
    if fmt == "CM3":  # uint8, global range
        data = np.frombuffer(f.read(rows * cols), dtype=np.uint8).reshape(rows, cols)
        return (min_value + rng * data.astype(np.float32) / 255.0).astype(np.float32)
    # "CM ": per-column quantile headers (4 uint16) + column-major uint8 data
    headers = np.frombuffer(f.read(cols * 8), dtype="<u2").reshape(cols, 4)
    q = (min_value + rng * headers.astype(np.float32) / 65535.0)  # [cols, 4]
    data = np.frombuffer(f.read(cols * rows), dtype=np.uint8).reshape(cols, rows)
    c = data.astype(np.float32)
    p0, p25, p75, p100 = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    lo = p0 + (p25 - p0) * (c / 64.0)
    mid = p25 + (p75 - p25) * ((c - 64.0) / 128.0)
    hi = p75 + (p100 - p75) * ((c - 192.0) / 63.0)
    out = np.where(c <= 64, lo, np.where(c <= 192, mid, hi))
    return out.T.astype(np.float32)  # column-major -> [rows, cols]


def _read_text_payload(f) -> np.ndarray:
    """Text-mode Kaldi matrix/vector: '[ 1 2\n 3 4 ]'."""
    body = f.read().decode("utf-8", errors="replace")
    end = body.find("]")
    if end < 0:
        raise ValueError("unterminated text-mode kaldi matrix")
    body = body[: end]
    start = body.find("[")
    body = body[start + 1:] if start >= 0 else body
    rows = [r.split() for r in body.strip().split("\n") if r.strip()]
    if not rows:
        return np.zeros((0,), dtype=np.float32)
    arr = np.array([[float(x) for x in r] for r in rows], dtype=np.float32)
    return arr[0] if arr.shape[0] == 1 and start < 0 else arr


def read_kaldi_object(f) -> np.ndarray:
    """Read one Kaldi object (matrix/vector/wave) from a binary stream."""
    start = f.tell()
    magic = f.read(4)
    f.seek(start)
    head = f.read(2)
    if magic == b"RIFF":
        # raw wave embedded in the ark (the JAX reader compares two bytes
        # with b"RIFF" here, so it never takes this branch)
        rest = f.read()
        from scipy.io import wavfile

        rate, data = wavfile.read(io.BytesIO(head + rest))
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        return data.astype(np.float32)
    if head != b"\x00B":
        # text mode: includes what we just consumed
        rest = f.read()
        return _read_text_payload(io.BytesIO(head + rest))
    tok = _read_token(f)
    if tok in ("CM", "CM2", "CM3"):
        return _read_compressed(f, tok if tok != "CM" else "CM ")
    if tok in ("FM", "DM"):
        dt = "<f4" if tok == "FM" else "<f8"
        rows = _expect_basic_type(f, 4)
        cols = _expect_basic_type(f, 4)
        data = np.frombuffer(f.read(rows * cols * int(dt[-1])), dtype=dt)
        return data.reshape(rows, cols).astype(np.float32 if tok == "FM" else np.float64)
    if tok in ("FV", "DV"):
        dt = "<f4" if tok == "FV" else "<f8"
        dim = _expect_basic_type(f, 4)
        data = np.frombuffer(f.read(dim * int(dt[-1])), dtype=dt)
        return data.astype(np.float32 if tok == "FV" else np.float64)
    raise ValueError(f"unsupported kaldi object token {tok!r}")


def parse_rxfilename(rx: str) -> Tuple[str, int]:
    """'path/file.ark:123' -> (path, offset); plain path -> (path, 0)."""
    if ":" in rx:
        path, _, off = rx.rpartition(":")
        if off.isdigit():
            return path, int(off)
    return rx, 0


def load_mat(rx: str) -> np.ndarray:
    """kaldiio.load_mat analog: read the object addressed by an rxfilename."""
    path, offset = parse_rxfilename(rx)
    with open(path, "rb") as f:
        f.seek(offset)
        return read_kaldi_object(f)


class KaldiScpReader:
    """Lazy uttid -> ndarray over a Kaldi scp file (feats.scp etc.)."""

    def __init__(self, path: Union[Path, str]):
        from llm_guided_asr_tpu_torch.data.fileio import read_2columns_text

        self.data = read_2columns_text(path)

    def __getitem__(self, key: str) -> np.ndarray:
        return load_mat(self.data[key])

    def peek_length(self, key: str):
        """Row count from the binary header only (no matrix read)."""
        path, offset = parse_rxfilename(self.data[key])
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                if f.read(2) != b"\x00B":
                    return None  # text / wave entries need a full read
                tok = _read_token(f)
                if tok in ("CM", "CM2", "CM3"):
                    f.read(8)  # min, range
                    rows = int(np.frombuffer(f.read(4), "<i4")[0])
                    return rows
                if tok in ("FM", "DM", "FV", "DV"):
                    return _expect_basic_type(f, 4)
        except Exception:
            return None
        return None

    def keys(self):
        return self.data.keys()

    def __len__(self):
        return len(self.data)

    def __contains__(self, k):
        return k in self.data

    def __iter__(self):
        return iter(self.data)


def _write_binary_matrix(f, arr: np.ndarray):
    f.write(b"\x00B")
    if arr.ndim == 1:
        f.write(b"FV ")
        f.write(struct.pack("<bi", 4, arr.shape[0]))
        f.write(arr.astype("<f4").tobytes())
    else:
        f.write(b"FM ")
        f.write(struct.pack("<bi", 4, arr.shape[0]))
        f.write(struct.pack("<bi", 4, arr.shape[1]))
        f.write(arr.astype("<f4").tobytes())


class KaldiArkWriter:
    """Write float32 matrices/vectors to ark (+ optional scp), Kaldi-compatible."""

    def __init__(self, ark_path: Union[Path, str], scp_path: Union[Path, str, None] = None):
        self.ark_path = str(ark_path)
        self.f = open(ark_path, "wb")
        self.scp = open(scp_path, "w", encoding="utf-8") if scp_path else None

    def __setitem__(self, key: str, arr: np.ndarray):
        self.f.write(key.encode() + b" ")
        offset = self.f.tell()
        _write_binary_matrix(self.f, np.asarray(arr))
        if self.scp is not None:
            self.scp.write(f"{key} {self.ark_path}:{offset}\n")

    def close(self):
        self.f.close()
        if self.scp is not None:
            self.scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_compressed_matrix(f, arr: np.ndarray, key: str, fmt: str = "CM "):
    """Kaldi CompressedMatrix writer (for testing the reader against spec)."""
    arr = np.asarray(arr, dtype=np.float32)
    f.write(key.encode() + b" ")
    offset = f.tell()
    # tokens are space-terminated: b"CM ", b"CM2 ", b"CM3 "
    f.write(b"\x00B" + fmt.strip().encode() + b" ")
    mn, mx = float(arr.min()), float(arr.max())
    rng = max(mx - mn, 1e-10)
    rows, cols = arr.shape
    f.write(struct.pack("<ffii", mn, rng, rows, cols))
    if fmt == "CM2":
        q = np.clip((arr - mn) / rng * 65535.0, 0, 65535).astype("<u2")
        f.write(q.tobytes())
    elif fmt == "CM3":
        q = np.clip((arr - mn) / rng * 255.0, 0, 255).astype(np.uint8)
        f.write(q.tobytes())
    else:
        to_u16 = lambda v: np.clip((v - mn) / rng * 65535.0, 0, 65535).astype("<u2")
        cols_data = []
        headers = np.zeros((cols, 4), dtype="<u2")
        for c in range(cols):
            col = np.sort(arr[:, c])
            p0, p25, p75, p100 = col[0], col[rows // 4], col[(3 * rows) // 4], col[-1]
            if p25 <= p0:
                p25 = p0 + 1e-6
            if p75 <= p25:
                p75 = p25 + 1e-6
            if p100 <= p75:
                p100 = p75 + 1e-6
            headers[c] = to_u16(np.array([p0, p25, p75, p100]))
            # re-derive the dequantized quantiles like the reader will
            hq = mn + rng * headers[c].astype(np.float64) / 65535.0
            v = arr[:, c].astype(np.float64)
            lo = np.clip((v - hq[0]) / max(hq[1] - hq[0], 1e-10) * 64.0, 0, 64)
            mid = 64.0 + np.clip((v - hq[1]) / max(hq[2] - hq[1], 1e-10) * 128.0, 0, 128)
            hi = 192.0 + np.clip((v - hq[2]) / max(hq[3] - hq[2], 1e-10) * 63.0, 0, 63)
            q = np.where(v < hq[1], lo, np.where(v < hq[2], mid, hi))
            cols_data.append(np.round(q).astype(np.uint8))
        f.write(headers.tobytes())
        f.write(np.stack(cols_data, 0).tobytes())
    return offset
