"""Kaldi-style file IO: scp files, wav reading, shape files, datadir writer
(the port's own copy of llm_guided_asr_tpu/data/fileio.py).

Rebuild of espnet2/fileio/ (read_text.py, sound_scp.py, npy_scp.py,
datadir_writer.py).  Audio loading covers wav/pcm (scipy.io.wavfile), flac
(the self-contained decoder of data/flac.py), pipe-style wav.scp commands
('cmd ... |' entries, run via subprocess like kaldiio, whose output may be
RIFF or flac) and Kaldi ark-embedded wave data ('file.ark:offset', a RIFF
or flac stream at the offset): the reference's sound_scp.py + kaldiio
surface.
"""

from __future__ import annotations

import io
import struct
import subprocess
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

def read_2columns_text(path: Union[Path, str]) -> Dict[str, str]:
    """'uttid value...' lines -> {uttid: value} (fileio/read_text.py)."""
    data = {}
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            sps = line.split(maxsplit=1)
            if len(sps) == 1:
                k, v = sps[0], ""
            else:
                k, v = sps
            if k in data:
                raise RuntimeError(f"duplicate key {k!r} at {path}:{ln}")
            data[k] = v
    return data


def load_num_sequence_text(path: Union[Path, str],
                           loader_type: str = "text_int") -> Dict[str, np.ndarray]:
    """'uttid 1 2 3' -> {uttid: int array} (fileio/read_text.py load_num_sequence_text)."""
    d = read_2columns_text(path)
    if loader_type == "text_int":
        conv = lambda s: np.array([int(x) for x in s.split()], dtype=np.int64)  # noqa: E731
    elif loader_type == "text_float":
        conv = lambda s: np.array([float(x) for x in s.split()], dtype=np.float32)  # noqa: E731
    elif loader_type == "csv_int":
        conv = lambda s: np.array([int(x) for x in s.split(",")], dtype=np.int64)  # noqa: E731
    else:
        raise ValueError(loader_type)
    return {k: conv(v) for k, v in d.items()}


def _to_float(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32)


def _split_offset(rx: str) -> Tuple[str, int]:
    """'file.ark:123' -> ('file.ark', 123) when that file exists and the
    whole entry does not; else (rx, 0)."""
    if ":" in rx:
        head, _, tail = rx.rpartition(":")
        if tail.isdigit() and Path(head).exists() and not Path(rx).exists():
            return head, int(tail)
    return rx, 0


def _decode_stream(payload_or_file) -> Tuple[int, np.ndarray]:
    """A RIFF or flac stream (bytes, or a file at its start) -> (rate,
    float32 array)."""
    from scipy.io import wavfile

    from llm_guided_asr_tpu_torch.data.flac import read_flac

    if isinstance(payload_or_file, (bytes, bytearray)):
        if payload_or_file[:4] == b"fLaC":
            return read_flac(payload_or_file)
        payload_or_file = io.BytesIO(payload_or_file)
    else:
        head = payload_or_file.read(8)
        if head[:4] == b"fLaC":
            return read_flac(head + payload_or_file.read())
        # the RIFF's own bytes: scipy's chunk loop compares file positions
        # with the RIFF size, which fails for a stream at an ark offset
        size = struct.unpack("<I", head[4:8])[0] if len(head) == 8 else 0
        payload_or_file = io.BytesIO(head + payload_or_file.read(size))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rate, arr = wavfile.read(payload_or_file)
    return rate, _to_float(arr)


def read_audio(rx: str, dtype=np.float32) -> Tuple[int, np.ndarray]:
    """Resolve one wav.scp entry: a wav or flac path, a 'cmd |' pipe that
    writes a RIFF or flac stream, or 'file.ark:offset' (sound_scp.py +
    kaldiio's pipe and offset handling in espnet2/train/dataset.py:49)."""
    if rx.rstrip().endswith("|"):
        proc = subprocess.run(rx.rstrip().rstrip("|"), shell=True, capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError(f"wav.scp pipe command failed ({proc.returncode}): {rx!r}\n"
                               f"{proc.stderr.decode(errors='replace')[:500]}")
        rate, arr = _decode_stream(proc.stdout)
        return rate, arr.astype(dtype)
    path, offset = _split_offset(rx)
    with open(path, "rb") as f:
        f.seek(offset)
        rate, arr = _decode_stream(f)
    return rate, arr.astype(dtype)


def _peek_wav_samples(f) -> Optional[int]:
    """Sample count from a RIFF header without reading audio data."""
    if f.read(4) != b"RIFF":
        return None
    f.read(4)
    if f.read(4) != b"WAVE":
        return None
    channels = bits = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            return None
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            fmt = f.read(size)
            channels = struct.unpack("<H", fmt[2:4])[0]
            bits = struct.unpack("<H", fmt[14:16])[0]
        elif cid == b"data":
            if channels is None or not bits:
                return None
            return size // (channels * (bits // 8))
        else:
            f.seek(size + (size & 1), 1)


def peek_audio_length(rx: str) -> Optional[int]:
    """Sample count of a wav.scp entry from its header alone (RIFF, or
    flac STREAMINFO; at the offset of an ark entry); None when only a full
    read can tell (pipes)."""
    if rx.rstrip().endswith("|"):
        return None
    path, offset = _split_offset(rx)
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            magic = f.read(4)
            if magic == b"fLaC":
                f.read(4)  # the metadata block header
                body = f.read(34)  # STREAMINFO is always first, 34 bytes
                hi = struct.unpack(">I", body[10:14])[0]
                total = (hi & 0xF) << 32 | struct.unpack(">I", body[14:18])[0]
                return total or None
            if magic == b"RIFF":
                f.seek(offset)
                return _peek_wav_samples(f)
    except (OSError, struct.error):
        return None
    return None


def read_wav(path: Union[Path, str]) -> Tuple[int, np.ndarray]:
    """wav -> (rate, float32 array in [-1, 1])."""
    from scipy.io import wavfile

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # WavFileWarning on non-data chunks
        rate, data = wavfile.read(str(path))
    return rate, _to_float(data)


def write_wav(path: Union[Path, str], rate: int, data: np.ndarray):
    from scipy.io import wavfile

    data = np.clip(data, -1.0, 1.0)
    wavfile.write(str(path), rate, (data * 32767.0).astype(np.int16))


class SoundScpReader:
    """Lazy dict-like uttid -> (rate, waveform) (fileio/sound_scp.py)."""

    def __init__(self, path: Union[Path, str], dtype=np.float32):
        self.path = path
        self.dtype = dtype
        self.data = read_2columns_text(path)

    def __getitem__(self, key: str) -> Tuple[int, np.ndarray]:
        return read_audio(self.data[key], dtype=self.dtype)

    def keys(self):
        return self.data.keys()

    def __len__(self):
        return len(self.data)

    def __contains__(self, k):
        return k in self.data

    def __iter__(self):
        return iter(self.data)


class NpyScpReader:
    """uttid -> np.load(path) (fileio/npy_scp.py)."""

    def __init__(self, path: Union[Path, str]):
        self.data = read_2columns_text(path)

    def __getitem__(self, key: str) -> np.ndarray:
        return np.load(self.data[key])

    def peek_length(self, key: str) -> int:
        return int(np.load(self.data[key], mmap_mode="r").shape[0])

    def keys(self):
        return self.data.keys()

    def __len__(self):
        return len(self.data)

    def __iter__(self):
        return iter(self.data)


class DatadirWriter:
    """Hierarchical scp-file writer for inference outputs (fileio/datadir_writer.py).

    writer["text"][uttid] = "hello" appends 'uttid hello' to <dir>/text.
    """

    def __init__(self, p: Union[Path, str]):
        self.path = Path(p)
        self.path.mkdir(parents=True, exist_ok=True)
        self.children: Dict[str, "_FileWriter"] = {}

    def __getitem__(self, name: str) -> "_FileWriter":
        if name not in self.children:
            self.children[name] = _FileWriter(self.path / name)
        return self.children[name]

    def close(self):
        for c in self.children.values():
            c.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class _FileWriter:
    def __init__(self, path: Path):
        path.parent.mkdir(parents=True, exist_ok=True)
        self.f = open(path, "w", encoding="utf-8")

    def __setitem__(self, key: str, value: str):
        self.f.write(f"{key} {value}\n")
        self.f.flush()

    def close(self):
        self.f.close()


def write_shape_file(path: Union[Path, str], shapes: Dict[str, Tuple[int, ...]]):
    """collect-stats shape artifact: 'uttid d1,d2' lines."""
    with open(path, "w", encoding="utf-8") as f:
        for k, shp in shapes.items():
            f.write(f"{k} {','.join(str(s) for s in shp)}\n")


def read_shape_file(path: Union[Path, str]) -> Dict[str, Tuple[int, ...]]:
    d = read_2columns_text(path)
    return {k: tuple(int(x) for x in v.split(",")) for k, v in d.items()}
