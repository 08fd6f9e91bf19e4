"""Self-contained FLAC reader and minimal writer for sound scp loading (the
port's own copy of llm_guided_asr_tpu/data/flac.py).

The reference loads flac through soundfile (espnet2/fileio/sound_scp.py);
neither image has an audio codec library, so the FLAC bitstream is decoded
per the public spec (RFC 9639): constant, verbatim, fixed and LPC
subframes, rice and rice2 residual partitions, wasted bits, every stereo
decorrelation mode, 8/16/24-bit samples.  A verbatim subframe's samples
are read in one numpy pass; everything else sample by sample, as in the
JAX package.

The writer emits spec-valid FLAC with verbatim subframes (or an order-2
fixed predictor) only; it exists for round-trip tests and fixtures, not
for compression.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte = pos
        self.bit = 0

    def read(self, n: int) -> int:
        """Read n bits MSB-first."""
        out = 0
        while n > 0:
            avail = 8 - self.bit
            take = min(n, avail)
            cur = self.data[self.byte]
            out = (out << take) | ((cur >> (avail - take)) & ((1 << take) - 1))
            self.bit += take
            n -= take
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
        return out

    def read_signed_array(self, count: int, n: int) -> np.ndarray:
        """``count`` consecutive signed ``n``-bit values MSB-first, in one
        numpy pass (int64)."""
        if count == 0:
            return np.zeros(0, np.int64)
        start = self.byte * 8 + self.bit
        stop = start + count * n
        chunk = np.frombuffer(self.data, np.uint8, (stop + 7) // 8 - self.byte, self.byte)
        bits = np.unpackbits(chunk)[self.bit:self.bit + count * n].reshape(count, n)
        vals = bits.astype(np.int64) @ (np.int64(1) << np.arange(n - 1, -1, -1, dtype=np.int64))
        vals = np.where(vals >= (1 << (n - 1)), vals - (1 << n), vals)
        self.byte, self.bit = divmod(stop, 8)
        return vals

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count 0 bits until a 1 bit."""
        q = 0
        while True:
            avail = 8 - self.bit
            cur = self.data[self.byte] & ((1 << avail) - 1)
            if cur == 0:
                q += avail
                self.bit = 0
                self.byte += 1
                continue
            lead = avail - cur.bit_length()
            q += lead
            self.bit += lead + 1
            if self.bit >= 8:
                self.bit -= 8
                self.byte += 1
            return q

    def align(self):
        if self.bit:
            self.bit = 0
            self.byte += 1


def _read_utf8_number(br: _BitReader) -> int:
    """FLAC frame-header UTF-8-style coded number (up to 36 bits)."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    val = b0 & (mask - 1)
    for _ in range(n):
        val = (val << 6) | (br.read(8) & 0x3F)
    return val


_BLOCKSIZES = [0, 192, 576, 1152, 2304, 4608, -1, -2, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768]
_SAMPLE_SIZES = [0, 8, 12, 0, 16, 20, 24, 32]
_RATES = [0, 88200, 176400, 192000, 8000, 16000, 22050, 24000, 32000, 44100, 48000, 96000, -1, -2, -3, 0]


def _decode_residual(br: _BitReader, blocksize: int, pred_order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError("reserved residual coding method")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    porder = br.read(4)
    nparts = 1 << porder
    part_len = blocksize >> porder
    res = np.empty(blocksize - pred_order, dtype=np.int64)
    idx = 0
    for p in range(nparts):
        n = part_len - (pred_order if p == 0 else 0)
        param = br.read(pbits)
        if param == escape:
            raw = br.read(5)
            for i in range(n):
                res[idx + i] = br.read_signed(raw) if raw else 0
        else:
            for i in range(n):
                q = br.read_unary()
                r = br.read(param) if param else 0
                zz = (q << param) | r
                res[idx + i] = (zz >> 1) ^ -(zz & 1)
        idx += n
    return res


_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("invalid subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted
    if stype == 0:  # constant
        v = br.read_signed(bps)
        out = np.full(blocksize, v, dtype=np.int64)
    elif stype == 1:  # verbatim
        out = br.read_signed_array(blocksize, bps)
    elif 8 <= stype <= 12:  # fixed, order = stype-8
        order = stype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        out = np.empty(blocksize, dtype=np.int64)
        out[:order] = warm
        coefs = _FIXED_COEFS[order]
        for i in range(order, blocksize):
            acc = res[i - order]
            for j, c in enumerate(coefs):
                acc += c * out[i - 1 - j]
            out[i] = acc
    elif stype >= 32:  # LPC, order = stype-31
        order = stype - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4) + 1
        shift = br.read_signed(5)
        if shift < 0:
            # RFC 9639 §9.2.2 marks negative shift as invalid/reserved;
            # a raw `acc >> shift` would raise ValueError mid-decode
            raise ValueError(f"invalid FLAC LPC subframe: negative shift {shift}")
        coefs = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        out = np.empty(blocksize, dtype=np.int64)
        out[:order] = warm
        for i in range(order, blocksize):
            acc = 0
            for j in range(order):
                acc += coefs[j] * out[i - 1 - j]
            out[i] = res[i - order] + (acc >> shift)
    else:
        raise ValueError(f"reserved subframe type {stype}")
    if wasted:
        out = out << wasted
    return out


def read_flac(path_or_bytes) -> Tuple[int, np.ndarray]:
    """Decode FLAC -> (rate, float32 array in [-1, 1], [T] or [T, C])."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    rate = channels = bps = 0
    total = 0
    while True:
        hdr = data[pos]
        last = hdr & 0x80
        btype = hdr & 0x7F
        (blen,) = struct.unpack(">I", b"\x00" + data[pos + 1 : pos + 4])
        body = data[pos + 4 : pos + 4 + blen]
        if btype == 0:  # STREAMINFO
            br = _BitReader(body)
            br.read(16); br.read(16); br.read(24); br.read(24)
            rate = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
        pos += 4 + blen
        if last:
            break
    chans = [np.empty(0, dtype=np.int64) for _ in range(channels)]
    pieces = [[] for _ in range(channels)]
    ndecoded = 0
    while pos < len(data) - 2 and (total == 0 or ndecoded < total):
        br = _BitReader(data, pos)
        sync = br.read(14)
        if sync != 0x3FFE:
            raise ValueError(f"lost frame sync at byte {pos}")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_assign = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        _read_utf8_number(br)
        blocksize = _BLOCKSIZES[bs_code]
        if blocksize == -1:
            blocksize = br.read(8) + 1
        elif blocksize == -2:
            blocksize = br.read(16) + 1
        if _RATES[sr_code] == -1:
            br.read(8)
        elif _RATES[sr_code] == -2 or _RATES[sr_code] == -3:
            br.read(16)
        frame_bps = _SAMPLE_SIZES[ss_code] or bps
        br.read(8)  # CRC-8 (not verified)
        if ch_assign < 8:
            sub = [_decode_subframe(br, blocksize, frame_bps) for _ in range(ch_assign + 1)]
        elif ch_assign == 8:  # left/side
            left = _decode_subframe(br, blocksize, frame_bps)
            side = _decode_subframe(br, blocksize, frame_bps + 1)
            sub = [left, left - side]
        elif ch_assign == 9:  # right/side
            side = _decode_subframe(br, blocksize, frame_bps + 1)
            right = _decode_subframe(br, blocksize, frame_bps)
            sub = [right + side, right]
        elif ch_assign == 10:  # mid/side
            mid = _decode_subframe(br, blocksize, frame_bps)
            side = _decode_subframe(br, blocksize, frame_bps + 1)
            left = ((mid << 1) | (side & 1)) + side
            sub = [left >> 1, (left >> 1) - side]
        else:
            raise ValueError(f"reserved channel assignment {ch_assign}")
        br.align()
        br.read(16)  # CRC-16 (not verified)
        for c in range(channels):
            pieces[c].append(sub[c])
        ndecoded += blocksize
        pos = br.byte
    chans = [np.concatenate(p) if p else np.empty(0, dtype=np.int64) for p in pieces]
    if total:
        chans = [c[:total] for c in chans]
    scale = float(1 << (bps - 1))
    arr = np.stack(chans, axis=-1).astype(np.float32) / scale
    if channels == 1:
        arr = arr[:, 0]
    return rate, arr


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int):
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _write_fixed_subframe(bw: "_BitWriter", x: np.ndarray, order: int = 2):
    """Fixed-predictor subframe with single-partition rice residuals."""
    n = len(x)
    bw.write(0, 1); bw.write(8 + order, 6); bw.write(0, 1)
    for i in range(order):
        bw.write(int(x[i]), 16)
    res = x.astype(np.int64)
    for _ in range(order):
        res = np.diff(res)
    zz = (np.abs(res) << 1) - (res < 0).astype(np.int64)  # zigzag
    mean = max(float(zz.mean()) if len(zz) else 0.0, 1.0)
    param = min(max(int(np.log2(mean)), 0), 14)
    bw.write(0, 2)      # rice (4-bit params)
    bw.write(0, 4)      # partition order 0
    bw.write(param, 4)
    for z in zz:
        q = int(z) >> param
        bw.write(0, q) if q else None
        bw.write(1, 1)
        if param:
            bw.write(int(z) & ((1 << param) - 1), param)


def write_flac(path, rate: int, data: np.ndarray, subframe: str = "verbatim"):
    """Encode float32 [-1,1] ([T] or [T,C]) as 16-bit FLAC.

    ``subframe``: 'verbatim' (default) or 'fixed' (order-2 predictor with
    rice residuals — exercises the same decode path real encoders use).
    """
    if data.ndim == 1:
        data = data[:, None]
    total, channels = data.shape
    samples = np.clip(np.round(data * 32767.0), -32768, 32767).astype(np.int64)
    out = bytearray(b"fLaC")
    si = _BitWriter()
    bsz = 4096
    si.write(bsz, 16); si.write(bsz, 16)
    si.write(0, 24); si.write(0, 24)
    si.write(rate, 20); si.write(channels - 1, 3); si.write(15, 5)  # bps-1 = 15
    si.write(total, 36)
    body = si.bytes() + b"\x00" * 16  # md5 zeroed (unverified-by-decoders)
    out += bytes([0x80]) + struct.pack(">I", len(body))[1:] + body
    frame_no = 0
    for start in range(0, total, bsz):
        n = min(bsz, total - start)
        bw = _BitWriter()
        bw.write(0x3FFE, 14); bw.write(0, 1); bw.write(0, 1)
        bw.write(0b0111, 4)   # blocksize: 16-bit at end of header
        bw.write(0, 4)        # sample rate: from STREAMINFO
        bw.write(channels - 1, 4)
        bw.write(0b100, 3)    # 16 bps
        bw.write(0, 1)
        # UTF-8-style coded frame number: k bytes encode values < 2^(5k+1)
        fn = frame_no
        if fn < 0x80:
            bw.write(fn, 8)
        else:
            k = 2
            while fn >= (1 << (5 * k + 1)):
                k += 1
            bw.write(((0xFF << (8 - k)) & 0xFF) | (fn >> (6 * (k - 1))), 8)
            for i in range(k - 2, -1, -1):
                bw.write(0x80 | ((fn >> (6 * i)) & 0x3F), 8)
        bw.write(n - 1, 16)
        hdr = bw
        hdr.align()
        hdr_bytes = hdr.bytes()
        bw2 = _BitWriter()
        bw2.write(_crc8(hdr_bytes), 8)
        for c in range(channels):
            if subframe == "fixed" and n > 2:
                _write_fixed_subframe(bw2, samples[start : start + n, c], order=2)
            else:
                bw2.write(0, 1); bw2.write(1, 6); bw2.write(0, 1)  # verbatim
                for i in range(n):
                    bw2.write(int(samples[start + i, c]), 16)
        bw2.align()
        payload = hdr_bytes + bw2.bytes()
        payload += struct.pack(">H", _crc16(payload))
        out += payload
        frame_no += 1
    with open(path, "wb") as f:
        f.write(out)
