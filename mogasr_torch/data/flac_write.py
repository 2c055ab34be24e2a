"""FLAC encoder (pure Python + NumPy).

The port's copy of mogasr/data/flac_write.py, its imports pointed at mogasr_torch.

SURVEY.md §2 "Audio I/O" row / §1 L0.  The box has no libsndfile, so the
framework carries its own codec pair: this encoder and the native C++ decoder
(mogasr/native/flac_native.cpp).  The encoder emits spec-conformant streams:

- STREAMINFO with real MD5 of the unencoded audio;
- fixed-blocksize frames, UTF-8 coded frame numbers, CRC-8 / CRC-16;
- subframes: CONSTANT, VERBATIM, FIXED (orders 0-4), and genuine LPC
  (Levinson-Durbin on the autocorrelation, quantized coefficients) — the
  encoder picks the cheapest per channel;
- Rice-coded residual (method 0, partition order 0) with escape fallback;
- wasted-bits detection;
- stereo: independent, left/side, right/side, mid/side (auto = cheapest).

Primary use: fixture generation for the decoder tests and LibriSpeech-layout
corpora, plus `write_flac` as the public write path mirroring `write_wav`.
Bit depths 8/12/16/20/24/32 are accepted.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Optional

import numpy as np

_SAMPLE_SIZE_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
_MAX_RICE_PARAM = 14  # method-0 params 0..14; 15 = escape


class _BitWriter:
    def __init__(self) -> None:
        self._bytes = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._bytes.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_signed(self, value: int, nbits: int) -> None:
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then a 1

    def align(self) -> None:
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def getvalue(self) -> bytes:
        assert self._nbits == 0, "unaligned"
        return bytes(self._bytes)


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


def _utf8_number(n: int) -> bytes:
    """FLAC's UTF-8-style coding of frame/sample numbers (up to 36 bits)."""
    if n < 0x80:
        return bytes([n])
    for nbytes, first_mask, first_bits in (
        (2, 0xC0, 5), (3, 0xE0, 4), (4, 0xF0, 3), (5, 0xF8, 2),
        (6, 0xFC, 1), (7, 0xFE, 0),
    ):
        if n < 1 << (first_bits + 6 * (nbytes - 1)):
            out = bytearray(nbytes)
            for i in range(nbytes - 1, 0, -1):
                out[i] = 0x80 | (n & 0x3F)
                n >>= 6
            out[0] = first_mask | n
            return bytes(out)
    raise ValueError("frame number too large")


def _zigzag(r: np.ndarray) -> np.ndarray:
    r = r.astype(np.int64)
    return np.where(r >= 0, r << 1, (-r << 1) - 1).astype(np.int64)


def _rice_cost(zz: np.ndarray, param: int) -> int:
    return int(np.sum(zz >> param)) + zz.size * (param + 1)


def _best_rice(zz: np.ndarray) -> tuple[int, int]:
    """(param, cost_bits) minimizing the partition-order-0 Rice cost."""
    best_p, best_c = 0, _rice_cost(zz, 0)
    for p in range(1, _MAX_RICE_PARAM + 1):
        c = _rice_cost(zz, p)
        if c < best_c:
            best_p, best_c = p, c
    return best_p, best_c


def _raw_bits_needed(r: np.ndarray) -> int:
    if r.size == 0:
        return 1
    m = int(max(int(r.max(initial=0)), -int(r.min(initial=0)) - 1, 0))
    return max(1, m.bit_length() + 1)


def _write_residual(bw: _BitWriter, resid: np.ndarray) -> None:
    """Rice method 0, partition order 0, with 15=escape fallback."""
    zz = _zigzag(resid)
    param, cost = _best_rice(zz)
    raw = _raw_bits_needed(resid)
    bw.write(0, 2)   # method 0
    bw.write(0, 4)   # partition order 0
    if raw * resid.size + 5 < cost:
        bw.write(0xF, 4)       # escape
        bw.write(raw, 5)
        for v in resid.tolist():
            bw.write_signed(int(v), raw)
    else:
        bw.write(param, 4)
        shifted = (zz >> param).tolist()
        rems = (zz & ((1 << param) - 1)).tolist() if param else None
        for i, q in enumerate(shifted):
            bw.write_unary(int(q))
            if param:
                bw.write(int(rems[i]), param)


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _lpc_design(x: np.ndarray, order: int, precision: int = 12):
    """Levinson-Durbin -> quantized integer LPC (coefs, shift) or None."""
    xf = x.astype(np.float64)
    n = xf.size
    if n <= order + 1 or not np.any(xf):
        return None
    ac = np.array([np.dot(xf[: n - k], xf[k:]) for k in range(order + 1)])
    if ac[0] <= 0:
        return None
    err = ac[0]
    a = np.zeros(order)
    for i in range(order):
        acc = ac[i + 1] - np.dot(a[:i], ac[i:0:-1][:i])
        k = acc / err
        a[: i + 1] = np.concatenate([a[:i] - k * a[:i][::-1], [k]])
        err *= 1 - k * k
        if err <= 0:
            return None
    cmax = float(np.max(np.abs(a)))
    if cmax == 0 or not np.isfinite(cmax):
        return None
    shift = precision - 1 - max(0, int(np.floor(np.log2(cmax))) + 1)
    shift = int(np.clip(shift, 0, 15))
    q = np.round(a * (1 << shift)).astype(np.int64)
    lim = 1 << (precision - 1)
    q = np.clip(q, -lim, lim - 1)
    if not np.any(q):
        return None
    return q, shift


def _lpc_residual(x: np.ndarray, coefs: np.ndarray, shift: int) -> np.ndarray:
    """r[i] = x[i] - ((sum_j coefs[j] * x[i-1-j]) >> shift), i >= order."""
    x = x.astype(np.int64)
    order = len(coefs)
    acc = np.zeros(x.size - order, dtype=np.int64)
    for j in range(order):
        acc += coefs[j] * x[order - 1 - j : x.size - 1 - j]
    return x[order:] - (acc >> shift)


def _encode_subframe(bw: _BitWriter, x: np.ndarray, eff_bits: int,
                     try_lpc: bool = True) -> None:
    x = x.astype(np.int64)
    n = x.size
    # Wasted bits: common trailing zeros across all samples.
    wasted = 0
    if np.any(x):
        orv = int(np.bitwise_or.reduce(x))
        wasted = min((orv & -orv).bit_length() - 1, eff_bits - 1)
    if wasted:
        x = x >> wasted
        eff_bits -= wasted

    def header(type_code: int) -> None:
        bw.write(0, 1)
        bw.write(type_code, 6)
        if wasted:
            bw.write(1, 1)
            bw.write_unary(wasted - 1)
        else:
            bw.write(0, 1)

    if np.all(x == x[0]):
        header(0)  # CONSTANT
        bw.write_signed(int(x[0]), eff_bits)
        return

    # Candidates: fixed orders 0..4, optionally LPC; fall back to verbatim.
    best = ("verbatim", None, n * eff_bits)
    for order in range(0, 5):
        if order >= n:
            break
        resid = _fixed_residual(x, order)
        _, cost = _best_rice(_zigzag(resid))
        cost = min(cost, _raw_bits_needed(resid) * resid.size + 5)
        cost += order * eff_bits + 6
        if cost < best[2]:
            best = ("fixed", (order, resid), cost)
    if try_lpc and n >= 16:
        order = min(8, n // 2 - 1)
        design = _lpc_design(x, order)
        if design is not None:
            coefs, shift = design
            resid = _lpc_residual(x, coefs, shift)
            _, cost = _best_rice(_zigzag(resid))
            cost = min(cost, _raw_bits_needed(resid) * resid.size + 5)
            cost += order * eff_bits + 4 + 5 + order * 12 + 6
            if cost < best[2]:
                best = ("lpc", (coefs, shift, resid), cost)

    kind, payload, _ = best
    if kind == "verbatim":
        header(1)
        for v in x.tolist():
            bw.write_signed(int(v), eff_bits)
    elif kind == "fixed":
        order, resid = payload
        header(0b001000 | order)
        for v in x[:order].tolist():
            bw.write_signed(int(v), eff_bits)
        _write_residual(bw, resid)
    else:
        coefs, shift, resid = payload
        order = len(coefs)
        header(0b100000 | (order - 1))
        for v in x[:order].tolist():
            bw.write_signed(int(v), eff_bits)
        bw.write(12 - 1, 4)       # precision code = precision-1
        bw.write_signed(shift, 5)
        for c in coefs.tolist():
            bw.write_signed(int(c), 12)
        _write_residual(bw, resid)


def encode_flac(samples: np.ndarray, sr: int, bits: int = 16,
                blocksize: int = 4096, stereo_mode: str = "auto",
                try_lpc: bool = True) -> bytes:
    """Encode int samples ([N] mono or [N, C]) to a FLAC stream (bytes)."""
    if bits not in _SAMPLE_SIZE_CODE:
        raise ValueError(f"unsupported bit depth {bits}")
    x = np.asarray(samples)
    if not np.issubdtype(x.dtype, np.integer):
        raise TypeError("encode_flac takes integer samples")
    x = x.astype(np.int64)
    if x.ndim == 1:
        x = x[:, None]
    n, nch = x.shape
    if nch > 8:
        raise ValueError("too many channels")
    lim = 1 << (bits - 1)
    if x.size and (x.min() < -lim or x.max() >= lim):
        raise ValueError(f"samples exceed {bits}-bit range")

    # ---- STREAMINFO ----
    md5 = hashlib.md5()
    bps_bytes = bits // 8 if bits % 8 == 0 else None
    if bps_bytes:
        raw = np.zeros((n * nch, bps_bytes), np.uint8)
        flat = x.reshape(-1)
        for b in range(bps_bytes):
            raw[:, b] = (flat >> (8 * b)) & 0xFF
        md5.update(raw.tobytes())
    si = _BitWriter()
    si.write(blocksize, 16)
    si.write(blocksize, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sr, 20)
    si.write(nch - 1, 3)
    si.write(bits - 1, 5)
    si.write(n, 36)
    streaminfo = si.getvalue() + (md5.digest() if bps_bytes else b"\x00" * 16)

    out = bytearray(b"fLaC")
    out += bytes([0x80]) + struct.pack(">I", len(streaminfo))[1:] + streaminfo

    # ---- frames ----
    for fi, start in enumerate(range(0, max(n, 1), blocksize)):
        blk = x[start : start + blocksize]
        bs = blk.shape[0]
        if bs == 0:
            break
        mode = stereo_mode
        chans: list[tuple[np.ndarray, int]] = []
        if nch == 2:
            left, right = blk[:, 0], blk[:, 1]
            mid = (left + right) >> 1
            side = left - right
            if mode == "auto":
                def est(c):
                    return _best_rice(_zigzag(_fixed_residual(c, 2)))[1]
                costs = {
                    "independent": est(left) + est(right),
                    "left_side": est(left) + est(side),
                    "right_side": est(right) + est(side),
                    "mid_side": est(mid) + est(side),
                }
                mode = min(costs, key=costs.get)
            if mode == "independent":
                ch_code, chans = 1, [(left, bits), (right, bits)]
            elif mode == "left_side":
                ch_code, chans = 0b1000, [(left, bits), (side, bits + 1)]
            elif mode == "right_side":
                ch_code, chans = 0b1001, [(side, bits + 1), (right, bits)]
            elif mode == "mid_side":
                ch_code, chans = 0b1010, [(mid, bits), (side, bits + 1)]
            else:
                raise ValueError(f"unknown stereo_mode {stereo_mode}")
        else:
            ch_code = nch - 1
            chans = [(blk[:, c], bits) for c in range(nch)]

        bw = _BitWriter()
        bw.write(0b11111111111110, 14)
        bw.write(0, 1)   # reserved
        bw.write(0, 1)   # fixed-blocksize stream
        bw.write(0b0111, 4)          # 16-bit blocksize-1 at header end
        bw.write(0, 4)               # sample rate: from STREAMINFO
        bw.write(ch_code, 4)
        bw.write(_SAMPLE_SIZE_CODE[bits], 3)
        bw.write(0, 1)   # reserved
        for b in _utf8_number(fi):
            bw.write(b, 8)
        bw.write(bs - 1, 16)
        hdr = bw.getvalue()
        bw.write(_crc8(hdr), 8)
        for cx, cbits in chans:
            _encode_subframe(bw, cx, cbits, try_lpc=try_lpc)
        bw.align()
        body = bw.getvalue()
        out += body + struct.pack(">H", _crc16(body))
    return bytes(out)


def write_flac(path: str, wave_or_pcm: np.ndarray, sr: int, bits: int = 16,
               stereo_mode: str = "auto",
               blocksize: int = 4096) -> None:
    """Write audio as FLAC.  Float input in [-1,1] is quantized to `bits`."""
    x = np.asarray(wave_or_pcm)
    if np.issubdtype(x.dtype, np.floating):
        # Same convention as audio.write_wav: scale by (2^(bits-1) - 1), so
        # wav and flac fixture corpora are bit-identical after decode.
        lim = float((1 << (bits - 1)) - 1)
        x = np.round(np.clip(x, -1.0, 1.0) * lim).astype(np.int64)
    data = encode_flac(x, sr, bits=bits, stereo_mode=stereo_mode,
                       blocksize=blocksize)
    with open(path, "wb") as f:
        f.write(data)
