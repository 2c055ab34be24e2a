// Native FLAC decoder (host-side data loader component).
//
// SURVEY.md §2 "Audio I/O" row / §1 L0: LibriSpeech ships as FLAC, and this
// box has no soundfile/libsndfile, so the framework carries its own decoder.
// Implements the full FLAC bitstream: STREAMINFO, frame headers (all block
// size / sample rate / sample size codes), CONSTANT / VERBATIM / FIXED(0-4) /
// LPC(1-32) subframes, Rice + Rice2 partitioned residual with escape codes,
// wasted bits, and all four stereo decorrelation modes (independent,
// left/side, right/side, mid/side).  Header CRC-8 and frame CRC-16 are
// verified — a corrupt file fails loudly, not with garbage samples.
//
// Exposed via ctypes (see mogasr/native/__init__.py load_flac_lib).

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
    const uint8_t* data;
    long long n;         // total bytes
    long long byte_pos;  // next byte index
    int bit_pos;         // bits consumed of current byte (0..7)
    bool overrun;

    explicit BitReader(const uint8_t* d, long long nb)
        : data(d), n(nb), byte_pos(0), bit_pos(0), overrun(false) {}

    bool eof() const { return byte_pos >= n; }

    uint32_t read_bit() {
        if (byte_pos >= n) { overrun = true; return 0; }
        uint32_t b = (data[byte_pos] >> (7 - bit_pos)) & 1u;
        if (++bit_pos == 8) { bit_pos = 0; ++byte_pos; }
        return b;
    }

    uint64_t read_bits(int k) {  // k <= 57 safe
        uint64_t v = 0;
        // Fast path: aligned whole bytes.
        while (k >= 8 && bit_pos == 0) {
            if (byte_pos >= n) { overrun = true; return 0; }
            v = (v << 8) | data[byte_pos++];
            k -= 8;
        }
        while (k > 0) {
            v = (v << 1) | read_bit();
            --k;
        }
        return v;
    }

    int64_t read_signed(int k) {
        if (k == 0) return 0;
        uint64_t v = read_bits(k);
        uint64_t sign = 1ull << (k - 1);
        return (int64_t)((v ^ sign)) - (int64_t)sign;
    }

    uint32_t read_unary() {  // count of 0 bits before the terminating 1
        uint32_t q = 0;
        for (;;) {
            if (overrun || byte_pos >= n) { overrun = true; return q; }
            // Fast path: scan a whole byte when aligned enough.
            uint8_t cur = data[byte_pos];
            uint8_t rem = (uint8_t)(cur << bit_pos);
            if (rem == 0) {
                q += 8 - bit_pos;
                bit_pos = 0;
                ++byte_pos;
                continue;
            }
            while (((cur >> (7 - bit_pos)) & 1u) == 0) { ++q; ++bit_pos; }
            // consume the 1
            if (++bit_pos >= 8) { bit_pos = 0; ++byte_pos; }
            return q;
        }
    }

    void align_byte() {
        if (bit_pos != 0) { bit_pos = 0; ++byte_pos; }
    }
};

uint8_t crc8_update(uint8_t crc, uint8_t byte) {
    crc ^= byte;
    for (int i = 0; i < 8; ++i)
        crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07) : (uint8_t)(crc << 1);
    return crc;
}

uint16_t crc16_update(uint16_t crc, uint8_t byte) {
    crc ^= (uint16_t)byte << 8;
    for (int i = 0; i < 8; ++i)
        crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x8005) : (uint16_t)(crc << 1);
    return crc;
}

constexpr int ERR_MALFORMED = -1;
constexpr int ERR_TOO_SMALL = -2;
constexpr int ERR_UNSUPPORTED = -3;
constexpr int ERR_CRC = -4;

struct StreamInfo {
    int sample_rate = 0;
    int channels = 0;
    int bits = 0;
    long long total_samples = 0;  // per channel; 0 = unknown
};

// Parse "fLaC" + metadata blocks; on success *bp is the offset of the first
// audio frame.
int parse_header(const uint8_t* data, long long n, StreamInfo* si, long long* bp) {
    if (n < 42 || memcmp(data, "fLaC", 4) != 0) return ERR_MALFORMED;
    long long pos = 4;
    bool seen_streaminfo = false;
    for (;;) {
        if (pos + 4 > n) return ERR_MALFORMED;
        uint8_t hdr = data[pos];
        bool last = (hdr & 0x80) != 0;
        int type = hdr & 0x7f;
        long long len = ((long long)data[pos + 1] << 16) |
                        ((long long)data[pos + 2] << 8) | data[pos + 3];
        pos += 4;
        if (pos + len > n) return ERR_MALFORMED;
        if (type == 0) {  // STREAMINFO
            if (len < 34) return ERR_MALFORMED;
            const uint8_t* s = data + pos;
            si->sample_rate = ((int)s[10] << 12) | ((int)s[11] << 4) | (s[12] >> 4);
            si->channels = ((s[12] >> 1) & 0x7) + 1;
            si->bits = (((s[12] & 0x1) << 4) | (s[13] >> 4)) + 1;
            si->total_samples = (((long long)(s[13] & 0x0f)) << 32) |
                                ((long long)s[14] << 24) | ((long long)s[15] << 16) |
                                ((long long)s[16] << 8) | s[17];
            seen_streaminfo = true;
        }
        pos += len;
        if (last) break;
    }
    if (!seen_streaminfo || si->sample_rate == 0) return ERR_MALFORMED;
    *bp = pos;
    return 0;
}

// Decode one subframe into chan[0..blocksize).  bps is the effective bit
// depth for this channel (side channels carry +1).
int decode_subframe(BitReader& br, int64_t* chan, int blocksize, int bps) {
    if (br.read_bit() != 0) return ERR_MALFORMED;  // padding bit
    uint32_t type = (uint32_t)br.read_bits(6);
    int wasted = 0;
    if (br.read_bit()) wasted = (int)br.read_unary() + 1;
    int eff = bps - wasted;
    if (eff <= 0 || eff > 33) return ERR_MALFORMED;

    int order;
    if (type == 0) {  // CONSTANT
        int64_t v = br.read_signed(eff);
        for (int i = 0; i < blocksize; ++i) chan[i] = v;
        order = -1;
    } else if (type == 1) {  // VERBATIM
        for (int i = 0; i < blocksize; ++i) chan[i] = br.read_signed(eff);
        order = -1;
    } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
        order = type & 0x07;
        if (order > blocksize) return ERR_MALFORMED;
        for (int i = 0; i < order; ++i) chan[i] = br.read_signed(eff);
        // falls through to the shared residual decode below
    } else if (type & 0x20) {  // LPC
        order = (type & 0x1f) + 1;
        if (order > blocksize) return ERR_MALFORMED;
        for (int i = 0; i < order; ++i) chan[i] = br.read_signed(eff);
        {
            uint32_t prec = (uint32_t)br.read_bits(4);
            if (prec == 15) return ERR_MALFORMED;
            int precision = (int)prec + 1;
            int shift = (int)br.read_signed(5);
            if (shift < 0) return ERR_MALFORMED;
            int64_t coef[32];
            for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
            // residual
            {
                uint32_t method = (uint32_t)br.read_bits(2);
                if (method > 1) return ERR_UNSUPPORTED;
                int plen = method == 0 ? 4 : 5;
                uint32_t esc = method == 0 ? 0xF : 0x1F;
                int porder = (int)br.read_bits(4);
                int nparts = 1 << porder;
                if ((blocksize >> porder) << porder != blocksize) return ERR_MALFORMED;
                int idx = order;
                for (int p = 0; p < nparts; ++p) {
                    int cnt = (blocksize >> porder) - (p == 0 ? order : 0);
                    if (cnt < 0) return ERR_MALFORMED;
                    uint32_t param = (uint32_t)br.read_bits(plen);
                    if (param == esc) {
                        int raw = (int)br.read_bits(5);
                        for (int i = 0; i < cnt; ++i) chan[idx++] = br.read_signed(raw);
                    } else {
                        for (int i = 0; i < cnt; ++i) {
                            uint32_t q = br.read_unary();
                            uint64_t u = ((uint64_t)q << param) | br.read_bits((int)param);
                            chan[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
                        }
                    }
                }
            }
            if (br.overrun) return ERR_MALFORMED;
            // LPC reconstruction
            for (int i = order; i < blocksize; ++i) {
                int64_t acc = 0;
                for (int j = 0; j < order; ++j) acc += coef[j] * chan[i - 1 - j];
                chan[i] += acc >> shift;
            }
        }
        order = -1;  // residual already handled
    } else {
        return ERR_MALFORMED;
    }

    if (order >= 0) {
        uint32_t method = (uint32_t)br.read_bits(2);
        if (method > 1) return ERR_UNSUPPORTED;
        int plen = method == 0 ? 4 : 5;
        uint32_t esc = method == 0 ? 0xF : 0x1F;
        int porder = (int)br.read_bits(4);
        int nparts = 1 << porder;
        if ((blocksize >> porder) << porder != blocksize) return ERR_MALFORMED;
        int idx = order;
        for (int p = 0; p < nparts; ++p) {
            int cnt = (blocksize >> porder) - (p == 0 ? order : 0);
            if (cnt < 0) return ERR_MALFORMED;
            uint32_t param = (uint32_t)br.read_bits(plen);
            if (param == esc) {
                int raw = (int)br.read_bits(5);
                for (int i = 0; i < cnt; ++i) chan[idx++] = br.read_signed(raw);
            } else {
                for (int i = 0; i < cnt; ++i) {
                    uint32_t q = br.read_unary();
                    uint64_t u = ((uint64_t)q << param) | br.read_bits((int)param);
                    chan[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
                }
            }
        }
        if (br.overrun) return ERR_MALFORMED;
        // Fixed-predictor reconstruction.
        switch (order) {
            case 0: break;
            case 1:
                for (int i = 1; i < blocksize; ++i) chan[i] += chan[i - 1];
                break;
            case 2:
                for (int i = 2; i < blocksize; ++i)
                    chan[i] += 2 * chan[i - 1] - chan[i - 2];
                break;
            case 3:
                for (int i = 3; i < blocksize; ++i)
                    chan[i] += 3 * chan[i - 1] - 3 * chan[i - 2] + chan[i - 3];
                break;
            case 4:
                for (int i = 4; i < blocksize; ++i)
                    chan[i] += 4 * chan[i - 1] - 6 * chan[i - 2] + 4 * chan[i - 3] -
                               chan[i - 4];
                break;
        }
    }
    if (wasted) {
        for (int i = 0; i < blocksize; ++i) chan[i] <<= wasted;
    }
    return 0;
}

}  // namespace

extern "C" {

// Parse STREAMINFO only.  Returns 0 on success.
int flac_stream_info(const uint8_t* data, long long n_bytes, int* sample_rate,
                     int* channels, int* bits, long long* total_samples) {
    StreamInfo si;
    long long bp;
    int rc = parse_header(data, n_bytes, &si, &bp);
    if (rc != 0) return rc;
    *sample_rate = si.sample_rate;
    *channels = si.channels;
    *bits = si.bits;
    *total_samples = si.total_samples;
    return 0;
}

// Decode the whole stream into `out` (interleaved int32, capacity `out_cap`
// total values).  Returns the number of per-channel frames decoded (so
// interleaved values written = return * channels), or a negative error code.
long long flac_decode(const uint8_t* data, long long n_bytes, int32_t* out,
                      long long out_cap, int* sample_rate, int* channels,
                      int* bits) {
    StreamInfo si;
    long long bp;
    int rc = parse_header(data, n_bytes, &si, &bp);
    if (rc != 0) return rc;
    if (si.channels < 1 || si.channels > 8) return ERR_UNSUPPORTED;
    *sample_rate = si.sample_rate;
    *channels = si.channels;
    *bits = si.bits;

    // Per-channel scratch, max FLAC block size is 65535.
    static thread_local int64_t chan_buf[8][65536];

    BitReader br(data, n_bytes);
    br.byte_pos = bp;
    long long written = 0;  // per-channel frames

    while (br.byte_pos < n_bytes) {
        long long frame_start = br.byte_pos;
        // Frame sync: 11111111 111110xx
        uint32_t sync = (uint32_t)br.read_bits(14);
        if (br.overrun) break;  // trailing padding/ID3 junk: stop
        if (sync != 0x3FFE) return ERR_MALFORMED;
        br.read_bit();  // reserved
        br.read_bit();  // blocking strategy
        uint32_t bs_code = (uint32_t)br.read_bits(4);
        uint32_t sr_code = (uint32_t)br.read_bits(4);
        uint32_t ch_code = (uint32_t)br.read_bits(4);
        uint32_t ss_code = (uint32_t)br.read_bits(3);
        br.read_bit();  // reserved
        // UTF-8 coded frame/sample number: skip.
        uint32_t first = (uint32_t)br.read_bits(8);
        if (first >= 0x80) {
            int extra = 0;
            for (uint32_t m = 0x40; first & m; m >>= 1) ++extra;
            if (extra < 1 || extra > 6) return ERR_MALFORMED;
            for (int i = 0; i < extra; ++i) br.read_bits(8);
        }
        int blocksize;
        if (bs_code == 1) blocksize = 192;
        else if (bs_code >= 2 && bs_code <= 5) blocksize = 576 << (bs_code - 2);
        else if (bs_code == 6) blocksize = (int)br.read_bits(8) + 1;
        else if (bs_code == 7) blocksize = (int)br.read_bits(16) + 1;
        else if (bs_code >= 8) blocksize = 256 << (bs_code - 8);
        else return ERR_MALFORMED;
        int sr = si.sample_rate;
        switch (sr_code) {
            case 0: break;
            case 1: sr = 88200; break;
            case 2: sr = 176400; break;
            case 3: sr = 192000; break;
            case 4: sr = 8000; break;
            case 5: sr = 16000; break;
            case 6: sr = 22050; break;
            case 7: sr = 24000; break;
            case 8: sr = 32000; break;
            case 9: sr = 44100; break;
            case 10: sr = 48000; break;
            case 11: sr = 96000; break;
            case 12: sr = (int)br.read_bits(8) * 1000; break;
            case 13: sr = (int)br.read_bits(16); break;
            case 14: sr = (int)br.read_bits(16) * 10; break;
            default: return ERR_MALFORMED;
        }
        (void)sr;
        int bps = si.bits;
        switch (ss_code) {
            case 0: break;
            case 1: bps = 8; break;
            case 2: bps = 12; break;
            case 4: bps = 16; break;
            case 5: bps = 20; break;
            case 6: bps = 24; break;
            case 7: bps = 32; break;
            default: return ERR_MALFORMED;
        }
        int nch;
        enum { INDEP, LEFT_SIDE, RIGHT_SIDE, MID_SIDE } mode = INDEP;
        if (ch_code <= 7) { nch = (int)ch_code + 1; }
        else if (ch_code == 8) { nch = 2; mode = LEFT_SIDE; }
        else if (ch_code == 9) { nch = 2; mode = RIGHT_SIDE; }
        else if (ch_code == 10) { nch = 2; mode = MID_SIDE; }
        else return ERR_MALFORMED;
        if (nch != si.channels) return ERR_MALFORMED;
        if (blocksize > 65535) return ERR_MALFORMED;

        // Header CRC-8 covers sync..crc byte exclusive.
        {
            uint8_t crc = 0;
            for (long long i = frame_start; i < br.byte_pos; ++i)
                crc = crc8_update(crc, data[i]);
            if (br.bit_pos != 0) return ERR_MALFORMED;  // header is byte-aligned
            uint8_t stored = (uint8_t)br.read_bits(8);
            if (br.overrun) return ERR_MALFORMED;
            if (crc != stored) return ERR_CRC;
        }

        for (int c = 0; c < nch; ++c) {
            int eff = bps;
            if ((mode == LEFT_SIDE && c == 1) || (mode == MID_SIDE && c == 1) ||
                (mode == RIGHT_SIDE && c == 0))
                eff += 1;
            int rc2 = decode_subframe(br, chan_buf[c], blocksize, eff);
            if (rc2 != 0) return rc2;
        }
        br.align_byte();
        // Frame CRC-16 covers everything from sync through the last subframe
        // byte (i.e. up to but excluding the crc16 itself).
        {
            uint16_t crc = 0;
            for (long long i = frame_start; i < br.byte_pos; ++i)
                crc = crc16_update(crc, data[i]);
            uint16_t stored = (uint16_t)br.read_bits(16);
            if (br.overrun) return ERR_MALFORMED;
            if (crc != stored) return ERR_CRC;
        }

        // Undo stereo decorrelation.
        if (mode == LEFT_SIDE) {
            for (int i = 0; i < blocksize; ++i)
                chan_buf[1][i] = chan_buf[0][i] - chan_buf[1][i];
        } else if (mode == RIGHT_SIDE) {
            for (int i = 0; i < blocksize; ++i)
                chan_buf[0][i] = chan_buf[1][i] + chan_buf[0][i];
        } else if (mode == MID_SIDE) {
            for (int i = 0; i < blocksize; ++i) {
                int64_t mid = chan_buf[0][i], side = chan_buf[1][i];
                mid = (mid << 1) | (side & 1);
                chan_buf[0][i] = (mid + side) >> 1;
                chan_buf[1][i] = (mid - side) >> 1;
            }
        }

        if ((written + blocksize) * nch > out_cap) return ERR_TOO_SMALL;
        for (int i = 0; i < blocksize; ++i)
            for (int c = 0; c < nch; ++c)
                out[(written + i) * nch + c] = (int32_t)chan_buf[c][i];
        written += blocksize;
        if (si.total_samples > 0 && written >= si.total_samples) break;
    }
    return written;
}

}  // extern "C"
