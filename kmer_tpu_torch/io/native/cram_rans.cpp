// rANS 4x8 decoder (CRAM 3.0 block codec 4) — native form of the
// Python decoder in io/cram.py (the per-byte state walk is
// the one CRAM codec that is genuinely compute-bound on the host).
// Stream layout per htslib's rANS_static.c: order byte, u32 compressed
// size, u32 uncompressed size, frequency table(s), four interleaved
// little-endian rANS states renormalizing one byte at a time.
//
// Returns 0 on success, <0 on malformed input (caller falls back to
// the Python decoder, which raises a descriptive error).

// A copy of kmer_tpu/io/native/cram_rans.cpp, so that the port imports
// and builds nothing of the JAX package.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t RANS_LOW = 1u << 23;
constexpr int TF_SHIFT = 12;
constexpr uint32_t TF_MASK = (1u << TF_SHIFT) - 1;

struct Freqs {
    uint16_t freq[256];
    uint16_t cum[257];
    uint8_t lut[1 << TF_SHIFT];  // slot -> symbol

    // false when the table does not cover the 4096 slots (corrupt /
    // truncated block): decoding through uncovered lut slots would
    // read uninitialized stack/thread-local memory and "succeed"
    bool finish() {
        cum[0] = 0;
        for (int i = 0; i < 256; ++i) cum[i + 1] = cum[i] + freq[i];
        if (cum[256] != (1u << TF_SHIFT)) return false;
        for (int s = 0; s < 256; ++s)
            for (uint32_t j = cum[s]; j < cum[s + 1u]; ++j)
                lut[j] = (uint8_t)s;
        return true;
    }
};

struct Cur {
    const uint8_t *p, *end;
    bool ok = true;
    uint8_t u8() {
        if (p >= end) { ok = false; return 0; }
        return *p++;
    }
    uint32_t u32() {
        if (p + 4 > end) { ok = false; return 0; }
        uint32_t v;
        std::memcpy(&v, p, 4);
        p += 4;
        return v;
    }
};

// one frequency table in the rANS_static.c byte format (see the Python
// twin for the walk semantics)
static bool read_freqs(Cur &c, Freqs &f) {
    std::memset(f.freq, 0, sizeof f.freq);
    int j = c.u8();
    int rle = 0;
    while (c.ok) {
        uint32_t fr = c.u8();
        if (fr >= 128) fr = ((fr & 127) << 8) | c.u8();
        if (j < 0 || j > 255) return false;
        f.freq[j] = (uint16_t)fr;
        if (rle) {
            --rle;
            ++j;
        } else if (c.p < c.end && *c.p == j + 1) {
            j = c.u8();
            rle = c.u8();
        } else {
            j = c.u8();
        }
        if (j == 0) break;
    }
    if (!c.ok) return false;
    return f.finish();
}

static inline void advance(uint32_t &x, const Freqs &f, uint8_t s,
                           uint32_t slot, Cur &c) {
    x = f.freq[s] * (x >> TF_SHIFT) + slot - f.cum[s];
    while (x < RANS_LOW && c.p < c.end) x = (x << 8) | *c.p++;
}

}  // namespace

extern "C" int ktp_rans_decode(const uint8_t *in, int64_t in_len,
                               uint8_t *out, int64_t out_len) {
    Cur c{in, in + in_len};
    int order = c.u8();
    c.u32();  // compressed size
    c.u32();  // uncompressed size (trusted from the CRAM block header)
    if (!c.ok) return -1;

    if (order == 0) {
        Freqs f;
        if (!read_freqs(c, f)) return -2;
        uint32_t R[4];
        for (auto &r : R) r = c.u32();
        if (!c.ok) return -1;
        int64_t main = out_len & ~3ll;
        for (int64_t i = 0; i < main; i += 4) {
            for (int j = 0; j < 4; ++j) {
                uint32_t slot = R[j] & TF_MASK;
                uint8_t s = f.lut[slot];
                out[i + j] = s;
                advance(R[j], f, s, slot, c);
            }
        }
        for (int j = 0; j < (out_len & 3); ++j)  // tail: lookup only
            out[main + j] = f.lut[R[j] & TF_MASK];
        return 0;
    }

    if (order == 1) {
        static thread_local Freqs ctx[256];  // 1.25 MB: too big for stack
        bool seen[256] = {};
        int i_sym = c.u8();
        int rle_i = 0;
        while (c.ok) {
            if (i_sym < 0 || i_sym > 255) return -2;
            if (!read_freqs(c, ctx[i_sym])) return -2;
            seen[i_sym] = true;
            if (rle_i) {
                --rle_i;
                ++i_sym;
            } else if (c.p < c.end && *c.p == i_sym + 1) {
                i_sym = c.u8();
                rle_i = c.u8();
            } else {
                i_sym = c.u8();
            }
            if (i_sym == 0) break;
        }
        if (!c.ok) return -1;
        uint32_t R[4];
        for (auto &r : R) r = c.u32();
        if (!c.ok) return -1;
        int64_t q = out_len >> 2;
        int64_t ptr[4] = {0, q, 2 * q, 3 * q};
        uint8_t last[4] = {0, 0, 0, 0};
        for (int64_t i = 0; i < q; ++i) {
            for (int j = 0; j < 4; ++j) {
                const Freqs &f = ctx[last[j]];
                if (!seen[last[j]]) return -3;
                uint32_t slot = R[j] & TF_MASK;
                uint8_t s = f.lut[slot];
                out[ptr[j] + i] = s;
                advance(R[j], f, s, slot, c);
                last[j] = s;
            }
        }
        for (int64_t i = 4 * q; i < out_len; ++i) {  // tail on stream 3
            const Freqs &f = ctx[last[3]];
            if (!seen[last[3]]) return -3;
            uint32_t slot = R[3] & TF_MASK;
            uint8_t s = f.lut[slot];
            out[i] = s;
            advance(R[3], f, s, slot, c);
            last[3] = s;
        }
        return 0;
    }
    return -4;  // unknown order
}
