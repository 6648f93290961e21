// Batched gzipped-FITS stamp decoder (the port's copy of
// applecider_tpu/native/fits_decoder.cpp).
//
// The host-side hot path of raw-alert serving: every ZTF alert carries three
// gzipped FITS cutouts (science, template, difference). This decoder gunzips
// and parses a whole list of them in C++ on a pool of threads, called from
// Python through ctypes (applecider_tpu_torch/native/__init__.py), which
// releases the GIL for the call. Semantics are those of
// applecider_tpu_torch.preprocessing.fitsio.read_fits_image: primary HDU
// only, BITPIX in {8, 16, 32, 64, -32, -64}, big-endian data, BSCALE/BZERO
// applied in float32 as NumPy applies them to the float32 pixels.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off fits_decoder.cpp
//        -o libacfits.so -lz -lpthread
// With libdeflate (its gzip decode is 2-3x zlib's, and inflating is most of
// a stamp's decode): add -DACFITS_HAVE_LIBDEFLATE -ldeflate. The Python
// loader probes for libdeflate first and builds exactly one variant.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <thread>
#include <vector>

#include <zlib.h>

#ifdef ACFITS_HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

constexpr int kBlock = 2880;
constexpr int kCard = 80;

#ifdef ACFITS_HAVE_LIBDEFLATE
// One-shot gzip decode sized from the trailer's ISIZE field (uncompressed
// length mod 2^32 — exact for any stamp under 4 GB); grows and retries on
// the pathological wrap case instead of trusting it blindly.
bool gunzip_libdeflate(libdeflate_decompressor* d, const uint8_t* src,
                       size_t src_len, std::vector<uint8_t>& out) {
    if (src_len < 18) return false;
    size_t isize = (size_t)src[src_len - 4] | ((size_t)src[src_len - 3] << 8) |
                   ((size_t)src[src_len - 2] << 16) | ((size_t)src[src_len - 1] << 24);
    size_t cap = isize ? isize : src_len * 4 + 64;
    for (int attempt = 0; attempt < 3; ++attempt) {
        out.resize(cap);
        size_t actual = 0;
        libdeflate_result r =
            libdeflate_gzip_decompress(d, src, src_len, out.data(), cap, &actual);
        if (r == LIBDEFLATE_SUCCESS) {
            out.resize(actual);
            return true;
        }
        if (r == LIBDEFLATE_INSUFFICIENT_SPACE) {
            cap = cap * 4 + 64;
            continue;
        }
        return false;
    }
    return false;
}
#endif

bool gunzip(const uint8_t* src, size_t src_len, std::vector<uint8_t>& out) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) return false;
    zs.next_in = const_cast<Bytef*>(src);
    zs.avail_in = static_cast<uInt>(src_len);
    out.clear();
    out.reserve(src_len * 4);
    uint8_t buf[1 << 15];
    int ret = Z_OK;
    do {
        zs.next_out = buf;
        zs.avail_out = sizeof(buf);
        ret = inflate(&zs, Z_NO_FLUSH);
        if (ret != Z_OK && ret != Z_STREAM_END) { inflateEnd(&zs); return false; }
        out.insert(out.end(), buf, buf + (sizeof(buf) - zs.avail_out));
    } while (ret != Z_STREAM_END);
    inflateEnd(&zs);
    return true;
}

struct Header {
    int bitpix = 0;
    int naxis = 0;
    long axes[4] = {0, 0, 0, 0};
    double bscale = 1.0;
    double bzero = 0.0;
    size_t data_offset = 0;
};

bool parse_int(const char* value, long* out) {
    char* end = nullptr;
    long v = std::strtol(value, &end, 10);
    if (end == value) return false;
    *out = v;
    return true;
}

bool parse_header(const uint8_t* buf, size_t len, Header* h) {
    if (len < kBlock || std::memcmp(buf, "SIMPLE", 6) != 0) return false;
    size_t offset = 0;
    bool done = false;
    while (!done) {
        if (offset + kBlock > len) return false;
        for (int i = 0; i < kBlock; i += kCard) {
            const char* card = reinterpret_cast<const char*>(buf + offset + i);
            if (std::memcmp(card, "END", 3) == 0 &&
                (card[3] == ' ' || card[3] == '\0')) {
                done = true;
                break;
            }
            if (card[8] != '=' || card[9] != ' ') continue;
            char key[9];
            std::memcpy(key, card, 8);
            key[8] = '\0';
            for (int k = 7; k >= 0 && key[k] == ' '; --k) key[k] = '\0';
            char value[71];
            std::memcpy(value, card + 10, 70);
            value[70] = '\0';
            long iv;
            if (std::strcmp(key, "BITPIX") == 0 && parse_int(value, &iv)) h->bitpix = (int)iv;
            else if (std::strcmp(key, "NAXIS") == 0 && parse_int(value, &iv)) h->naxis = (int)iv;
            else if (std::strncmp(key, "NAXIS", 5) == 0 && key[5] >= '1' && key[5] <= '4') {
                if (parse_int(value, &iv)) h->axes[key[5] - '1'] = iv;
            } else if (std::strcmp(key, "BSCALE") == 0) h->bscale = std::atof(value);
            else if (std::strcmp(key, "BZERO") == 0) h->bzero = std::atof(value);
        }
        offset += kBlock;
    }
    h->data_offset = offset;
    return h->naxis >= 1 && h->naxis <= 4;
}

inline uint16_t be16(const uint8_t* p) { return (uint16_t(p[0]) << 8) | p[1]; }
inline uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}
inline uint64_t be64(const uint8_t* p) {
    return (uint64_t(be32(p)) << 32) | be32(p + 4);
}

// Decode one FITS buffer into out[n_pix]; returns pixel count or -1.
long decode_fits(const uint8_t* buf, size_t len, float* out, long max_pix) {
    Header h;
    if (!parse_header(buf, len, &h)) return -1;
    long n = 1;
    for (int i = 0; i < h.naxis; ++i) {
        if (h.axes[i] <= 0) return -1;
        n *= h.axes[i];
    }
    if (n > max_pix) return -1;
    const uint8_t* d = buf + h.data_offset;
    size_t avail = len - h.data_offset;
    const bool scaled = h.bscale != 1.0 || h.bzero != 0.0;
    switch (h.bitpix) {
        case 8:
            if (avail < (size_t)n) return -1;
            for (long i = 0; i < n; ++i) out[i] = (float)d[i];
            break;
        case 16:
            if (avail < (size_t)n * 2) return -1;
            for (long i = 0; i < n; ++i) out[i] = (float)(int16_t)be16(d + 2 * i);
            break;
        case 32:
            if (avail < (size_t)n * 4) return -1;
            for (long i = 0; i < n; ++i) out[i] = (float)(int32_t)be32(d + 4 * i);
            break;
        case 64:
            if (avail < (size_t)n * 8) return -1;
            for (long i = 0; i < n; ++i) out[i] = (float)(int64_t)be64(d + 8 * i);
            break;
        case -32:
            if (avail < (size_t)n * 4) return -1;
            // word loads + bswap32 auto-vectorize (pshufb); the per-byte
            // shift/or form does not — this is the common ZTF stamp dtype
            for (long i = 0; i < n; ++i) {
                uint32_t bits;
                std::memcpy(&bits, d + 4 * i, 4);
                bits = __builtin_bswap32(bits);
                float f;
                std::memcpy(&f, &bits, 4);
                out[i] = f;
            }
            break;
        case -64:
            if (avail < (size_t)n * 8) return -1;
            for (long i = 0; i < n; ++i) {
                uint64_t bits = be64(d + 8 * i);
                double f;
                std::memcpy(&f, &bits, 8);
                out[i] = (float)f;
            }
            break;
        default:
            return -1;
    }
    if (scaled) {
        // NumPy's float32 array * Python float rounds the scalar to float32
        // and each operation to float32 (no fused multiply-add: built with
        // -ffp-contract=off)
        const float s = (float)h.bscale, z = (float)h.bzero;
        for (long i = 0; i < n; ++i) out[i] = out[i] * s + z;
    }
    return n;
}

}  // namespace

extern "C" {

// Decode n stamps (possibly gzipped FITS) into out[n * max_pix].
// sizes_ok[i] receives the pixel count (or 0 on failure).
// Returns the number of successfully decoded stamps.
int acfits_decode_batch(
    const uint8_t** blobs,
    const int64_t* blob_sizes,
    int n,
    float* out,
    int64_t max_pix,
    int64_t* pix_counts,
    int n_threads) {
    std::atomic<int> ok_count{0};
    std::atomic<int> next{0};
    if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads > n) n_threads = n > 0 ? n : 1;

    auto worker = [&]() {
        std::vector<uint8_t> scratch;
#ifdef ACFITS_HAVE_LIBDEFLATE
        libdeflate_decompressor* ld = libdeflate_alloc_decompressor();
#endif
        while (true) {
            int i = next.fetch_add(1);
            if (i >= n) break;
            const uint8_t* buf = blobs[i];
            size_t len = (size_t)blob_sizes[i];
            float* dst = out + (int64_t)i * max_pix;
            pix_counts[i] = 0;
            const uint8_t* fits_buf = buf;
            size_t fits_len = len;
            if (len >= 2 && buf[0] == 0x1f && buf[1] == 0x8b) {
#ifdef ACFITS_HAVE_LIBDEFLATE
                bool ok = ld != nullptr && gunzip_libdeflate(ld, buf, len, scratch);
                if (!ok) ok = gunzip(buf, len, scratch);  // zlib fallback
                if (!ok) continue;
#else
                if (!gunzip(buf, len, scratch)) continue;
#endif
                fits_buf = scratch.data();
                fits_len = scratch.size();
            }
            long got = decode_fits(fits_buf, fits_len, dst, max_pix);
            if (got > 0) {
                pix_counts[i] = got;
                ok_count.fetch_add(1);
            }
        }
#ifdef ACFITS_HAVE_LIBDEFLATE
        if (ld != nullptr) libdeflate_free_decompressor(ld);
#endif
    };

    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
    return ok_count.load();
}

}  // extern "C"
