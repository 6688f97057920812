// Native host-side I/O runtime for sonar_3d_reconstruction_tpu.
//
// The accelerator owns all mapping compute; the host-side hot loops of bag replay —
// CDR deserialization of thousands of sensor_msgs/Image and
// nav_msgs/Odometry blobs, approximate time pairing, and PointCloud2 XYZI
// byte packing (the reference node's per-point struct.pack loop,
// scripts/3d_mapper_node.py:437-442) — run here, GIL-free, exposed to
// Python via ctypes (sonar_3d_reconstruction_tpu/io/native.py, which keeps
// a pure-Python fallback with identical semantics).
//
// CDR notes: XCDR1, alignment relative to byte 4 (after the encapsulation
// header); little- and big-endian representations supported (the reference
// sensors emit little-endian).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

#include <dlfcn.h>

namespace {

struct CdrReader {
    const uint8_t* buf;   // payload (after 4-byte encapsulation header)
    size_t len;
    size_t pos = 0;
    bool little = true;
    bool ok = true;

    CdrReader(const uint8_t* blob, size_t blob_len) {
        if (blob_len < 4) { buf = nullptr; len = 0; ok = false; return; }
        little = blob[1] == 0x01;
        buf = blob + 4;
        len = blob_len - 4;
    }

    void align(size_t size) {
        size_t rem = pos % size;
        if (rem) pos += size - rem;
    }

    bool have(size_t n) {
        if (pos + n > len) { ok = false; return false; }
        return true;
    }

    uint8_t u8() {
        if (!have(1)) return 0;
        return buf[pos++];
    }

    uint32_t u32() {
        align(4);
        if (!have(4)) return 0;
        uint32_t v;
        std::memcpy(&v, buf + pos, 4);
        pos += 4;
        if (!little) v = __builtin_bswap32(v);
        return v;
    }

    int32_t i32() { return static_cast<int32_t>(u32()); }

    double f64() {
        align(8);
        if (!have(8)) return 0.0;
        uint64_t v;
        std::memcpy(&v, buf + pos, 8);
        pos += 8;
        if (!little) v = __builtin_bswap64(v);
        double d;
        std::memcpy(&d, &v, 8);
        return d;
    }

    // CDR string: u32 length INCLUDING the null terminator, then bytes.
    // Copies up to cap-1 chars into out (null-terminated); returns length.
    uint32_t str(char* out, uint32_t cap) {
        uint32_t n = u32();
        if (!have(n)) return 0;
        uint32_t copy = n > 0 ? n - 1 : 0;
        if (out && cap) {
            uint32_t c = copy < cap - 1 ? copy : cap - 1;
            std::memcpy(out, buf + pos, c);
            out[c] = 0;
        }
        pos += n;
        return copy;
    }

    void skip_str() { str(nullptr, 0); }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Batch nav_msgs/Odometry decode.
//   blobs: concatenated CDR blobs; offsets: (n+1) byte offsets into blobs.
//   out_stamps (n,), out_positions (n,3), out_quaternions (n,4) xyzw.
// Returns number decoded, or -(1+index) of the first malformed blob.
// ---------------------------------------------------------------------------
int odometry_decode_batch(
    const uint8_t* blobs,
    const int64_t* offsets,
    int64_t n,
    double* out_stamps,
    double* out_positions,
    double* out_quaternions)
{
    for (int64_t i = 0; i < n; ++i) {
        CdrReader r(blobs + offsets[i],
                    static_cast<size_t>(offsets[i + 1] - offsets[i]));
        int32_t sec = r.i32();
        uint32_t nsec = r.u32();
        r.skip_str();  // header.frame_id
        r.skip_str();  // child_frame_id
        for (int k = 0; k < 3; ++k) out_positions[i * 3 + k] = r.f64();
        for (int k = 0; k < 4; ++k) out_quaternions[i * 4 + k] = r.f64();
        if (!r.ok) return -static_cast<int>(i) - 1;
        out_stamps[i] = static_cast<double>(sec) + 1e-9 * nsec;
    }
    return static_cast<int>(n);
}

// ---------------------------------------------------------------------------
// Batch sensor_msgs/Image decode into a dense (n, height, width) uint8 block.
//   Every image must match the given height/width and be mono8 or mono16
//   (mono16 is scaled /256 to uint8 exactly like the reference,
//   scripts/3d_mapper_node.py:308-310).
//   out_stamps (n,), out_images (n*height*width,).
// Returns number decoded, or -(1+index) of the first mismatched/malformed blob.
// ---------------------------------------------------------------------------
int image_decode_batch(
    const uint8_t* blobs,
    const int64_t* offsets,
    int64_t n,
    int32_t height,
    int32_t width,
    double* out_stamps,
    uint8_t* out_images)
{
    const size_t hw = static_cast<size_t>(height) * width;
    for (int64_t i = 0; i < n; ++i) {
        CdrReader r(blobs + offsets[i],
                    static_cast<size_t>(offsets[i + 1] - offsets[i]));
        int32_t sec = r.i32();
        uint32_t nsec = r.u32();
        r.skip_str();  // frame_id
        uint32_t h = r.u32();
        uint32_t w = r.u32();
        char enc[32];
        r.str(enc, sizeof enc);
        uint8_t bigendian = r.u8();
        uint32_t step = r.u32();
        uint32_t data_len = r.u32();
        if (!r.ok || h != static_cast<uint32_t>(height) ||
            w != static_cast<uint32_t>(width) || !r.have(data_len))
            return -static_cast<int>(i) - 1;

        const uint8_t* data = r.buf + r.pos;
        uint8_t* dst = out_images + i * hw;
        bool mono8 = !std::strcmp(enc, "mono8") || !std::strcmp(enc, "8UC1");
        bool mono16 = !std::strcmp(enc, "mono16") || !std::strcmp(enc, "16UC1");
        if (!mono8 && !mono16) return -static_cast<int>(i) - 1;
        uint32_t pix = mono16 ? 2 : 1;
        if (step < w * pix) step = w * pix;  // tolerate under-reported step
        if (static_cast<uint64_t>(step) * h > data_len &&
            static_cast<uint64_t>(w) * pix * h <= data_len)
            step = w * pix;  // padded-step blobs that report row bytes
        if (static_cast<uint64_t>(step) * (h - 1) + w * pix > data_len)
            return -static_cast<int>(i) - 1;

        if (mono8) {
            for (uint32_t row = 0; row < h; ++row)
                std::memcpy(dst + row * w, data + row * step, w);
        } else {
            for (uint32_t row = 0; row < h; ++row) {
                const uint8_t* src = data + row * step;
                for (uint32_t col = 0; col < w; ++col) {
                    uint16_t v;
                    std::memcpy(&v, src + col * 2, 2);
                    if (bigendian) v = static_cast<uint16_t>((v >> 8) | (v << 8));
                    dst[row * w + col] = static_cast<uint8_t>(v / 256);
                }
            }
        }
        out_stamps[i] = static_cast<double>(sec) + 1e-9 * nsec;
    }
    return static_cast<int>(n);
}

// ---------------------------------------------------------------------------
// Offline approximate time pairing — line-faithful simulation of ROS2
// message_filters ApproximateTimeSynchronizer for two topics (identical
// policy to io/timesync.pair_streams): both sorted streams are fed in
// merged stamp order (pose first on ties); per-topic queues are
// stamp-keyed and arrival-ordered, an equal stamp overwrites, and the
// smallest stamp is evicted when a queue exceeds queue_size.  An arrival
// pairs with the other queue's minimum-|delta| entry (ties -> earliest
// arrival) iff that delta is STRICTLY below slop; both entries then leave
// their queues.  out_pairs is (n_ping * 2) int64 (ping, pose) in emission
// order; returns the number of pairs.
// ---------------------------------------------------------------------------
int64_t pair_streams(
    const double* ping_stamps, int64_t n_ping,
    const double* pose_stamps, int64_t n_pose,
    double slop, int64_t queue_size,
    int64_t* out_pairs)
{
    struct Entry { double t; int64_t idx; };
    std::vector<Entry> queues[2];  // [0] ping, [1] pose; arrival order
    int64_t n_pairs = 0;
    int64_t ip = 0, iq = 0;
    while (ip < n_ping || iq < n_pose) {
        int which;
        if (iq < n_pose && (ip >= n_ping || pose_stamps[iq] <= ping_stamps[ip]))
            which = 1;
        else
            which = 0;
        double t;
        int64_t idx;
        if (which == 1) { t = pose_stamps[iq]; idx = iq; ++iq; }
        else           { t = ping_stamps[ip]; idx = ip; ++ip; }

        std::vector<Entry>& mine = queues[which];
        bool replaced = false;
        for (Entry& e : mine)
            if (e.t == t) { e.idx = idx; replaced = true; break; }
        if (!replaced) mine.push_back({t, idx});
        while (static_cast<int64_t>(mine.size()) > queue_size) {
            size_t mi = 0;
            for (size_t k = 1; k < mine.size(); ++k)
                if (mine[k].t < mine[mi].t) mi = k;
            mine.erase(mine.begin() + mi);
        }

        std::vector<Entry>& other = queues[1 - which];
        if (other.empty()) continue;
        size_t best = 0;
        double best_d = std::fabs(other[0].t - t);
        for (size_t k = 1; k < other.size(); ++k) {
            double d = std::fabs(other[k].t - t);
            if (d < best_d) { best = k; best_d = d; }  // strict: ties keep
        }                                              // earliest arrival
        if (best_d < slop) {
            int64_t ping_i = which == 0 ? idx : other[best].idx;
            int64_t pose_i = which == 0 ? other[best].idx : idx;
            out_pairs[n_pairs * 2] = ping_i;
            out_pairs[n_pairs * 2 + 1] = pose_i;
            ++n_pairs;
            other.erase(other.begin() + best);
            for (size_t k = 0; k < mine.size(); ++k)
                if (mine[k].t == t) { mine.erase(mine.begin() + k); break; }
        }
    }
    return n_pairs;
}

// ---------------------------------------------------------------------------
// PointCloud2 XYZI float32 packing (reference node:437-442 layout).
// ---------------------------------------------------------------------------
void pack_xyzi(
    const double* points,        // (n, 3)
    const double* intensities,   // (n,)
    int64_t n,
    float* out)                  // (n, 4)
{
    for (int64_t i = 0; i < n; ++i) {
        out[i * 4 + 0] = static_cast<float>(points[i * 3 + 0]);
        out[i * 4 + 1] = static_cast<float>(points[i * 3 + 1]);
        out[i * 4 + 2] = static_cast<float>(points[i * 3 + 2]);
        out[i * 4 + 3] = static_cast<float>(intensities[i]);
    }
}

// ---------------------------------------------------------------------------
// mcap chunk codecs (zstd / lz4-frame), resolved from the system shared
// libraries at first use via dlopen — no build-time dependency, graceful
// absence (the pure-Python reader falls back to the optional zstandard/lz4
// modules and only errors when neither path exists).  rosbag2's mcap writer
// defaults to zstd chunks: this makes real field
// recordings replayable with zero extra Python deps.
// ---------------------------------------------------------------------------

namespace {

// minimal local prototypes for the two codec ABIs (stable since zstd 1.0 /
// lz4 1.8); declared here so no dev headers are required at build time
typedef size_t (*zstd_decompress_fn)(void*, size_t, const void*, size_t);
typedef size_t (*zstd_compress_fn)(void*, size_t, const void*, size_t, int);
typedef size_t (*zstd_bound_fn)(size_t);
typedef unsigned (*zstd_iserror_fn)(size_t);

struct LZ4F_dctx_opaque;
typedef size_t (*lz4f_create_dctx_fn)(LZ4F_dctx_opaque**, unsigned);
typedef size_t (*lz4f_free_dctx_fn)(LZ4F_dctx_opaque*);
typedef size_t (*lz4f_decompress_fn)(
    LZ4F_dctx_opaque*, void*, size_t*, const void*, size_t*, const void*);
typedef size_t (*lz4f_compress_frame_fn)(
    void*, size_t, const void*, size_t, const void*);
typedef size_t (*lz4f_compress_bound_fn)(size_t, const void*);
typedef unsigned (*lz4f_iserror_fn)(size_t);

constexpr unsigned kLz4fVersion = 100;

struct ZstdApi {
    zstd_decompress_fn decompress = nullptr;
    zstd_compress_fn compress = nullptr;
    zstd_bound_fn compress_bound = nullptr;
    zstd_iserror_fn is_error = nullptr;
    bool ok = false;
};

struct Lz4Api {
    lz4f_create_dctx_fn create_dctx = nullptr;
    lz4f_free_dctx_fn free_dctx = nullptr;
    lz4f_decompress_fn decompress = nullptr;
    lz4f_compress_frame_fn compress_frame = nullptr;
    lz4f_compress_bound_fn compress_bound = nullptr;
    lz4f_iserror_fn is_error = nullptr;
    bool ok = false;
};

// RTLD_LOCAL is load-bearing: the process ALSO hosts Python's
// zstandard.backend_c extension (jax's compilation cache compresses with
// it), and injecting a different libzstd's symbols into the global
// namespace (RTLD_GLOBAL) lets lazy binding interpose mismatched-ABI
// symbols into that extension — observed as nondeterministic segfaults
// inside the jax cache's (de)serialization late in long test runs.  All
// access here is via dlsym on the handle, so LOCAL costs nothing.
void* dlopen_any(const char* a, const char* b) {
    void* h = dlopen(a, RTLD_NOW | RTLD_LOCAL);
    return h ? h : dlopen(b, RTLD_NOW | RTLD_LOCAL);
}

const ZstdApi& zstd_api() {
    static ZstdApi api = [] {
        ZstdApi a;
        void* h = dlopen_any("libzstd.so.1", "libzstd.so");
        if (!h) return a;
        a.decompress =
            reinterpret_cast<zstd_decompress_fn>(dlsym(h, "ZSTD_decompress"));
        a.compress =
            reinterpret_cast<zstd_compress_fn>(dlsym(h, "ZSTD_compress"));
        a.compress_bound =
            reinterpret_cast<zstd_bound_fn>(dlsym(h, "ZSTD_compressBound"));
        a.is_error =
            reinterpret_cast<zstd_iserror_fn>(dlsym(h, "ZSTD_isError"));
        a.ok = a.decompress && a.compress && a.compress_bound && a.is_error;
        return a;
    }();
    return api;
}

const Lz4Api& lz4_api() {
    static Lz4Api api = [] {
        Lz4Api a;
        void* h = dlopen_any("liblz4.so.1", "liblz4.so");
        if (!h) return a;
        a.create_dctx = reinterpret_cast<lz4f_create_dctx_fn>(
            dlsym(h, "LZ4F_createDecompressionContext"));
        a.free_dctx = reinterpret_cast<lz4f_free_dctx_fn>(
            dlsym(h, "LZ4F_freeDecompressionContext"));
        a.decompress =
            reinterpret_cast<lz4f_decompress_fn>(dlsym(h, "LZ4F_decompress"));
        a.compress_frame = reinterpret_cast<lz4f_compress_frame_fn>(
            dlsym(h, "LZ4F_compressFrame"));
        a.compress_bound = reinterpret_cast<lz4f_compress_bound_fn>(
            dlsym(h, "LZ4F_compressFrameBound"));
        a.is_error =
            reinterpret_cast<lz4f_iserror_fn>(dlsym(h, "LZ4F_isError"));
        a.ok = a.create_dctx && a.free_dctx && a.decompress &&
               a.compress_frame && a.compress_bound && a.is_error;
        return a;
    }();
    return api;
}

}  // namespace

// codec: 0 = zstd, 1 = lz4 (frame format — what mcap chunks contain)
int s3d_codec_available(int codec) {
    if (codec == 0) return zstd_api().ok ? 1 : 0;
    if (codec == 1) return lz4_api().ok ? 1 : 0;
    return 0;
}

// Decompress src into dst (dst_len = the chunk record's uncompressed_size).
// Returns bytes written, or -1 (codec unavailable) / -2 (corrupt stream or
// size mismatch).
int64_t s3d_decompress(
    int codec,
    const uint8_t* src, int64_t src_len,
    uint8_t* dst, int64_t dst_len)
{
    if (codec == 0) {
        const ZstdApi& z = zstd_api();
        if (!z.ok) return -1;
        size_t r = z.decompress(dst, static_cast<size_t>(dst_len),
                                src, static_cast<size_t>(src_len));
        if (z.is_error(r)) return -2;
        return static_cast<int64_t>(r);
    }
    if (codec == 1) {
        const Lz4Api& l = lz4_api();
        if (!l.ok) return -1;
        LZ4F_dctx_opaque* ctx = nullptr;
        if (l.is_error(l.create_dctx(&ctx, kLz4fVersion))) return -2;
        size_t src_pos = 0, dst_pos = 0;
        int64_t rc = -2;
        for (;;) {
            size_t dst_avail = static_cast<size_t>(dst_len) - dst_pos;
            size_t src_avail = static_cast<size_t>(src_len) - src_pos;
            size_t hint = l.decompress(ctx, dst + dst_pos, &dst_avail,
                                       src + src_pos, &src_avail, nullptr);
            if (l.is_error(hint)) break;
            dst_pos += dst_avail;
            src_pos += src_avail;
            if (hint == 0) { rc = static_cast<int64_t>(dst_pos); break; }
            if (src_pos >= static_cast<size_t>(src_len) ||
                dst_pos >= static_cast<size_t>(dst_len)) {
                // frame not finished but an input/output buffer is exhausted:
                // truncated stream or under-reported uncompressed_size
                break;
            }
        }
        l.free_dctx(ctx);
        return rc;
    }
    return -1;
}

// Upper bound on s3d_compress output for src_len input (for buffer sizing).
int64_t s3d_compress_bound(int codec, int64_t src_len) {
    if (codec == 0 && zstd_api().ok)
        return static_cast<int64_t>(
            zstd_api().compress_bound(static_cast<size_t>(src_len)));
    if (codec == 1 && lz4_api().ok)
        return static_cast<int64_t>(lz4_api().compress_bound(
            static_cast<size_t>(src_len), nullptr));
    return -1;
}

// Compress src into dst (capacity dst_cap >= s3d_compress_bound).  Returns
// bytes written, or -1 (codec unavailable) / -2 (error).  Used by the mcap
// writer to emit compressed-chunk fixtures that exercise the reader path.
int64_t s3d_compress(
    int codec,
    const uint8_t* src, int64_t src_len,
    uint8_t* dst, int64_t dst_cap)
{
    if (codec == 0) {
        const ZstdApi& z = zstd_api();
        if (!z.ok) return -1;
        size_t r = z.compress(dst, static_cast<size_t>(dst_cap),
                              src, static_cast<size_t>(src_len), 3);
        if (z.is_error(r)) return -2;
        return static_cast<int64_t>(r);
    }
    if (codec == 1) {
        const Lz4Api& l = lz4_api();
        if (!l.ok) return -1;
        size_t r = l.compress_frame(dst, static_cast<size_t>(dst_cap),
                                    src, static_cast<size_t>(src_len),
                                    nullptr);
        if (l.is_error(r)) return -2;
        return static_cast<int64_t>(r);
    }
    return -1;
}

int sonar3d_native_abi_version() { return 3; }

}  // extern "C"
