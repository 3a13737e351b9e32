// Native runtime hot paths: translog append/fsync + varint postings codec.
//
// The reference keeps its write-ahead-log framing and postings codecs on
// the JVM's intrinsified paths (Translog.java:606 buffered channel writes,
// Lucene's PForDelta/varint postings). Here the same two hot loops live in
// C++ behind a C ABI consumed via ctypes (no pybind11 in this image):
//
//   - tlog_*: buffered, CRC-framed appends ([u32 len][u32 crc32][payload])
//     with explicit fsync. The record format matches the Python
//     implementation byte-for-byte (zlib CRC-32), so files written natively
//     are read by the Python recovery path and vice versa.
//   - varint_*: zigzag-delta varint encode/decode for int32 id columns
//     (postings doc ids, IVF list ids): per-term ascending runs compress to
//     ~1 byte/doc; term-boundary resets produce negative deltas, which
//     zigzag handles without a per-term offset table.
//
// Build: g++ -O2 -shared -fPIC (see build.py); loaded lazily, with a pure
// Python fallback when no toolchain is present.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <unistd.h>

namespace {

// ---- zlib-compatible CRC-32 (reflected, poly 0xEDB88320) ----------------

uint32_t crc_table[256];
bool crc_ready = false;

void crc_init() {
    for (uint32_t n = 0; n < 256; n++) {
        uint32_t c = n;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[n] = c;
    }
    crc_ready = true;
}

uint32_t crc32_update(uint32_t crc, const uint8_t* buf, size_t len) {
    if (!crc_ready) crc_init();
    crc ^= 0xFFFFFFFFu;
    for (size_t i = 0; i < len; i++)
        crc = crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

// ---- buffered translog writer -------------------------------------------

constexpr size_t kBufCap = 1 << 16;

struct TlogWriter {
    int fd = -1;
    uint64_t offset = 0;       // logical file offset incl. buffered bytes
    size_t buf_len = 0;
    uint8_t buf[kBufCap];
};

// Flush as much as possible; on failure the UNWRITTEN bytes are retained
// at the front of the buffer (memmove), so a later retry continues exactly
// where the file left off — no byte is ever written twice.
int flush_buf(TlogWriter* w) {
    size_t done = 0;
    while (done < w->buf_len) {
        ssize_t n = ::write(w->fd, w->buf + done, w->buf_len - done);
        if (n < 0) {
            if (errno == EINTR) continue;
            if (done > 0)
                std::memmove(w->buf, w->buf + done, w->buf_len - done);
            w->buf_len -= done;
            return -1;
        }
        done += static_cast<size_t>(n);
    }
    w->buf_len = 0;
    return 0;
}

}  // namespace

extern "C" {

uint32_t osn_crc32(const uint8_t* data, uint64_t len) {
    return crc32_update(0, data, static_cast<size_t>(len));
}

// Opens (creating if needed) for append, truncated to `offset` — a crash
// may have left unsynced garbage past the last checkpoint.
void* tlog_open(const char* path, uint64_t offset) {
    int fd = ::open(path, O_RDWR | O_CREAT, 0644);
    if (fd < 0) return nullptr;
    if (::ftruncate(fd, static_cast<off_t>(offset)) != 0 ||
        ::lseek(fd, static_cast<off_t>(offset), SEEK_SET) < 0) {
        ::close(fd);
        return nullptr;
    }
    auto* w = new TlogWriter();
    w->fd = fd;
    w->offset = offset;
    return w;
}

// Frames and appends one payload; returns the record's start offset, or -1.
// Atomic w.r.t. logical state: on failure the record is NOT buffered and
// `offset` is unchanged, so callers may retry the append safely. Records
// only enter the buffer whole; flushes happen either at record boundaries
// or as complete direct writes, so transient partial file tails are always
// continued by the retained buffer, never duplicated.
int64_t tlog_append(void* handle, const uint8_t* payload, uint32_t len) {
    auto* w = static_cast<TlogWriter*>(handle);
    const int64_t location = static_cast<int64_t>(w->offset);
    uint8_t header[8];
    const uint32_t crc = crc32_update(0, payload, len);
    std::memcpy(header, &len, 4);        // little-endian hosts only (x86/ARM)
    std::memcpy(header + 4, &crc, 4);
    const size_t needed = sizeof(header) + len;
    if (w->buf_len + needed > kBufCap) {
        // make room BEFORE buffering any record byte
        if (flush_buf(w) != 0) return -1;
    }
    if (needed > kBufCap) {
        // oversized record: direct write (buffer is empty here); roll the
        // file back to the logical offset if it cannot complete
        const uint8_t* chunks[2] = {header, payload};
        const size_t sizes[2] = {sizeof(header), len};
        for (int i = 0; i < 2; i++) {
            const uint8_t* src = chunks[i];
            size_t remaining = sizes[i];
            while (remaining > 0) {
                ssize_t n = ::write(w->fd, src, remaining);
                if (n < 0) {
                    if (errno == EINTR) continue;
                    ::ftruncate(w->fd, static_cast<off_t>(w->offset));
                    ::lseek(w->fd, static_cast<off_t>(w->offset), SEEK_SET);
                    return -1;
                }
                src += n;
                remaining -= static_cast<size_t>(n);
            }
        }
    } else {
        std::memcpy(w->buf + w->buf_len, header, sizeof(header));
        std::memcpy(w->buf + w->buf_len + sizeof(header), payload, len);
        w->buf_len += needed;
    }
    w->offset += needed;
    return location;
}

uint64_t tlog_tell(void* handle) {
    return static_cast<TlogWriter*>(handle)->offset;
}

// Flush the user-space buffer and fsync to stable storage. 0 on success.
int tlog_sync(void* handle) {
    auto* w = static_cast<TlogWriter*>(handle);
    if (flush_buf(w) != 0) return -1;
    return ::fsync(w->fd);
}

void tlog_close(void* handle) {
    auto* w = static_cast<TlogWriter*>(handle);
    flush_buf(w);
    ::close(w->fd);
    delete w;
}

// ---- zigzag-delta varint codec ------------------------------------------

// returns bytes written, or -1 if `cap` too small
int64_t varint_encode(const int32_t* values, int64_t n, uint8_t* out,
                      int64_t cap) {
    int64_t pos = 0;
    int64_t prev = 0;
    for (int64_t i = 0; i < n; i++) {
        const int64_t delta = static_cast<int64_t>(values[i]) - prev;
        prev = values[i];
        uint64_t z = (static_cast<uint64_t>(delta) << 1) ^
                     static_cast<uint64_t>(delta >> 63);
        do {
            if (pos >= cap) return -1;
            uint8_t byte = z & 0x7F;
            z >>= 7;
            out[pos++] = byte | (z ? 0x80 : 0);
        } while (z);
    }
    return pos;
}

// returns values decoded, or -1 on malformed input / cap overflow
int64_t varint_decode(const uint8_t* in, int64_t nbytes, int32_t* out,
                      int64_t cap) {
    int64_t pos = 0;
    int64_t count = 0;
    int64_t prev = 0;
    while (pos < nbytes) {
        uint64_t z = 0;
        int shift = 0;
        while (true) {
            if (pos >= nbytes || shift > 63) return -1;
            const uint8_t byte = in[pos++];
            z |= static_cast<uint64_t>(byte & 0x7F) << shift;
            if (!(byte & 0x80)) break;
            shift += 7;
        }
        const int64_t delta = static_cast<int64_t>(z >> 1) ^
                              -static_cast<int64_t>(z & 1);
        prev += delta;
        if (count >= cap) return -1;
        out[count++] = static_cast<int32_t>(prev);
    }
    return count;
}

}  // extern "C"
