// scio: stream IO engine for the modem runtime.
//
// The reference's "runtime" is a blocking fread/fwrite loop over one
// channel (reference: src/qpsk.c:436-458, files at qpsk_internal.h:25-26).
// Feeding an accelerator demodulating >=100k channels needs the host
// side to deinterleave, frame, and batch PCM at tens of GB/s; that work
// stays native:
//
//  * scio_deinterleave / scio_interleave: channel-major <-> sample-major
//    int16 transposes, blocked for cache efficiency.
//  * ScioRing: single-producer single-consumer lock-free ring of
//    multi-channel frame blocks (producer pushes interleaved samples,
//    consumer pops [n_channels x frame_size] blocks ready for the
//    device).
//  * scio_file_*: mmap-backed PCM file reader.
//
// C ABI throughout; Python binds via ctypes (singlecarrier_tpu/runtime/
// engine.py).  Build: make -C native.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Blocked transposes (deinterleave / interleave).
// ---------------------------------------------------------------------------

// in:  interleaved sample-major [n_samples][n_channels]
// out: channel-major [n_channels][n_samples]
void scio_deinterleave(const int16_t* in, int16_t* out,
                       long n_samples, long n_channels) {
    const long BS = 64;  // block in samples
    const long BC = 64;  // block in channels
    for (long s0 = 0; s0 < n_samples; s0 += BS) {
        long s1 = s0 + BS < n_samples ? s0 + BS : n_samples;
        for (long c0 = 0; c0 < n_channels; c0 += BC) {
            long c1 = c0 + BC < n_channels ? c0 + BC : n_channels;
            for (long s = s0; s < s1; s++) {
                const int16_t* row = in + s * n_channels;
                for (long c = c0; c < c1; c++) {
                    out[c * n_samples + s] = row[c];
                }
            }
        }
    }
}

// in:  channel-major [n_channels][n_samples]
// out: interleaved [n_samples][n_channels]
void scio_interleave(const int16_t* in, int16_t* out,
                     long n_samples, long n_channels) {
    const long BS = 64;
    const long BC = 64;
    for (long c0 = 0; c0 < n_channels; c0 += BC) {
        long c1 = c0 + BC < n_channels ? c0 + BC : n_channels;
        for (long s0 = 0; s0 < n_samples; s0 += BS) {
            long s1 = s0 + BS < n_samples ? s0 + BS : n_samples;
            for (long c = c0; c < c1; c++) {
                const int16_t* row = in + c * n_samples;
                for (long s = s0; s < s1; s++) {
                    out[s * n_channels + c] = row[s];
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// SPSC ring of framed multi-channel blocks.
// ---------------------------------------------------------------------------

struct ScioRing {
    long n_channels;
    long frame_size;
    long capacity;          // number of blocks
    int16_t* blocks;        // [capacity][n_channels][frame_size]
    // staging buffer for a partially filled block (interleaved cursor)
    long staged;            // samples-per-channel staged into write block
    std::atomic<long> head; // next block to write (producer)
    std::atomic<long> tail; // next block to read (consumer)
};

ScioRing* scio_ring_create(long n_channels, long frame_size,
                           long capacity_blocks) {
    ScioRing* r = new ScioRing();
    r->n_channels = n_channels;
    r->frame_size = frame_size;
    r->capacity = capacity_blocks;
    r->blocks = static_cast<int16_t*>(
        calloc(static_cast<size_t>(capacity_blocks) * n_channels * frame_size,
               sizeof(int16_t)));
    r->staged = 0;
    r->head.store(0);
    r->tail.store(0);
    return r;
}

void scio_ring_destroy(ScioRing* r) {
    if (!r) return;
    free(r->blocks);
    delete r;
}

long scio_ring_blocks_ready(const ScioRing* r) {
    return r->head.load(std::memory_order_acquire) -
           r->tail.load(std::memory_order_acquire);
}

// Producer: push interleaved samples [n_samples][n_channels]; frames
// complete blocks into the ring.  Returns samples consumed (may be
// less than n_samples if the ring is full).
long scio_ring_push_interleaved(ScioRing* r, const int16_t* data,
                                long n_samples) {
    long consumed = 0;
    while (consumed < n_samples) {
        long head = r->head.load(std::memory_order_relaxed);
        long tail = r->tail.load(std::memory_order_acquire);
        if (head - tail >= r->capacity) break;  // full

        int16_t* block = r->blocks +
            (head % r->capacity) * r->n_channels * r->frame_size;
        long want = r->frame_size - r->staged;
        long have = n_samples - consumed;
        long take = want < have ? want : have;

        // deinterleave straight into the block at the staged offset
        const int16_t* src = data + consumed * r->n_channels;
        for (long s = 0; s < take; s++) {
            const int16_t* row = src + s * r->n_channels;
            long col = r->staged + s;
            for (long c = 0; c < r->n_channels; c++) {
                block[c * r->frame_size + col] = row[c];
            }
        }
        r->staged += take;
        consumed += take;
        if (r->staged == r->frame_size) {
            r->staged = 0;
            r->head.store(head + 1, std::memory_order_release);
        }
    }
    return consumed;
}

// Consumer: pop one [n_channels][frame_size] block.  Returns 1 on
// success, 0 if no complete block is ready.
int scio_ring_pop_block(ScioRing* r, int16_t* out) {
    long tail = r->tail.load(std::memory_order_relaxed);
    long head = r->head.load(std::memory_order_acquire);
    if (head == tail) return 0;
    const int16_t* block = r->blocks +
        (tail % r->capacity) * r->n_channels * r->frame_size;
    memcpy(out, block,
           static_cast<size_t>(r->n_channels) * r->frame_size *
           sizeof(int16_t));
    r->tail.store(tail + 1, std::memory_order_release);
    return 1;
}

// ---------------------------------------------------------------------------
// mmap PCM file reader.
// ---------------------------------------------------------------------------

struct ScioFile {
    int fd;
    long n_samples;
    const int16_t* data;
};

ScioFile* scio_file_open(const char* path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
    void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) { close(fd); return nullptr; }
    ScioFile* f = new ScioFile();
    f->fd = fd;
    f->n_samples = st.st_size / static_cast<long>(sizeof(int16_t));
    f->data = static_cast<const int16_t*>(p);
    return f;
}

long scio_file_samples(const ScioFile* f) { return f ? f->n_samples : -1; }

// Copy [count] samples starting at [offset] (zero-padded past EOF).
long scio_file_read(const ScioFile* f, long offset, long count,
                    int16_t* out) {
    if (!f || offset < 0) return -1;
    long avail = f->n_samples - offset;
    if (avail < 0) avail = 0;
    long n = count < avail ? count : avail;
    if (n > 0) memcpy(out, f->data + offset, n * sizeof(int16_t));
    if (n < count) memset(out + n, 0, (count - n) * sizeof(int16_t));
    return n;
}

void scio_file_close(ScioFile* f) {
    if (!f) return;
    munmap(const_cast<int16_t*>(f->data), f->n_samples * sizeof(int16_t));
    close(f->fd);
    delete f;
}

}  // extern "C"
