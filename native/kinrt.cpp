// kinrt — native host runtime for the reconstruction framework.
//
// The reference delegates its host runtime to third-party native code
// (SURVEY.md §2.2): the k4a SDK moves frames, Open3D's C++ writes PLYs, and
// CPython queues shuttle frames between threads. This library provides the
// equivalent first-party native pieces:
//
//  - framelog: a length-prefixed, zlib-compressed RGB-D frame log
//    (record/replay parity with the npz logs of reference
//    bundlefusion_reconstruction.py:219-220, at a fraction of the size and
//    without per-frame Python serialization overhead)
//  - SPSC ring buffer: lock-free single-producer/single-consumer frame
//    channel with latest-wins semantics (the native analog of the
//    reference's Queue(maxsize=5) drop-when-full channel, CreateMesh.py:78)
//  - PLY writer: binary little-endian point-cloud / mesh serialization
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).
//
// Build: make -C native   (g++ -O3 -shared -fPIC kinrt.cpp -lz)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// framelog
// ---------------------------------------------------------------------------
// File layout: [8-byte magic "KINLOG01"]
//   per frame: u32 depth_w, u32 depth_h, u32 color_w, u32 color_h,
//              u32 color_channels, u64 depth_comp_size, u64 color_comp_size,
//              then the two zlib streams.

static const char kMagic[8] = {'K', 'I', 'N', 'L', 'O', 'G', '0', '1'};

struct FrameLogWriter {
  FILE* f;
  std::vector<unsigned char> scratch;
};

struct FrameLogReader {
  FILE* f;
  std::vector<unsigned char> scratch;
};

void* framelog_open_write(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  if (fwrite(kMagic, 1, 8, f) != 8) {
    fclose(f);
    return nullptr;
  }
  auto* w = new FrameLogWriter();
  w->f = f;
  return w;
}

static int compress_into(const unsigned char* src, size_t n,
                         std::vector<unsigned char>& dst, int level) {
  uLongf bound = compressBound(n);
  dst.resize(bound);
  if (compress2(dst.data(), &bound, src, n, level) != Z_OK) return -1;
  dst.resize(bound);
  return 0;
}

int framelog_write(void* handle, const uint16_t* depth, uint32_t dw, uint32_t dh,
                   const uint8_t* color, uint32_t cw, uint32_t ch, uint32_t cc) {
  auto* w = static_cast<FrameLogWriter*>(handle);
  if (!w || !w->f) return -1;
  std::vector<unsigned char> dcomp, ccomp;
  if (compress_into(reinterpret_cast<const unsigned char*>(depth),
                    size_t(dw) * dh * 2, dcomp, 1) != 0)
    return -2;
  if (compress_into(color, size_t(cw) * ch * cc, ccomp, 1) != 0) return -2;
  uint32_t head[5] = {dw, dh, cw, ch, cc};
  uint64_t sizes[2] = {dcomp.size(), ccomp.size()};
  if (fwrite(head, 4, 5, w->f) != 5) return -3;
  if (fwrite(sizes, 8, 2, w->f) != 2) return -3;
  if (fwrite(dcomp.data(), 1, dcomp.size(), w->f) != dcomp.size()) return -3;
  if (fwrite(ccomp.data(), 1, ccomp.size(), w->f) != ccomp.size()) return -3;
  return 0;
}

int framelog_close_write(void* handle) {
  auto* w = static_cast<FrameLogWriter*>(handle);
  if (!w) return -1;
  int rc = fclose(w->f);
  delete w;
  return rc;
}

void* framelog_open_read(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, kMagic, 8) != 0) {
    fclose(f);
    return nullptr;
  }
  auto* r = new FrameLogReader();
  r->f = f;
  return r;
}

// Peek the next frame's dimensions; returns 0 on success, 1 on EOF, <0 error.
int framelog_next_header(void* handle, uint32_t* dims /*dw,dh,cw,ch,cc*/) {
  auto* r = static_cast<FrameLogReader*>(handle);
  if (!r || !r->f) return -1;
  long pos = ftell(r->f);
  uint32_t head[5];
  size_t got = fread(head, 4, 5, r->f);
  if (got == 0) return 1;  // EOF
  if (got != 5) return -2;
  fseek(r->f, pos, SEEK_SET);
  memcpy(dims, head, sizeof(head));
  return 0;
}

// Read + decompress the next frame into caller buffers (sized per header).
int framelog_read(void* handle, uint16_t* depth_out, uint8_t* color_out) {
  auto* r = static_cast<FrameLogReader*>(handle);
  if (!r || !r->f) return -1;
  uint32_t head[5];
  if (fread(head, 4, 5, r->f) != 5) return 1;
  uint64_t sizes[2];
  if (fread(sizes, 8, 2, r->f) != 2) return -2;
  r->scratch.resize(sizes[0]);
  if (fread(r->scratch.data(), 1, sizes[0], r->f) != sizes[0]) return -2;
  uLongf dlen = uLongf(head[0]) * head[1] * 2;
  if (uncompress(reinterpret_cast<unsigned char*>(depth_out), &dlen,
                 r->scratch.data(), sizes[0]) != Z_OK)
    return -3;
  r->scratch.resize(sizes[1]);
  if (fread(r->scratch.data(), 1, sizes[1], r->f) != sizes[1]) return -2;
  uLongf clen = uLongf(head[2]) * head[3] * head[4];
  if (uncompress(color_out, &clen, r->scratch.data(), sizes[1]) != Z_OK)
    return -3;
  return 0;
}

int framelog_close_read(void* handle) {
  auto* r = static_cast<FrameLogReader*>(handle);
  if (!r) return -1;
  int rc = fclose(r->f);
  delete r;
  return rc;
}

// ---------------------------------------------------------------------------
// SPSC ring buffer (latest-wins frame channel)
// ---------------------------------------------------------------------------

// Single-writer discipline: the producer is the ONLY writer of `head`, the
// consumer the ONLY writer of `tail` (an earlier revision let the producer
// bump `tail` on drop-oldest — two writers to one index can lose the
// consumer's drain). Overwrite safety comes from a per-slot seqlock: the
// producer brackets each slot copy with seq = 2f+1 (writing) / 2f+2
// (stable frame f), and the consumer re-checks the sequence after its
// memcpy so a slot the producer lapped mid-read is detected and retried
// instead of handed out torn.
struct Ring {
  std::atomic<uint64_t> head{0};     // next write; producer-only writer
  std::atomic<uint64_t> tail{0};     // consumed-up-to; consumer-only writer
  std::atomic<uint64_t> dropped{0};  // frames overwritten unread
  uint32_t capacity;
  size_t slot_bytes;
  unsigned char* data;
  std::atomic<uint64_t>* seq;  // per-slot: 2f+1 = writing frame f, 2f+2 = stable
};

void* ring_create(uint32_t capacity, uint64_t slot_bytes) {
  auto* rb = new Ring();
  rb->capacity = capacity;
  rb->slot_bytes = slot_bytes;
  rb->data = static_cast<unsigned char*>(malloc(size_t(capacity) * slot_bytes));
  rb->seq = new std::atomic<uint64_t>[capacity]();
  if (!rb->data) {
    delete[] rb->seq;
    delete rb;
    return nullptr;
  }
  return rb;
}

// Producer: copy one slot in, unconditionally advancing (latest-wins: when
// full the oldest unread frame is overwritten; the reference drops the
// NEWEST instead — keeping the newest is strictly better for live tracking).
int ring_push(void* handle, const void* src) {
  auto* rb = static_cast<Ring*>(handle);
  uint64_t h = rb->head.load(std::memory_order_relaxed);
  uint64_t t = rb->tail.load(std::memory_order_acquire);
  if (h - t >= rb->capacity)
    rb->dropped.fetch_add(1, std::memory_order_relaxed);
  std::atomic<uint64_t>& s = rb->seq[h % rb->capacity];
  s.store(2 * h + 1, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_release);  // seq-odd before data
  memcpy(rb->data + (h % rb->capacity) * rb->slot_bytes, src, rb->slot_bytes);
  s.store(2 * h + 2, std::memory_order_release);        // data before seq-even
  rb->head.store(h + 1, std::memory_order_release);
  return 0;
}

// Consumer: drain to the newest available slot. Returns 1 if a frame was
// copied out, 0 if empty (or the producer kept lapping the newest slot —
// only possible at capacity 1 under sustained producer pressure; the caller
// simply polls again).
int ring_pop_latest(void* handle, void* dst) {
  auto* rb = static_cast<Ring*>(handle);
  uint64_t h = rb->head.load(std::memory_order_acquire);
  uint64_t t = rb->tail.load(std::memory_order_relaxed);
  if (t >= h) return 0;
  for (int attempt = 0; attempt < 64; ++attempt) {
    uint64_t newest = h - 1;
    std::atomic<uint64_t>& s = rb->seq[newest % rb->capacity];
    uint64_t s1 = s.load(std::memory_order_acquire);
    if (s1 == 2 * newest + 2) {
      memcpy(dst, rb->data + (newest % rb->capacity) * rb->slot_bytes,
             rb->slot_bytes);
      std::atomic_thread_fence(std::memory_order_acquire);  // data before re-check
      if (s.load(std::memory_order_relaxed) == s1) {
        rb->tail.store(h, std::memory_order_release);
        return 1;
      }
    }
    // the producer lapped this slot — a fresher frame exists; chase it
    h = rb->head.load(std::memory_order_acquire);
  }
  return 0;
}

uint64_t ring_dropped(void* handle) {
  return static_cast<Ring*>(handle)->dropped.load(std::memory_order_relaxed);
}

void ring_destroy(void* handle) {
  auto* rb = static_cast<Ring*>(handle);
  free(rb->data);
  delete[] rb->seq;
  delete rb;
}

// ---------------------------------------------------------------------------
// binary PLY writers
// ---------------------------------------------------------------------------

int ply_write_points(const char* path, const float* xyz, const uint8_t* rgb,
                     const float* normals, uint64_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "ply\nformat binary_little_endian 1.0\nelement vertex %llu\n",
          (unsigned long long)n);
  fprintf(f, "property float x\nproperty float y\nproperty float z\n");
  if (normals)
    fprintf(f, "property float nx\nproperty float ny\nproperty float nz\n");
  if (rgb)
    fprintf(f, "property uchar red\nproperty uchar green\nproperty uchar blue\n");
  fprintf(f, "end_header\n");
  // row-assemble in 64k-point chunks to keep one fwrite per chunk
  const uint64_t CHUNK = 65536;
  size_t row = 12 + (normals ? 12 : 0) + (rgb ? 3 : 0);
  std::vector<unsigned char> buf(CHUNK * row);
  for (uint64_t off = 0; off < n; off += CHUNK) {
    uint64_t m = (n - off < CHUNK) ? (n - off) : CHUNK;
    unsigned char* p = buf.data();
    for (uint64_t i = 0; i < m; i++) {
      memcpy(p, xyz + 3 * (off + i), 12);
      p += 12;
      if (normals) {
        memcpy(p, normals + 3 * (off + i), 12);
        p += 12;
      }
      if (rgb) {
        memcpy(p, rgb + 3 * (off + i), 3);
        p += 3;
      }
    }
    if (fwrite(buf.data(), 1, m * row, f) != m * row) {
      fclose(f);
      return -2;
    }
  }
  return fclose(f);
}

int ply_write_mesh(const char* path, const float* xyz, const uint8_t* rgb,
                   uint64_t nv, const int32_t* tris, uint64_t nt) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "ply\nformat binary_little_endian 1.0\nelement vertex %llu\n",
          (unsigned long long)nv);
  fprintf(f, "property float x\nproperty float y\nproperty float z\n");
  if (rgb)
    fprintf(f, "property uchar red\nproperty uchar green\nproperty uchar blue\n");
  fprintf(f, "element face %llu\nproperty list uchar int vertex_indices\nend_header\n",
          (unsigned long long)nt);
  size_t row = 12 + (rgb ? 3 : 0);
  std::vector<unsigned char> buf;
  buf.resize(size_t(nv) * row);
  unsigned char* p = buf.data();
  for (uint64_t i = 0; i < nv; i++) {
    memcpy(p, xyz + 3 * i, 12);
    p += 12;
    if (rgb) {
      memcpy(p, rgb + 3 * i, 3);
      p += 3;
    }
  }
  if (fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
    fclose(f);
    return -2;
  }
  buf.resize(size_t(nt) * 13);
  p = buf.data();
  for (uint64_t i = 0; i < nt; i++) {
    *p++ = 3;
    memcpy(p, tris + 3 * i, 12);
    p += 12;
  }
  if (fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
    fclose(f);
    return -2;
  }
  return fclose(f);
}

}  // extern "C"
