// EgoTAP packed record file (.egr) reader.
//
// The port's own copy of egotap_tpu/native/recordio.cc: the same file
// format, so a pack written by either package reads in the other.
// The reference's input path deserializes a python pickle per frame in
// DataLoader worker processes (dataloader/data_loader.py:76-215). Here
// frames are packed once into a fixed-stride binary record file; this
// library mmaps it and assembles whole batches with a multi-threaded
// strided gather into one contiguous buffer — zero python-object work on
// the hot path.
//
// Format (little-endian):
//   char     magic[8] = "EGTPREC1"
//   uint64   num_records
//   uint64   record_bytes
//   uint32   num_fields, pad
//   field[num_fields]:
//     char   name[64]
//     uint32 dtype    (0 = f32, 1 = u8, 2 = f16, 3 = i32)
//     uint32 ndim
//     uint64 dims[6]
//     uint64 offset   (byte offset inside a record)
//   payload: num_records * record_bytes
//
// C ABI (ctypes-friendly); thread-safe for concurrent gathers.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

#pragma pack(push, 1)
struct FieldDesc {
  char name[64];
  uint32_t dtype;
  uint32_t ndim;
  uint64_t dims[6];
  uint64_t offset;
};

struct Header {
  char magic[8];
  uint64_t num_records;
  uint64_t record_bytes;
  uint32_t num_fields;
  uint32_t pad;
};
#pragma pack(pop)

struct Reader {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t mapped = 0;
  Header hdr{};
  std::vector<FieldDesc> fields;
  const uint8_t* payload = nullptr;
};

}  // namespace

extern "C" {

void* egr_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) { ::close(fd); return nullptr; }

  auto* r = new Reader();
  r->fd = fd;
  r->base = static_cast<const uint8_t*>(mem);
  r->mapped = st.st_size;
  std::memcpy(&r->hdr, r->base, sizeof(Header));
  if (std::memcmp(r->hdr.magic, "EGTPREC1", 8) != 0) {
    munmap(mem, st.st_size); ::close(fd); delete r; return nullptr;
  }
  r->fields.resize(r->hdr.num_fields);
  std::memcpy(r->fields.data(), r->base + sizeof(Header),
              sizeof(FieldDesc) * r->hdr.num_fields);
  r->payload = r->base + sizeof(Header)
             + sizeof(FieldDesc) * r->hdr.num_fields;
  return r;
}

void egr_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return;
  munmap(const_cast<uint8_t*>(r->base), r->mapped);
  ::close(r->fd);
  delete r;
}

uint64_t egr_num_records(void* handle) {
  return static_cast<Reader*>(handle)->hdr.num_records;
}

uint64_t egr_record_bytes(void* handle) {
  return static_cast<Reader*>(handle)->hdr.record_bytes;
}

uint32_t egr_num_fields(void* handle) {
  return static_cast<Reader*>(handle)->hdr.num_fields;
}

// Fill caller buffers describing field `i`.
int egr_field_info(void* handle, uint32_t i, char* name64, uint32_t* dtype,
                   uint32_t* ndim, uint64_t* dims6, uint64_t* offset) {
  auto* r = static_cast<Reader*>(handle);
  if (i >= r->hdr.num_fields) return -1;
  const FieldDesc& f = r->fields[i];
  std::memcpy(name64, f.name, 64);
  *dtype = f.dtype;
  *ndim = f.ndim;
  std::memcpy(dims6, f.dims, sizeof(f.dims));
  *offset = f.offset;
  return 0;
}

// Gather `n` whole records (by index) into `out` (n * record_bytes),
// splitting the copy across up to `num_threads` threads.
int egr_gather(void* handle, const uint64_t* indices, uint64_t n,
               uint8_t* out, uint32_t num_threads) {
  auto* r = static_cast<Reader*>(handle);
  const uint64_t rb = r->hdr.record_bytes;
  for (uint64_t i = 0; i < n; ++i) {
    if (indices[i] >= r->hdr.num_records) return -1;
  }
  auto copy_range = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      std::memcpy(out + i * rb, r->payload + indices[i] * rb, rb);
    }
  };
  if (num_threads <= 1 || n < 2) {
    copy_range(0, n);
    return 0;
  }
  uint32_t t = std::min<uint64_t>(num_threads, n);
  std::vector<std::thread> workers;
  uint64_t chunk = (n + t - 1) / t;
  for (uint32_t w = 0; w < t; ++w) {
    uint64_t lo = w * chunk, hi = std::min<uint64_t>(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back(copy_range, lo, hi);
  }
  for (auto& th : workers) th.join();
  return 0;
}

// Field-major batch gather: for each field f, the batch's values land
// contiguously at outs[f] (n * field_bytes[f]), i.e. already in the
// (batch, *field_shape) layout numpy wants. One pass over the mmap'd
// payload, no record-major intermediate, zero python-side copies —
// the python wrapper hands the buffers straight to np.frombuffer.
int egr_gather_fields(void* handle, const uint64_t* indices, uint64_t n,
                      uint8_t** outs, const uint64_t* field_bytes,
                      uint32_t num_threads) {
  auto* r = static_cast<Reader*>(handle);
  const uint64_t rb = r->hdr.record_bytes;
  const uint32_t nf = r->hdr.num_fields;
  for (uint64_t i = 0; i < n; ++i) {
    if (indices[i] >= r->hdr.num_records) return -1;
  }
  auto copy_range = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      const uint8_t* rec = r->payload + indices[i] * rb;
      for (uint32_t f = 0; f < nf; ++f) {
        std::memcpy(outs[f] + i * field_bytes[f],
                    rec + r->fields[f].offset, field_bytes[f]);
      }
    }
  };
  if (num_threads <= 1 || n < 2) {
    copy_range(0, n);
    return 0;
  }
  uint32_t t = std::min<uint64_t>(num_threads, n);
  std::vector<std::thread> workers;
  uint64_t chunk = (n + t - 1) / t;
  for (uint32_t w = 0; w < t; ++w) {
    uint64_t lo = w * chunk, hi = std::min<uint64_t>(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back(copy_range, lo, hi);
  }
  for (auto& th : workers) th.join();
  return 0;
}

}  // extern "C"
