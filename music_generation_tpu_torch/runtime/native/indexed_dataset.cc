// Indexed binary dataset — native CPU implementation (mmap + OpenMP gather).
//
// Copy of music_generation_tpu/runtime/native/indexed_dataset.cc (the same
// file format, byte for byte), a rebuild of the reference's pickle-based
// IndexedDataset (VISinger/utils/indexed_datasets.py:7-54): one `.data`
// file of concatenated records plus a `.idx` offset table. Differences by
// design:
//  - no pickle: records are raw bytes (the Python layer serializes numpy
//    arrays with a fixed little-endian header — see runtime/indexed_dataset.py)
//  - the index is a flat uint64 table (magic + count + offsets), not an
//    .npy-pickled dict
//  - reads are zero-copy mmap views; multi-record gathers copy in parallel
//    (OpenMP) so batch assembly never serializes on the GIL.
//
// Host code, built with g++ by runtime/native_loader.py.
// ABI: plain C, consumed via ctypes (no pybind11 dependency).

#include <sys/mman.h>
#include <sys/stat.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr char kMagic[8] = {'M', 'G', 'I', 'D', 'X', '1', 0, 0};

struct Builder {
  FILE* data;
  std::vector<uint64_t> offsets;
};

struct Reader {
  const char* base = nullptr;   // mmap of .data
  size_t data_size = 0;
  std::vector<uint64_t> offsets;
};

}  // namespace

extern "C" {

void* idx_builder_open(const char* path) {
  std::string data_path = std::string(path) + ".data";
  FILE* f = std::fopen(data_path.c_str(), "wb");
  if (!f) return nullptr;
  auto* b = new Builder;
  b->data = f;
  b->offsets.push_back(0);
  return b;
}

int64_t idx_builder_add(void* handle, const void* data, int64_t n) {
  auto* b = static_cast<Builder*>(handle);
  if (n > 0 && std::fwrite(data, 1, (size_t)n, b->data) != (size_t)n)
    return -1;
  b->offsets.push_back(b->offsets.back() + (uint64_t)n);
  return (int64_t)b->offsets.size() - 2;  // record index just written
}

int idx_builder_finalize(void* handle, const char* path) {
  auto* b = static_cast<Builder*>(handle);
  std::fclose(b->data);
  std::string idx_path = std::string(path) + ".idx";
  FILE* f = std::fopen(idx_path.c_str(), "wb");
  if (!f) {
    delete b;
    return -1;
  }
  uint64_t n = b->offsets.size() - 1;
  int ok = std::fwrite(kMagic, 1, 8, f) == 8 &&
           std::fwrite(&n, 8, 1, f) == 1 &&
           std::fwrite(b->offsets.data(), 8, b->offsets.size(), f) ==
               b->offsets.size();
  std::fclose(f);
  delete b;
  return ok ? 0 : -1;
}

void* idx_reader_open(const char* path) {
  std::string idx_path = std::string(path) + ".idx";
  FILE* f = std::fopen(idx_path.c_str(), "rb");
  if (!f) return nullptr;
  char magic[8];
  uint64_t n = 0;
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, kMagic, 8) != 0 ||
      std::fread(&n, 8, 1, f) != 1) {
    std::fclose(f);
    return nullptr;
  }
  auto* r = new Reader;
  r->offsets.resize(n + 1);
  if (std::fread(r->offsets.data(), 8, n + 1, f) != n + 1) {
    std::fclose(f);
    delete r;
    return nullptr;
  }
  std::fclose(f);

  std::string data_path = std::string(path) + ".data";
  FILE* df = std::fopen(data_path.c_str(), "rb");
  if (!df) {
    delete r;
    return nullptr;
  }
  struct stat st;
  if (fstat(fileno(df), &st) != 0 || (uint64_t)st.st_size < r->offsets[n]) {
    std::fclose(df);
    delete r;
    return nullptr;
  }
  r->data_size = (size_t)st.st_size;
  if (r->data_size > 0) {
    void* m = mmap(nullptr, r->data_size, PROT_READ, MAP_SHARED,
                   fileno(df), 0);
    if (m == MAP_FAILED) {
      std::fclose(df);
      delete r;
      return nullptr;
    }
    r->base = static_cast<const char*>(m);
  }
  std::fclose(df);  // mmap keeps its own reference
  return r;
}

int64_t idx_reader_len(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  return (int64_t)r->offsets.size() - 1;
}

int64_t idx_reader_size(void* handle, int64_t i) {
  auto* r = static_cast<Reader*>(handle);
  return (int64_t)(r->offsets[i + 1] - r->offsets[i]);
}

const void* idx_reader_ptr(void* handle, int64_t i) {
  auto* r = static_cast<Reader*>(handle);
  return r->base + r->offsets[i];
}

// Copy records ids[0..n) into dst at dst_offsets[0..n) (parallel).
void idx_reader_gather(void* handle, const int64_t* ids, int n, char* dst,
                       const int64_t* dst_offsets) {
  auto* r = static_cast<Reader*>(handle);
#pragma omp parallel for schedule(dynamic)
  for (int k = 0; k < n; ++k) {
    int64_t i = ids[k];
    std::memcpy(dst + dst_offsets[k], r->base + r->offsets[i],
                r->offsets[i + 1] - r->offsets[i]);
  }
}

void idx_reader_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (r->base) munmap((void*)r->base, r->data_size);
  delete r;
}

}  // extern "C"
