/* A stand-in for libcuda.so.1, so the quota guard (cudaguard.cpp) runs on a
 * machine without a GPU. It exports cuInit, cuGetProcAddress{,_v2} and the
 * memory calls the guard hooks, backed by host memory (malloc'ed, never
 * touched) against a fake card of CUDA_STUB_TOTAL bytes (default 1 GiB),
 * read at each call. cuGetProcAddress resolves base names as the driver
 * does: the _v2 allocation calls from cudaVersion 3020, cuGetProcAddress_v2
 * from 12000, the _ptsz variants under the per-thread-stream flag.
 *
 * Test hooks, not CUDA:
 *   cuda_stub_calls(name)       how often the exported function `name` ran
 *   cuda_stub_alloc_raw(p, n)   an allocation no hook sees (a foreign one)
 *   cuda_stub_hold(n)           take n bytes of the card, as another process
 *
 * Build: g++ -O2 -fPIC -shared -std=c++17 -Wl,-soname,libcuda.so.1
 *        -Wl,-Bsymbolic -o libcuda.so.1 cuda_stub.cpp
 * (-Bsymbolic: the stub's own references to its functions bind inside it,
 * as the driver's do, and not to a preloaded hook of the same name.)
 */
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>

extern "C" {
typedef int CUresult;
typedef unsigned long long CUdeviceptr;
typedef struct CUstream_st* CUstream;
typedef struct CUmemPoolHandle_st* CUmemoryPool;
typedef unsigned long long CUmemGenericAllocationHandle;
typedef unsigned long long cuuint64_t;
typedef int CUdriverProcAddressQueryResult;
typedef struct {
  int type;
  int requestedHandleTypes;
  int location_type;
  int location_id;
  void* win32HandleMetaData;
  unsigned char allocFlags[8];
} CUmemAllocationProp;
}

namespace {

constexpr CUresult kSuccess = 0;
constexpr CUresult kInvalidValue = 1;
constexpr CUresult kOutOfMemory = 2;
constexpr CUresult kNotFound = 500;
constexpr int kLocationHost = 2;
constexpr size_t kPitchAlign = 512;

std::mutex g_mu;
std::map<std::string, int> g_calls;
std::map<unsigned long long, size_t> g_live;  /* device allocations and handles */
size_t g_used = 0;                  /* bytes of the fake card in use */
size_t g_held = 0;                  /* bytes taken by "another process" */

size_t total() {
  const char* v = std::getenv("CUDA_STUB_TOTAL");
  return v != nullptr && *v != '\0' ? std::strtoull(v, nullptr, 10) : size_t{1} << 30;
}

void count(const char* name) {
  std::lock_guard<std::mutex> lock(g_mu);
  ++g_calls[name];
}

/* Take `size` bytes of the card (device memory) or of the host. */
CUresult take(unsigned long long* out, size_t size, bool device) {
  if (out == nullptr || size == 0) return kInvalidValue;
  std::lock_guard<std::mutex> lock(g_mu);
  if (device && g_used + g_held + size > total()) return kOutOfMemory;
  void* p = std::malloc(size);
  if (p == nullptr) return kOutOfMemory;
  const unsigned long long key = reinterpret_cast<uintptr_t>(p);
  g_live[key] = device ? size : 0;
  if (device) g_used += size;
  *out = key;
  return kSuccess;
}

CUresult give_back(unsigned long long key) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_live.find(key);
  if (it == g_live.end()) return kInvalidValue;
  g_used -= it->second;
  std::free(reinterpret_cast<void*>(static_cast<uintptr_t>(key)));
  g_live.erase(it);
  return kSuccess;
}

}  // namespace

extern "C" {

CUresult cuInit(unsigned flags) { return flags == 0 ? kSuccess : kInvalidValue; }

CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t size) {
  count("cuMemAlloc_v2");
  return take(dptr, size, true);
}

CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch, size_t width,
                            size_t height, unsigned elem_size) {
  count("cuMemAllocPitch_v2");
  if (pitch == nullptr || elem_size == 0) return kInvalidValue;
  const size_t p = (width + kPitchAlign - 1) / kPitchAlign * kPitchAlign;
  CUresult rc = take(dptr, p * height, true);
  if (rc == kSuccess) *pitch = p;
  return rc;
}

CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t size, unsigned flags) {
  count("cuMemAllocManaged");
  (void)flags;
  return take(dptr, size, true);
}

CUresult cuMemAllocAsync(CUdeviceptr* dptr, size_t size, CUstream stream) {
  count("cuMemAllocAsync");
  (void)stream;
  return take(dptr, size, true);
}

CUresult cuMemAllocAsync_ptsz(CUdeviceptr* dptr, size_t size, CUstream stream) {
  count("cuMemAllocAsync_ptsz");
  (void)stream;
  return take(dptr, size, true);
}

CUresult cuMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t size,
                                 CUmemoryPool pool, CUstream stream) {
  count("cuMemAllocFromPoolAsync");
  (void)pool, (void)stream;
  return take(dptr, size, true);
}

CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr* dptr, size_t size,
                                      CUmemoryPool pool, CUstream stream) {
  count("cuMemAllocFromPoolAsync_ptsz");
  (void)pool, (void)stream;
  return take(dptr, size, true);
}

CUresult cuMemCreate(CUmemGenericAllocationHandle* handle, size_t size,
                     const CUmemAllocationProp* prop, unsigned long long flags) {
  count("cuMemCreate");
  if (prop == nullptr || flags != 0) return kInvalidValue;
  return take(handle, size, prop->location_type != kLocationHost);
}

CUresult cuMemFree_v2(CUdeviceptr dptr) {
  count("cuMemFree_v2");
  return give_back(dptr);
}

CUresult cuMemFreeAsync(CUdeviceptr dptr, CUstream stream) {
  count("cuMemFreeAsync");
  (void)stream;
  return give_back(dptr);
}

CUresult cuMemFreeAsync_ptsz(CUdeviceptr dptr, CUstream stream) {
  count("cuMemFreeAsync_ptsz");
  (void)stream;
  return give_back(dptr);
}

CUresult cuMemRelease(CUmemGenericAllocationHandle handle) {
  count("cuMemRelease");
  return give_back(handle);
}

CUresult cuMemGetInfo_v2(size_t* free_bytes, size_t* total_bytes) {
  count("cuMemGetInfo_v2");
  if (free_bytes == nullptr || total_bytes == nullptr) return kInvalidValue;
  std::lock_guard<std::mutex> lock(g_mu);
  *total_bytes = total();
  *free_bytes = *total_bytes - g_used - g_held;
  return kSuccess;
}

CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                          cuuint64_t flags);

CUresult cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                             cuuint64_t flags,
                             CUdriverProcAddressQueryResult* status) {
  count("cuGetProcAddress_v2");
  if (symbol == nullptr || pfn == nullptr) return kInvalidValue;
  const bool ptsz = (flags & 2) != 0;
  struct Name {
    const char* base;
    int min_version;
    int end_version;
    void* legacy;
    void* per_thread; /* null: the same as legacy */
  };
#define FN(f) reinterpret_cast<void*>(&f)
  const Name names[] = {
      {"cuInit", 2000, 1 << 30, FN(cuInit), nullptr},
      {"cuMemAlloc", 3020, 1 << 30, FN(cuMemAlloc_v2), nullptr},
      {"cuMemAllocPitch", 3020, 1 << 30, FN(cuMemAllocPitch_v2), nullptr},
      {"cuMemAllocManaged", 6000, 1 << 30, FN(cuMemAllocManaged), nullptr},
      {"cuMemAllocAsync", 11020, 1 << 30, FN(cuMemAllocAsync), FN(cuMemAllocAsync_ptsz)},
      {"cuMemAllocFromPoolAsync", 11020, 1 << 30, FN(cuMemAllocFromPoolAsync),
       FN(cuMemAllocFromPoolAsync_ptsz)},
      {"cuMemCreate", 10020, 1 << 30, FN(cuMemCreate), nullptr},
      {"cuMemFree", 3020, 1 << 30, FN(cuMemFree_v2), nullptr},
      {"cuMemFreeAsync", 11020, 1 << 30, FN(cuMemFreeAsync), FN(cuMemFreeAsync_ptsz)},
      {"cuMemRelease", 10020, 1 << 30, FN(cuMemRelease), nullptr},
      {"cuMemGetInfo", 3020, 1 << 30, FN(cuMemGetInfo_v2), nullptr},
      {"cuGetProcAddress", 11030, 12000, FN(cuGetProcAddress), nullptr},
      {"cuGetProcAddress", 12000, 1 << 30, FN(cuGetProcAddress_v2), nullptr},
  };
#undef FN
  for (const Name& n : names) {
    if (std::strcmp(symbol, n.base) != 0 || version < n.min_version ||
        version >= n.end_version)
      continue;
    *pfn = ptsz && n.per_thread != nullptr ? n.per_thread : n.legacy;
    if (status != nullptr) *status = 0; /* CU_GET_PROC_ADDRESS_SUCCESS */
    return kSuccess;
  }
  *pfn = nullptr;
  if (status != nullptr) *status = 1; /* CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND */
  return kNotFound;
}

CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                          cuuint64_t flags) {
  count("cuGetProcAddress");
  return cuGetProcAddress_v2(symbol, pfn, version, flags, nullptr);
}

/* --- test hooks ------------------------------------------------------------ */
int cuda_stub_calls(const char* name) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_calls.find(name);
  return it == g_calls.end() ? 0 : it->second;
}

CUresult cuda_stub_alloc_raw(CUdeviceptr* dptr, size_t size) {
  return take(dptr, size, true);
}

void cuda_stub_hold(size_t bytes) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_held = bytes;
}

}  // extern "C"
