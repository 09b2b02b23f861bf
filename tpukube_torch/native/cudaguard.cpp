/* libcudaguard — device-memory quota guard for the CUDA driver API
 * (LD_PRELOAD). The port of tpukube/native/hbmguard.cpp.
 *
 * Preloaded into a pod, it meters the process's device allocations against
 * TPU_HBM_LIMIT_BYTES (the share's quota from the Allocate env) and refuses
 * a request that would pass it with CUDA_ERROR_OUT_OF_MEMORY, so PyTorch
 * raises torch.OutOfMemoryError exactly as on a full card. Without a limit
 * (or with one that does not parse) it is inert.
 *
 * Metered, as alloc/free pairs: cuMemAlloc_v2, cuMemAllocPitch_v2,
 * cuMemAllocManaged, cuMemAllocAsync and cuMemAllocFromPoolAsync (and
 * their _ptsz twins) against cuMemFree_v2 and cuMemFreeAsync(_ptsz); and
 * cuMemCreate of device memory against cuMemRelease. cuMemGetInfo_v2
 * reports free = min(the driver's free, limit - used) and leaves total as
 * the driver says: PyTorch's set_per_process_memory_fraction multiplies
 * that total, so a total cut to the limit would cap the pod twice.
 *
 * How a process reaches the driver, and what the guard does about each:
 *  - by direct symbol (a binary linked against libcuda): the guard exports
 *    the metered names itself, and being preloaded it comes first;
 *  - by dlsym on a dlopen'ed libcuda (PyTorch's c10 driver API): the guard
 *    interposes dlsym and hands out its own function for a metered name;
 *  - by cuGetProcAddress{,_v2} (cudart resolves every driver entry point
 *    that way, after dlsym'ing cuGetProcAddress_v2 from libcuda): dlsym
 *    hands out the guard's cuGetProcAddress{,_v2}, which returns the guard's
 *    function for a metered name, matched by the base name asked for and,
 *    for the calls that take a stream, the per-thread-stream flag.
 * Each hook forwards to the driver's own function: the one its lookup
 * returned (first seen wins), or, for a direct call, the next definition
 * after the guard (libcuda.so.1 when that is not in the global scope).
 * Every other symbol goes through dlsym untouched: the guard's dlsym ends
 * in a tail call to glibc's, so a caller's RTLD_NEXT still means the object
 * after the caller. The real dlsym is reached through dlvsym.
 *
 * As in hbmguard: metered blocks live in a lock-free (key, size) table,
 * so freeing a pointer or handle the guard never metered (one from before
 * the limit was read, a foreign one) cannot move the counter; if the table
 * fills, the block passes unmetered rather than corrupt the count. Unlike
 * hbmguard there is no size threshold: every device allocation counts
 * (PyTorch's caching allocator asks for segments of 2 MiB and up anyway).
 *
 * Limits of the model (README, GPU trust model): the guard sees what the
 * process asks the driver for. It does not see the CUDA context, module
 * images, or memory the driver and libraries allocate inside the driver;
 * pre-CUDA-3.2 entry points (cuMemAlloc without _v2) pass unmetered; a
 * stream-ordered pool's reserve beyond its live allocations is not
 * counted (cuMemAllocFromPoolAsync is metered per call, cuMemFreeAsync
 * un-meters at the call). An audit shim, not a security boundary: a pod
 * that drops its preload escapes it, as with the reference's.
 *
 * The CUDA types are declared by hand: no CUDA header is needed to build,
 * and the guard does not link libcuda. Build: g++ -O2 -fPIC -shared
 * -fno-exceptions -std=c++17 -o libcudaguard.so cudaguard.cpp -ldl
 */
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <atomic>
#include <climits>
#include <initializer_list>

extern "C" {

/* --- the CUDA driver API, declared by hand (cuda.h, CUDA 12) ------------- */
typedef int CUresult;
typedef unsigned long long CUdeviceptr; /* CUdeviceptr_v2 */
typedef struct CUstream_st* CUstream;
typedef struct CUmemPoolHandle_st* CUmemoryPool;
typedef unsigned long long CUmemGenericAllocationHandle;
typedef unsigned long long cuuint64_t;
typedef int CUdriverProcAddressQueryResult;
/* The head of CUmemAllocationProp: the guard reads only the location. */
typedef struct {
  int type;                 /* CUmemAllocationType */
  int requestedHandleTypes; /* CUmemAllocationHandleType */
  int location_type;        /* CUmemLocation.type */
  int location_id;          /* CUmemLocation.id */
} CUmemAllocationProp;

/* The guard's counters, for the pods and the tests. */
int64_t cudaguard_used(void);
int64_t cudaguard_limit(void);
int64_t cudaguard_peak(void);
int64_t cudaguard_refused(void);

/* The hooks: the driver's names, defined below. */
CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t size);
CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch, size_t width,
                            size_t height, unsigned elem_size);
CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t size, unsigned flags);
CUresult cuMemAllocAsync(CUdeviceptr* dptr, size_t size, CUstream stream);
CUresult cuMemAllocAsync_ptsz(CUdeviceptr* dptr, size_t size, CUstream stream);
CUresult cuMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t size,
                                 CUmemoryPool pool, CUstream stream);
CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr* dptr, size_t size,
                                      CUmemoryPool pool, CUstream stream);
CUresult cuMemCreate(CUmemGenericAllocationHandle* handle, size_t size,
                     const CUmemAllocationProp* prop, unsigned long long flags);
CUresult cuMemFree_v2(CUdeviceptr dptr);
CUresult cuMemFreeAsync(CUdeviceptr dptr, CUstream stream);
CUresult cuMemFreeAsync_ptsz(CUdeviceptr dptr, CUstream stream);
CUresult cuMemRelease(CUmemGenericAllocationHandle handle);
CUresult cuMemGetInfo_v2(size_t* free_bytes, size_t* total_bytes);
CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                          cuuint64_t flags);
CUresult cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                             cuuint64_t flags,
                             CUdriverProcAddressQueryResult* status);

}  // extern "C"

namespace {

constexpr CUresult kSuccess = 0;
constexpr CUresult kOutOfMemory = 2;            /* CUDA_ERROR_OUT_OF_MEMORY */
constexpr CUresult kSymbolNotFound = 302;       /* CUDA_ERROR_SHARED_OBJECT_SYMBOL_NOT_FOUND */
constexpr cuuint64_t kPerThreadStream = 2;      /* CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM */
constexpr int kLocationHost = 2;                /* CU_MEM_LOCATION_TYPE_HOST */
constexpr int kLocationHostNumaCurrent = 4;     /* ... _HOST_NUMA(_CURRENT): 3, 4 */

/* --- the hooked entry points ---------------------------------------------- */
enum Slot {
  kMemAlloc, kMemAllocPitch, kMemAllocManaged, kMemAllocAsync,
  kMemAllocAsyncPtsz, kMemAllocFromPoolAsync, kMemAllocFromPoolAsyncPtsz,
  kMemCreate, kMemFree, kMemFreeAsync, kMemFreeAsyncPtsz, kMemRelease,
  kMemGetInfo, kGetProcAddress, kGetProcAddressV2, kNumSlots
};

enum Stream { kNoStream, kLegacy, kPtsz };

struct Entry {
  const char* name;  /* the driver's exported symbol */
  const char* base;  /* what cuGetProcAddress is asked for */
  int min_version;   /* cudaVersions that resolve base to this variant: */
  int end_version;   /* [min_version, end_version) */
  Stream stream;     /* which stream flavour, for calls that take one */
  void* hook;
};

#define HOOK(f) reinterpret_cast<void*>(&f)
const Entry kEntries[kNumSlots] = {
    {"cuMemAlloc_v2", "cuMemAlloc", 3020, INT_MAX, kNoStream, HOOK(cuMemAlloc_v2)},
    {"cuMemAllocPitch_v2", "cuMemAllocPitch", 3020, INT_MAX, kNoStream,
     HOOK(cuMemAllocPitch_v2)},
    {"cuMemAllocManaged", "cuMemAllocManaged", 0, INT_MAX, kNoStream,
     HOOK(cuMemAllocManaged)},
    {"cuMemAllocAsync", "cuMemAllocAsync", 0, INT_MAX, kLegacy, HOOK(cuMemAllocAsync)},
    {"cuMemAllocAsync_ptsz", "cuMemAllocAsync", 0, INT_MAX, kPtsz,
     HOOK(cuMemAllocAsync_ptsz)},
    {"cuMemAllocFromPoolAsync", "cuMemAllocFromPoolAsync", 0, INT_MAX, kLegacy,
     HOOK(cuMemAllocFromPoolAsync)},
    {"cuMemAllocFromPoolAsync_ptsz", "cuMemAllocFromPoolAsync", 0, INT_MAX, kPtsz,
     HOOK(cuMemAllocFromPoolAsync_ptsz)},
    {"cuMemCreate", "cuMemCreate", 0, INT_MAX, kNoStream, HOOK(cuMemCreate)},
    {"cuMemFree_v2", "cuMemFree", 3020, INT_MAX, kNoStream, HOOK(cuMemFree_v2)},
    {"cuMemFreeAsync", "cuMemFreeAsync", 0, INT_MAX, kLegacy, HOOK(cuMemFreeAsync)},
    {"cuMemFreeAsync_ptsz", "cuMemFreeAsync", 0, INT_MAX, kPtsz,
     HOOK(cuMemFreeAsync_ptsz)},
    {"cuMemRelease", "cuMemRelease", 0, INT_MAX, kNoStream, HOOK(cuMemRelease)},
    {"cuMemGetInfo_v2", "cuMemGetInfo", 3020, INT_MAX, kNoStream, HOOK(cuMemGetInfo_v2)},
    {"cuGetProcAddress", "cuGetProcAddress", 0, 12000, kNoStream, HOOK(cuGetProcAddress)},
    {"cuGetProcAddress_v2", "cuGetProcAddress", 12000, INT_MAX, kNoStream,
     HOOK(cuGetProcAddress_v2)},
};
#undef HOOK

/* The driver's function behind each hook. */
std::atomic<void*> g_real[kNumSlots];

int slot_by_name(const char* name) {
  if (name == nullptr || name[0] != 'c' || name[1] != 'u') return -1;
  for (int s = 0; s < kNumSlots; ++s)
    if (strcmp(name, kEntries[s].name) == 0) return s;
  return -1;
}

/* The hook cuGetProcAddress hands out for (base, version, flags), or -1. */
int slot_by_base(const char* base, int version, cuuint64_t flags) {
  const Stream want = (flags & kPerThreadStream) ? kPtsz : kLegacy;
  for (int s = 0; s < kNumSlots; ++s) {
    const Entry& e = kEntries[s];
    if (strcmp(base, e.base) != 0 || version < e.min_version ||
        version >= e.end_version)
      continue;
    if (e.stream == kNoStream || e.stream == want) return s;
  }
  return -1;
}

bool is_hook(void* p) {
  for (const Entry& e : kEntries)
    if (e.hook == p) return true;
  return p == reinterpret_cast<void*>(&dlsym);
}

using DlsymFn = void* (*)(void*, const char*);

/* glibc's dlsym: x86-64 and aarch64 versions, newest first. */
DlsymFn real_dlsym() {
  static std::atomic<DlsymFn> fn{nullptr};
  DlsymFn f = fn.load(std::memory_order_acquire);
  if (f != nullptr) return f;
  for (const char* v : {"GLIBC_2.34", "GLIBC_2.2.5", "GLIBC_2.17"}) {
    f = reinterpret_cast<DlsymFn>(dlvsym(RTLD_NEXT, "dlsym", v));
    if (f != nullptr) break;
  }
  if (f == nullptr) {
    fputs("cudaguard: cannot find glibc's dlsym\n", stderr);
    abort();
  }
  fn.store(f, std::memory_order_release);
  return f;
}

/* Record the driver's function behind slot s (first seen wins). */
void remember(int s, void* p) {
  if (p == nullptr || is_hook(p)) return;
  void* none = nullptr;
  g_real[s].compare_exchange_strong(none, p);
}

/* The driver's function behind slot s: what a lookup returned, else the
 * next definition after the guard, else libcuda.so.1's. */
void* real_of(int s) {
  void* p = g_real[s].load(std::memory_order_acquire);
  if (p != nullptr) return p;
  remember(s, real_dlsym()(RTLD_NEXT, kEntries[s].name));
  p = g_real[s].load(std::memory_order_acquire);
  if (p != nullptr) return p;
  void* cuda = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_LOCAL); /* kept open */
  if (cuda != nullptr) remember(s, real_dlsym()(cuda, kEntries[s].name));
  return g_real[s].load(std::memory_order_acquire);
}

template <typename Fn>
Fn real_fn(int s) {
  return reinterpret_cast<Fn>(real_of(s));
}

/* --- the limit and the counters ------------------------------------------- */
int64_t limit() {
  static const int64_t value = [] {
    const char* raw = getenv("TPU_HBM_LIMIT_BYTES");
    if (raw == nullptr || *raw == '\0') return int64_t{-1};
    char* end = nullptr;
    long long v = strtoll(raw, &end, 10);
    /* garbage leaves the guard inert rather than locking it to 0 */
    return end != raw && v >= 0 ? int64_t{v} : int64_t{-1};
  }();
  return value;
}

bool limited() { return limit() >= 0; }

std::atomic<int64_t> g_used{0};
std::atomic<int64_t> g_peak{0};
std::atomic<int64_t> g_refused{0};

/* --- metered table (hbmguard.cpp's, keyed by pointer or handle) ----------- *
 * Open-addressed and lock-free. A slot is claimed with a sentinel, its size
 * written, then the key published, so a reader that matches the key sees
 * its size; removal leaves a tombstone so probe chains stay intact. Keys
 * equal to a sentinel are not metered. */
constexpr int kTableSlots = 65536;
constexpr uint64_t kEmpty = 0;
constexpr uint64_t kTombstone = UINT64_MAX;
constexpr uint64_t kClaim = UINT64_MAX - 1;

struct Table {
  std::atomic<uint64_t> keys[kTableSlots];
  std::atomic<int64_t> sizes[kTableSlots];

  static size_t slot_of(uint64_t k) {
    return (size_t)((k * 11400714819323198485ull) >> 48) & (kTableSlots - 1);
  }

  bool insert(uint64_t k, int64_t sz) {
    if (k == kEmpty || k == kTombstone || k == kClaim) return false;
    size_t i = slot_of(k);
    for (int probe = 0; probe < kTableSlots; ++probe) {
      uint64_t cur = keys[i].load();
      if ((cur == kEmpty || cur == kTombstone) &&
          keys[i].compare_exchange_strong(cur, kClaim)) {
        sizes[i].store(sz);
        keys[i].store(k, std::memory_order_release);
        return true;
      }
      i = (i + 1) & (kTableSlots - 1);
    }
    return false;
  }

  /* The metered size, removing the entry; -1 if never metered. */
  int64_t remove(uint64_t k) {
    size_t i = slot_of(k);
    for (int probe = 0; probe < kTableSlots; ++probe) {
      uint64_t cur = keys[i].load(std::memory_order_acquire);
      if (cur == k) {
        int64_t sz = sizes[i].load();
        if (keys[i].compare_exchange_strong(cur, kTombstone)) return sz;
      }
      if (cur == kEmpty) return -1;
      i = (i + 1) & (kTableSlots - 1);
    }
    return -1;
  }
};

Table g_pointers;  /* device pointers */
Table g_handles;   /* cuMemCreate handles */

/* Count `size` against the limit; false (and one more refusal) when it
 * would pass it. */
bool reserve(size_t size) {
  if (size <= static_cast<size_t>(INT64_MAX)) {
    const int64_t sz = static_cast<int64_t>(size);
    if (g_used.fetch_add(sz) + sz <= limit()) return true;
    g_used.fetch_sub(sz);
  }
  g_refused.fetch_add(1);
  return false;
}

/* Remember a reserved block under its key (table full: unmetered). */
void commit(Table& table, uint64_t key, int64_t size) {
  if (!table.insert(key, size)) {
    g_used.fetch_sub(size);
    return;
  }
  int64_t now = g_used.load();
  int64_t peak = g_peak.load();
  while (now > peak && !g_peak.compare_exchange_weak(peak, now)) {
  }
}

void release(Table& table, uint64_t key) {
  if (!limited()) return;
  int64_t sz = table.remove(key);
  if (sz >= 0) g_used.fetch_sub(sz);
}

/* Reserve, run the driver's allocation, and meter what it wrote to *key. */
template <typename Call>
CUresult metered(Table& table, size_t size, Call call,
                 const unsigned long long* key) {
  if (!limited()) return call();
  if (!reserve(size)) return kOutOfMemory;
  CUresult rc = call();
  if (rc != kSuccess) {
    g_used.fetch_sub(static_cast<int64_t>(size));
    return rc;
  }
  commit(table, *key, static_cast<int64_t>(size));
  return rc;
}

/* cuGetProcAddress's result for a metered name becomes the guard's hook. */
void hook_proc(const char* symbol, void** pfn, int version, cuuint64_t flags) {
  if (symbol == nullptr || pfn == nullptr || *pfn == nullptr) return;
  int s = slot_by_base(symbol, version, flags);
  if (s < 0) return;
  remember(s, *pfn);
  *pfn = kEntries[s].hook;
}

}  // namespace

extern "C" {

/* --- dlsym ----------------------------------------------------------------- */
void* dlsym(void* handle, const char* name) noexcept {
  const int s = slot_by_name(name);
  if (s >= 0) {
    void* p = real_dlsym()(handle, name);
    if (p == nullptr) return nullptr; /* the handle has no such symbol */
    remember(s, p);
    return kEntries[s].hook;
  }
  /* a tail call: glibc's dlsym sees the caller's return address */
  return real_dlsym()(handle, name);
}

/* --- cuGetProcAddress ------------------------------------------------------ */
CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                          cuuint64_t flags) {
  using Fn = CUresult (*)(const char*, void**, int, cuuint64_t);
  Fn real = real_fn<Fn>(kGetProcAddress);
  if (real == nullptr) return kSymbolNotFound;
  CUresult rc = real(symbol, pfn, version, flags);
  if (rc == kSuccess) hook_proc(symbol, pfn, version, flags);
  return rc;
}

CUresult cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                             cuuint64_t flags,
                             CUdriverProcAddressQueryResult* status) {
  using Fn = CUresult (*)(const char*, void**, int, cuuint64_t,
                          CUdriverProcAddressQueryResult*);
  Fn real = real_fn<Fn>(kGetProcAddressV2);
  if (real == nullptr) return kSymbolNotFound;
  CUresult rc = real(symbol, pfn, version, flags, status);
  if (rc == kSuccess) hook_proc(symbol, pfn, version, flags);
  return rc;
}

/* --- allocations ----------------------------------------------------------- */
CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t size) {
  using Fn = CUresult (*)(CUdeviceptr*, size_t);
  Fn real = real_fn<Fn>(kMemAlloc);
  if (real == nullptr) return kSymbolNotFound;
  return metered(g_pointers, size, [&] { return real(dptr, size); }, dptr);
}

CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch, size_t width,
                            size_t height, unsigned elem_size) {
  using Fn = CUresult (*)(CUdeviceptr*, size_t*, size_t, size_t, unsigned);
  Fn real = real_fn<Fn>(kMemAllocPitch);
  if (real == nullptr) return kSymbolNotFound;
  CUresult rc = real(dptr, pitch, width, height, elem_size);
  if (rc != kSuccess || !limited()) return rc;
  /* the size is known only once the driver has chosen the pitch */
  const size_t size = *pitch * height;
  if (!reserve(size)) {
    using FreeFn = CUresult (*)(CUdeviceptr);
    FreeFn real_free = real_fn<FreeFn>(kMemFree);
    if (real_free != nullptr) real_free(*dptr);
    *dptr = 0;
    return kOutOfMemory;
  }
  commit(g_pointers, *dptr, static_cast<int64_t>(size));
  return rc;
}

CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t size, unsigned flags) {
  using Fn = CUresult (*)(CUdeviceptr*, size_t, unsigned);
  Fn real = real_fn<Fn>(kMemAllocManaged);
  if (real == nullptr) return kSymbolNotFound;
  return metered(g_pointers, size, [&] { return real(dptr, size, flags); }, dptr);
}

static CUresult alloc_async(int slot, CUdeviceptr* dptr, size_t size,
                            CUstream stream) {
  using Fn = CUresult (*)(CUdeviceptr*, size_t, CUstream);
  Fn real = real_fn<Fn>(slot);
  if (real == nullptr) return kSymbolNotFound;
  return metered(g_pointers, size, [&] { return real(dptr, size, stream); }, dptr);
}

CUresult cuMemAllocAsync(CUdeviceptr* dptr, size_t size, CUstream stream) {
  return alloc_async(kMemAllocAsync, dptr, size, stream);
}

CUresult cuMemAllocAsync_ptsz(CUdeviceptr* dptr, size_t size, CUstream stream) {
  return alloc_async(kMemAllocAsyncPtsz, dptr, size, stream);
}

static CUresult alloc_from_pool(int slot, CUdeviceptr* dptr, size_t size,
                                CUmemoryPool pool, CUstream stream) {
  using Fn = CUresult (*)(CUdeviceptr*, size_t, CUmemoryPool, CUstream);
  Fn real = real_fn<Fn>(slot);
  if (real == nullptr) return kSymbolNotFound;
  return metered(g_pointers, size,
                 [&] { return real(dptr, size, pool, stream); }, dptr);
}

CUresult cuMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t size,
                                 CUmemoryPool pool, CUstream stream) {
  return alloc_from_pool(kMemAllocFromPoolAsync, dptr, size, pool, stream);
}

CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr* dptr, size_t size,
                                      CUmemoryPool pool, CUstream stream) {
  return alloc_from_pool(kMemAllocFromPoolAsyncPtsz, dptr, size, pool, stream);
}

CUresult cuMemCreate(CUmemGenericAllocationHandle* handle, size_t size,
                     const CUmemAllocationProp* prop, unsigned long long flags) {
  using Fn = CUresult (*)(CUmemGenericAllocationHandle*, size_t,
                          const CUmemAllocationProp*, unsigned long long);
  Fn real = real_fn<Fn>(kMemCreate);
  if (real == nullptr) return kSymbolNotFound;
  auto call = [&] { return real(handle, size, prop, flags); };
  if (prop != nullptr && prop->location_type >= kLocationHost &&
      prop->location_type <= kLocationHostNumaCurrent)
    return call(); /* host memory: not the card's */
  return metered(g_handles, size, call, handle);
}

/* --- frees: un-metered at the call ----------------------------------------- */
CUresult cuMemFree_v2(CUdeviceptr dptr) {
  using Fn = CUresult (*)(CUdeviceptr);
  Fn real = real_fn<Fn>(kMemFree);
  if (real == nullptr) return kSymbolNotFound;
  release(g_pointers, dptr);
  return real(dptr);
}

static CUresult free_async(int slot, CUdeviceptr dptr, CUstream stream) {
  using Fn = CUresult (*)(CUdeviceptr, CUstream);
  Fn real = real_fn<Fn>(slot);
  if (real == nullptr) return kSymbolNotFound;
  release(g_pointers, dptr);
  return real(dptr, stream);
}

CUresult cuMemFreeAsync(CUdeviceptr dptr, CUstream stream) {
  return free_async(kMemFreeAsync, dptr, stream);
}

CUresult cuMemFreeAsync_ptsz(CUdeviceptr dptr, CUstream stream) {
  return free_async(kMemFreeAsyncPtsz, dptr, stream);
}

CUresult cuMemRelease(CUmemGenericAllocationHandle handle) {
  using Fn = CUresult (*)(CUmemGenericAllocationHandle);
  Fn real = real_fn<Fn>(kMemRelease);
  if (real == nullptr) return kSymbolNotFound;
  release(g_handles, handle);
  return real(handle);
}

/* --- the quota as the process sees it -------------------------------------- */
CUresult cuMemGetInfo_v2(size_t* free_bytes, size_t* total_bytes) {
  using Fn = CUresult (*)(size_t*, size_t*);
  Fn real = real_fn<Fn>(kMemGetInfo);
  if (real == nullptr) return kSymbolNotFound;
  CUresult rc = real(free_bytes, total_bytes);
  if (rc == kSuccess && limited() && free_bytes != nullptr) {
    int64_t room = limit() - g_used.load();
    if (room < 0) room = 0;
    if (*free_bytes > static_cast<size_t>(room)) *free_bytes = static_cast<size_t>(room);
  }
  return rc;
}

/* --- introspection --------------------------------------------------------- */
int64_t cudaguard_used(void) { return g_used.load(); }
int64_t cudaguard_limit(void) { return limit(); }
int64_t cudaguard_peak(void) { return g_peak.load(); }
int64_t cudaguard_refused(void) { return g_refused.load(); }

}  // extern "C"
