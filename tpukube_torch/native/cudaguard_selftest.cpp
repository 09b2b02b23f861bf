/* Self-test of libcudaguard over cuda_stub (a stand-in libcuda.so.1).
 *
 *   LD_PRELOAD=libcudaguard.so [TPU_HBM_LIMIT_BYTES=...] \
 *       cudaguard_selftest <route> <case>
 *
 * route — how the process reaches the driver, as real processes do:
 *   direct  calls the driver's symbols (this binary links the stub);
 *   dlsym   dlopen("libcuda.so.1") and dlsym on the handle;
 *   proc    cuGetProcAddress_v2 (itself from dlsym), as cudart does.
 * case — what is checked (the limit each needs is in its comment):
 *   accumulate  100 MiB: 32 MiB at a time, the 4th refused before the driver
 *   free        100 MiB: a free returns its quota; the limit is inclusive
 *   inert       none: nothing metered, nothing refused
 *   getinfo     100 MiB: free = min(driver free, limit - used), total kept
 *   kinds       64 MiB: pitch, managed, async, pool, create, each metered
 *   foreign     100 MiB: frees the guard never metered leave the count
 *   config3     the share's quota on a 256 MiB card: 64 MiB fits, 200 not
 *   next        any: RTLD_NEXT keeps the caller's meaning through the guard
 * Prints "ok <route> <case>" and exits 0, or names the failed check and
 * exits 1.
 */
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <string>

extern "C" {
typedef int CUresult;
typedef unsigned long long CUdeviceptr;
typedef struct CUstream_st* CUstream;
typedef struct CUmemPoolHandle_st* CUmemoryPool;
typedef unsigned long long CUmemGenericAllocationHandle;
typedef unsigned long long cuuint64_t;
typedef struct {
  int type;
  int requestedHandleTypes;
  int location_type;
  int location_id;
  void* win32HandleMetaData;
  unsigned char allocFlags[8];
} CUmemAllocationProp;

/* the driver, as linked (route direct) */
CUresult cuInit(unsigned flags);
CUresult cuMemAlloc_v2(CUdeviceptr*, size_t);
CUresult cuMemAllocPitch_v2(CUdeviceptr*, size_t*, size_t, size_t, unsigned);
CUresult cuMemAllocManaged(CUdeviceptr*, size_t, unsigned);
CUresult cuMemAllocAsync(CUdeviceptr*, size_t, CUstream);
CUresult cuMemAllocAsync_ptsz(CUdeviceptr*, size_t, CUstream);
CUresult cuMemAllocFromPoolAsync(CUdeviceptr*, size_t, CUmemoryPool, CUstream);
CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr*, size_t, CUmemoryPool, CUstream);
CUresult cuMemCreate(CUmemGenericAllocationHandle*, size_t, const CUmemAllocationProp*,
                     unsigned long long);
CUresult cuMemFree_v2(CUdeviceptr);
CUresult cuMemFreeAsync(CUdeviceptr, CUstream);
CUresult cuMemFreeAsync_ptsz(CUdeviceptr, CUstream);
CUresult cuMemRelease(CUmemGenericAllocationHandle);
CUresult cuMemGetInfo_v2(size_t*, size_t*);

/* the stub's test hooks */
int cuda_stub_calls(const char* name);
CUresult cuda_stub_alloc_raw(CUdeviceptr* dptr, size_t size);
void cuda_stub_hold(size_t bytes);
}

namespace {

constexpr size_t MiB = size_t{1} << 20;
constexpr CUresult kOutOfMemory = 2;

struct Driver {
  CUresult (*alloc)(CUdeviceptr*, size_t);
  CUresult (*pitch)(CUdeviceptr*, size_t*, size_t, size_t, unsigned);
  CUresult (*managed)(CUdeviceptr*, size_t, unsigned);
  CUresult (*async)(CUdeviceptr*, size_t, CUstream);
  CUresult (*async_ptsz)(CUdeviceptr*, size_t, CUstream);
  CUresult (*pool)(CUdeviceptr*, size_t, CUmemoryPool, CUstream);
  CUresult (*pool_ptsz)(CUdeviceptr*, size_t, CUmemoryPool, CUstream);
  CUresult (*create)(CUmemGenericAllocationHandle*, size_t, const CUmemAllocationProp*,
                     unsigned long long);
  CUresult (*free)(CUdeviceptr);
  CUresult (*free_async)(CUdeviceptr, CUstream);
  CUresult (*free_async_ptsz)(CUdeviceptr, CUstream);
  CUresult (*release)(CUmemGenericAllocationHandle);
  CUresult (*get_info)(size_t*, size_t*);
};

struct Guard {
  int64_t (*used)(void);
  int64_t (*limit)(void);
  int64_t (*peak)(void);
  int64_t (*refused)(void);
};

int g_failed = 0;

#define CHECK(cond)                                                       \
  do {                                                                    \
    if (!(cond)) {                                                        \
      printf("FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond);              \
      g_failed = 1;                                                       \
    }                                                                     \
  } while (0)

template <typename T>
T sym(void* handle, const char* name) {
  void* p = dlsym(handle, name);
  if (p == nullptr) {
    printf("FAIL: no symbol %s\n", name);
    exit(1);
  }
  return reinterpret_cast<T>(p);
}

using GetProcV2 = CUresult (*)(const char*, void**, int, cuuint64_t, int*);
using GetProcV1 = CUresult (*)(const char*, void**, int, cuuint64_t);

template <typename T>
T proc(GetProcV2 gpa, const char* base, cuuint64_t flags = 0, int version = 12080) {
  void* p = nullptr;
  int status = -1;
  CUresult rc = gpa(base, &p, version, flags, &status);
  if (rc != 0 || p == nullptr || status != 0) {
    printf("FAIL: cuGetProcAddress_v2(%s) = %d\n", base, rc);
    exit(1);
  }
  return reinterpret_cast<T>(p);
}

Driver driver_for(const std::string& route, void* cuda) {
  if (route == "direct")
    return {cuMemAlloc_v2, cuMemAllocPitch_v2, cuMemAllocManaged, cuMemAllocAsync,
            cuMemAllocAsync_ptsz, cuMemAllocFromPoolAsync, cuMemAllocFromPoolAsync_ptsz,
            cuMemCreate, cuMemFree_v2, cuMemFreeAsync, cuMemFreeAsync_ptsz,
            cuMemRelease, cuMemGetInfo_v2};
  if (route == "dlsym") {
    Driver d;
    d.alloc = sym<decltype(d.alloc)>(cuda, "cuMemAlloc_v2");
    d.pitch = sym<decltype(d.pitch)>(cuda, "cuMemAllocPitch_v2");
    d.managed = sym<decltype(d.managed)>(cuda, "cuMemAllocManaged");
    d.async = sym<decltype(d.async)>(cuda, "cuMemAllocAsync");
    d.async_ptsz = sym<decltype(d.async_ptsz)>(cuda, "cuMemAllocAsync_ptsz");
    d.pool = sym<decltype(d.pool)>(cuda, "cuMemAllocFromPoolAsync");
    d.pool_ptsz = sym<decltype(d.pool_ptsz)>(cuda, "cuMemAllocFromPoolAsync_ptsz");
    d.create = sym<decltype(d.create)>(cuda, "cuMemCreate");
    d.free = sym<decltype(d.free)>(cuda, "cuMemFree_v2");
    d.free_async = sym<decltype(d.free_async)>(cuda, "cuMemFreeAsync");
    d.free_async_ptsz = sym<decltype(d.free_async_ptsz)>(cuda, "cuMemFreeAsync_ptsz");
    d.release = sym<decltype(d.release)>(cuda, "cuMemRelease");
    d.get_info = sym<decltype(d.get_info)>(cuda, "cuMemGetInfo_v2");
    return d;
  }
  if (route == "proc") {
    auto gpa = sym<GetProcV2>(cuda, "cuGetProcAddress_v2");
    constexpr cuuint64_t kPtsz = 2;
    Driver d;
    d.alloc = proc<decltype(d.alloc)>(gpa, "cuMemAlloc");
    d.pitch = proc<decltype(d.pitch)>(gpa, "cuMemAllocPitch");
    d.managed = proc<decltype(d.managed)>(gpa, "cuMemAllocManaged");
    d.async = proc<decltype(d.async)>(gpa, "cuMemAllocAsync");
    d.async_ptsz = proc<decltype(d.async_ptsz)>(gpa, "cuMemAllocAsync", kPtsz);
    d.pool = proc<decltype(d.pool)>(gpa, "cuMemAllocFromPoolAsync");
    d.pool_ptsz = proc<decltype(d.pool_ptsz)>(gpa, "cuMemAllocFromPoolAsync", kPtsz);
    d.create = proc<decltype(d.create)>(gpa, "cuMemCreate");
    d.free = proc<decltype(d.free)>(gpa, "cuMemFree", kPtsz);  /* no _ptsz: legacy */
    d.free_async = proc<decltype(d.free_async)>(gpa, "cuMemFreeAsync");
    d.free_async_ptsz = proc<decltype(d.free_async_ptsz)>(gpa, "cuMemFreeAsync", kPtsz);
    d.release = proc<decltype(d.release)>(gpa, "cuMemRelease");
    /* the v1 cuGetProcAddress, asked for through v2 at a CUDA 11 version */
    auto gpa1 = proc<GetProcV1>(gpa, "cuGetProcAddress", 0, 11080);
    void* p = nullptr;
    CHECK(gpa1("cuMemGetInfo", &p, 11080, 0) == 0 && p != nullptr);
    d.get_info = reinterpret_cast<decltype(d.get_info)>(p);
    /* unmetered names pass through untouched */
    CHECK(proc<void*>(gpa, "cuInit") == dlsym(cuda, "cuInit"));
    return d;
  }
  printf("FAIL: unknown route %s\n", route.c_str());
  exit(1);
}

CUmemAllocationProp device_prop(int location_type = 1 /* DEVICE */) {
  CUmemAllocationProp p{};
  p.type = 1; /* CU_MEM_ALLOCATION_TYPE_PINNED */
  p.location_type = location_type;
  return p;
}

void case_accumulate(const Driver& d, const Guard& g) {
  CHECK(g.limit() == int64_t(100 * MiB));
  CUdeviceptr p[10] = {};
  int fitted = 0;
  CUresult rc = 0;
  for (; fitted < 10; ++fitted) {
    rc = d.alloc(&p[fitted], 32 * MiB);
    if (rc != 0) break;
  }
  CHECK(fitted == 3 && rc == kOutOfMemory);
  CHECK(g.used() == int64_t(96 * MiB) && g.peak() == int64_t(96 * MiB));
  CHECK(g.refused() == 1);
  CHECK(cuda_stub_calls("cuMemAlloc_v2") == 3);  /* refused before the driver */
  for (int i = 0; i < fitted; ++i) CHECK(d.free(p[i]) == 0);
  CHECK(g.used() == 0 && g.peak() == int64_t(96 * MiB));
}

void case_free(const Driver& d, const Guard& g) {
  CUdeviceptr p[4] = {};
  for (int i = 0; i < 3; ++i) CHECK(d.alloc(&p[i], 32 * MiB) == 0);
  CHECK(d.free(p[1]) == 0);
  CHECK(g.used() == int64_t(64 * MiB));
  CHECK(d.alloc(&p[1], 32 * MiB) == 0);
  CHECK(d.alloc(&p[3], 32 * MiB) == kOutOfMemory);
  for (int i = 0; i < 3; ++i) CHECK(d.free(p[i]) == 0);
  CHECK(g.used() == 0);
  CHECK(d.alloc(&p[0], 100 * MiB) == 0);  /* the limit itself fits */
  CHECK(d.alloc(&p[1], 1) == kOutOfMemory);
  CHECK(d.free(p[0]) == 0);
  CHECK(g.used() == 0 && g.refused() == 2);
}

void case_inert(const Driver& d, const Guard& g) {
  CHECK(g.limit() == -1);
  CUdeviceptr p[3] = {};
  for (auto& q : p) CHECK(d.alloc(&q, 300 * MiB) == 0);
  size_t free_b = 0, total_b = 0;
  CHECK(d.get_info(&free_b, &total_b) == 0);
  CHECK(total_b == 1024 * MiB && free_b == 124 * MiB);
  CHECK(g.used() == 0 && g.refused() == 0 && g.peak() == 0);
  for (auto q : p) CHECK(d.free(q) == 0);
}

void case_getinfo(const Driver& d, const Guard& g) {
  size_t free_b = 0, total_b = 0;
  CHECK(d.get_info(&free_b, &total_b) == 0);
  CHECK(free_b == 100 * MiB && total_b == 1024 * MiB);
  CUdeviceptr p = 0;
  CHECK(d.alloc(&p, 32 * MiB) == 0);
  CHECK(d.get_info(&free_b, &total_b) == 0);
  CHECK(free_b == 68 * MiB && total_b == 1024 * MiB);
  cuda_stub_hold(1024 * MiB - 32 * MiB - 50 * MiB);  /* the card fills up */
  CHECK(d.get_info(&free_b, &total_b) == 0);
  CHECK(free_b == 50 * MiB && total_b == 1024 * MiB);
  cuda_stub_hold(0);
  CHECK(d.free(p) == 0);
  CHECK(g.used() == 0);
}

void case_kinds(const Driver& d, const Guard& g) {
  const size_t n = 16 * MiB, over = 80 * MiB;
  CUdeviceptr p = 0;
  int64_t refused = g.refused();
  /* each kind: metered while live, released by its own free, refused over */
  struct Kind {
    const char* name;
    CUresult (*make)(const Driver&, CUdeviceptr*, size_t);
    CUresult (*drop)(const Driver&, CUdeviceptr);
  };
  const Kind kinds[] = {
      {"cuMemAlloc_v2", [](const Driver& d, CUdeviceptr* p, size_t n) { return d.alloc(p, n); },
       [](const Driver& d, CUdeviceptr p) { return d.free(p); }},
      {"cuMemAllocManaged",
       [](const Driver& d, CUdeviceptr* p, size_t n) { return d.managed(p, n, 1); },
       [](const Driver& d, CUdeviceptr p) { return d.free(p); }},
      {"cuMemAllocAsync",
       [](const Driver& d, CUdeviceptr* p, size_t n) { return d.async(p, n, nullptr); },
       [](const Driver& d, CUdeviceptr p) { return d.free_async(p, nullptr); }},
      {"cuMemAllocAsync_ptsz",
       [](const Driver& d, CUdeviceptr* p, size_t n) { return d.async_ptsz(p, n, nullptr); },
       [](const Driver& d, CUdeviceptr p) { return d.free_async_ptsz(p, nullptr); }},
      {"cuMemAllocFromPoolAsync",
       [](const Driver& d, CUdeviceptr* p, size_t n) { return d.pool(p, n, nullptr, nullptr); },
       [](const Driver& d, CUdeviceptr p) { return d.free_async(p, nullptr); }},
      {"cuMemAllocFromPoolAsync_ptsz",
       [](const Driver& d, CUdeviceptr* p, size_t n) {
         return d.pool_ptsz(p, n, nullptr, nullptr);
       },
       [](const Driver& d, CUdeviceptr p) { return d.free_async_ptsz(p, nullptr); }},
      {"cuMemCreate",
       [](const Driver& d, CUdeviceptr* p, size_t n) {
         CUmemAllocationProp prop = device_prop();
         return d.create(p, n, &prop, 0);
       },
       [](const Driver& d, CUdeviceptr p) { return d.release(p); }},
  };
  for (const Kind& k : kinds) {
    const int calls = cuda_stub_calls(k.name);
    CHECK(k.make(d, &p, n) == 0);
    if (g.used() != int64_t(n)) printf("FAIL: %s not metered\n", k.name), g_failed = 1;
    CHECK(cuda_stub_calls(k.name) == calls + 1);  /* the right variant ran */
    CHECK(k.drop(d, p) == 0);
    CHECK(g.used() == 0);
    if (k.make(d, &p, over) != kOutOfMemory)
      printf("FAIL: %s over quota not refused\n", k.name), g_failed = 1;
    CHECK(g.refused() == ++refused);
    CHECK(cuda_stub_calls(k.name) == calls + 1);
  }
  /* pitch: metered by pitch x height, which the driver chooses */
  size_t pitch = 0;
  CHECK(d.pitch(&p, &pitch, 1000, 4096, 4) == 0);
  CHECK(pitch == 1024 && g.used() == int64_t(1024 * 4096));
  CHECK(d.free(p) == 0);
  CHECK(d.pitch(&p, &pitch, 1000, 80 * 1024, 4) == kOutOfMemory && p == 0);
  CHECK(g.used() == 0 && g.refused() == ++refused);
  /* host memory from cuMemCreate is not the card's */
  CUmemAllocationProp host = device_prop(2 /* HOST */);
  CUmemGenericAllocationHandle h = 0;
  CHECK(d.create(&h, over, &host, 0) == 0);
  CHECK(g.used() == 0);
  CHECK(d.release(h) == 0);
  CHECK(g.peak() == int64_t(n));
}

void case_foreign(const Driver& d, const Guard& g) {
  CUdeviceptr foreign = 0, mine = 0;
  CHECK(cuda_stub_alloc_raw(&foreign, 50 * MiB) == 0);
  CHECK(d.alloc(&mine, 32 * MiB) == 0);
  CHECK(d.free(foreign) == 0);             /* the driver frees it ... */
  CHECK(g.used() == int64_t(32 * MiB));    /* ... the count does not move */
  CHECK(d.free(0xdead0000ull) != 0);
  CHECK(d.release(0xdead0000ull) != 0);
  CHECK(d.free_async(0xdead0000ull, nullptr) != 0);
  CHECK(g.used() == int64_t(32 * MiB));
  CHECK(d.free(mine) == 0);
  CHECK(g.used() == 0);
}

void case_config3(const Driver& d, const Guard& g) {
  CHECK(g.limit() == int64_t(128 * MiB));
  CUdeviceptr p = 0;
  CHECK(d.alloc(&p, 64 * MiB) == 0);
  CHECK(d.free(p) == 0);
  CHECK(d.alloc(&p, 200 * MiB) == kOutOfMemory);
  CHECK(g.used() == 0 && g.refused() == 1);
}

/* The file name (without its directory) of the object defining `p`. */
const char* object_of(void* p) {
  Dl_info info{};
  if (p == nullptr || dladdr(p, &info) == 0 || info.dli_fname == nullptr) return "";
  const char* slash = strrchr(info.dli_fname, '/');
  return slash != nullptr ? slash + 1 : info.dli_fname;
}

void case_next() {
  /* The guard is the object after this binary, so RTLD_NEXT from here finds
   * the guard's dlsym: glibc saw this binary as the caller. */
  CHECK(strcmp(object_of(dlsym(RTLD_NEXT, "dlsym")), "libcudaguard.so") == 0);
  /* an unmetered name resolves to the driver itself */
  CHECK(strcmp(object_of(dlsym(RTLD_DEFAULT, "cuInit")), "libcuda.so.1") == 0);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: %s <direct|dlsym|proc> <case>\n", argv[0]);
    return 2;
  }
  const std::string route = argv[1], which = argv[2];
  Guard g;
  g.used = reinterpret_cast<int64_t (*)(void)>(dlsym(RTLD_DEFAULT, "cudaguard_used"));
  g.limit = reinterpret_cast<int64_t (*)(void)>(dlsym(RTLD_DEFAULT, "cudaguard_limit"));
  g.peak = reinterpret_cast<int64_t (*)(void)>(dlsym(RTLD_DEFAULT, "cudaguard_peak"));
  g.refused = reinterpret_cast<int64_t (*)(void)>(dlsym(RTLD_DEFAULT, "cudaguard_refused"));
  if (!g.used || !g.limit || !g.peak || !g.refused) {
    printf("FAIL: the guard is not loaded (LD_PRELOAD)\n");
    return 1;
  }
  CHECK(cuInit(0) == 0);
  void* cuda = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_LOCAL);
  if (cuda == nullptr) {
    printf("FAIL: dlopen libcuda.so.1: %s\n", dlerror());
    return 1;
  }
  const Driver d = driver_for(route, cuda);
  if (which == "accumulate") case_accumulate(d, g);
  else if (which == "free") case_free(d, g);
  else if (which == "inert") case_inert(d, g);
  else if (which == "getinfo") case_getinfo(d, g);
  else if (which == "kinds") case_kinds(d, g);
  else if (which == "foreign") case_foreign(d, g);
  else if (which == "config3") case_config3(d, g);
  else if (which == "next") case_next();
  else {
    printf("FAIL: unknown case %s\n", which.c_str());
    return 1;
  }
  dlclose(cuda);
  if (g_failed) return 1;
  printf("ok %s %s\n", route.c_str(), which.c_str());
  return 0;
}
