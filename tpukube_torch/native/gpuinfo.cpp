/* libgpuinfo implementation. See gpuinfo.h for the contract.
 *
 * Ported from tpukube/native/tpuinfo.cpp: the sim backend keeps the
 * reference's spec keys and semantics exactly; the real backend asks NVML
 * in place of the PJRT C API. NVML's prototypes are declared by hand
 * (nvml.h is not needed to build), and the library is opened with dlopen
 * so a machine without a GPU driver still builds and runs the sim.
 */
#include "gpuinfo.h"

#include <dlfcn.h>

#include <algorithm>
#include <array>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

/* --- NVML, declared by hand (nvml.h, ABI-stable since r450) ------------ */
typedef int nvmlReturn_t;  /* NVML_SUCCESS == 0 */
typedef struct nvmlDevice_st* nvmlDevice_t;
typedef struct {
  unsigned long long total;
  unsigned long long free;
  unsigned long long used;
} nvmlMemory_t;
typedef struct {
  unsigned int gpu;     /* percent of the sample period a kernel ran */
  unsigned int memory;  /* percent of it device memory was read or written */
} nvmlUtilization_t;
typedef struct nvmlEventSet_st* nvmlEventSet_t;
typedef struct {
  nvmlDevice_t device;              /* null when NVML cannot attribute it */
  unsigned long long eventType;
  unsigned long long eventData;     /* the XID, for an XID event */
  unsigned int gpuInstanceId;
  unsigned int computeInstanceId;
} nvmlEventData_t;
constexpr unsigned kNvmlNameLen = 96;  /* NVML_DEVICE_NAME_V2_BUFFER_SIZE */
constexpr nvmlReturn_t kNvmlErrorTimeout = 10;  /* NVML_ERROR_TIMEOUT */
constexpr unsigned long long kXidCriticalError = 0x8;  /* nvmlEventTypeXidCriticalError */
/* Application faults, not the GPU's (graphics engine exception, memory
 * page fault, GPU stopped processing, preemptive cleanup, NVDEC0
 * exception): NVIDIA's device plugin keeps the GPU healthy on these. */
constexpr unsigned long long kApplicationXids[] = {13, 31, 43, 45, 68};

struct Nvml {
  void* handle = nullptr;
  nvmlReturn_t (*Init_v2)(void) = nullptr;
  nvmlReturn_t (*Shutdown)(void) = nullptr;
  nvmlReturn_t (*DeviceGetCount_v2)(unsigned*) = nullptr;
  nvmlReturn_t (*DeviceGetHandleByIndex_v2)(unsigned, nvmlDevice_t*) = nullptr;
  nvmlReturn_t (*DeviceGetUUID)(nvmlDevice_t, char*, unsigned) = nullptr;
  nvmlReturn_t (*DeviceGetName)(nvmlDevice_t, char*, unsigned) = nullptr;
  nvmlReturn_t (*DeviceGetMemoryInfo)(nvmlDevice_t, nvmlMemory_t*) = nullptr;
  nvmlReturn_t (*DeviceGetUtilizationRates)(nvmlDevice_t, nvmlUtilization_t*) = nullptr;
  /* XID watch: bound in xid mode only */
  nvmlReturn_t (*EventSetCreate)(nvmlEventSet_t*) = nullptr;
  nvmlReturn_t (*EventSetFree)(nvmlEventSet_t) = nullptr;
  nvmlReturn_t (*DeviceRegisterEvents)(nvmlDevice_t, unsigned long long,
                                       nvmlEventSet_t) = nullptr;
  nvmlReturn_t (*EventSetWait_v2)(nvmlEventSet_t, nvmlEventData_t*, unsigned) = nullptr;
  const char* (*ErrorString)(nvmlReturn_t) = nullptr;  /* optional */
};

enum class ProbeMode { kXid, kLiveness, kOff };

using LinkPair = std::array<int32_t, 6>;  /* ax,ay,az,bx,by,bz, a<=b lex */

struct State {
  bool initialized = false;
  bool is_sim = false;
  gpuinfo_mesh mesh{};
  std::vector<gpuinfo_chip> chips;
  std::vector<LinkPair> bad_links;
  std::string source = "";  /* "sim" | "nvml" */
  Nvml nvml;                /* real backend only; NVML stays initialized */
  ProbeMode probe_mode = ProbeMode::kXid;
  nvmlEventSet_t events = nullptr;  /* xid mode */
  std::vector<nvmlDevice_t> devices;   /* NVML handle of each chip */
  std::vector<std::string> xid_fault; /* sticky: the critical XID seen, or "" */
};

State g_state;
std::string g_last_error = "";

void set_error(const std::string& msg) { g_last_error = msg; }

bool parse_triple(const std::string& val, int32_t out[3]) {
  return std::sscanf(val.c_str(), "%d,%d,%d", &out[0], &out[1], &out[2]) == 3;
}

/* Streaming multiprocessors per GPU, keyed by a part of the NVML device
 * name; the first match wins, so the more specific names come first.
 * (NVIDIA's data sheets: H100 SXM5 and NVL 132 SMs, H100 PCIe 114.) */
struct SmEntry {
  const char* name_part;
  int32_t sms;
};
const SmEntry kSmTable[] = {
    {"H100 PCIe", 114},
    {"H100 NVL", 132},
    {"H100", 132}, /* SXM5, e.g. "NVIDIA H100 80GB HBM3" */
    {"H200", 132},
};

std::vector<std::pair<std::string, std::string>> parse_spec(const char* spec) {
  std::vector<std::pair<std::string, std::string>> kv;
  if (spec == nullptr) return kv;
  std::string s(spec);
  size_t pos = 0;
  while (pos < s.size()) {
    size_t nl = s.find('\n', pos);
    if (nl == std::string::npos) nl = s.size();
    std::string line = s.substr(pos, nl - pos);
    pos = nl + 1;
    while (!line.empty() && (line.back() == '\r' || line.back() == ' '))
      line.pop_back();
    if (line.empty() || line[0] == '#') continue;
    size_t eq = line.find('=');
    if (eq == std::string::npos) continue;
    kv.emplace_back(line.substr(0, eq), line.substr(eq + 1));
  }
  return kv;
}

int init_sim(const char* spec) {
  int32_t dims[3] = {4, 4, 4};
  int32_t host_block[3] = {2, 2, 1};
  int32_t torus[3] = {0, 0, 0};
  std::string host = "host-0-0-0";
  int64_t hbm = 95LL << 30;
  int32_t cores = 2;
  int32_t origin[3] = {0, 0, 0};
  bool have_origin = false;

  for (const auto& [key, val] : parse_spec(spec)) {
    if (key == "dims") {
      if (!parse_triple(val, dims)) { set_error("sim: bad dims: " + val); return -1; }
    } else if (key == "host_block") {
      if (!parse_triple(val, host_block)) { set_error("sim: bad host_block: " + val); return -1; }
    } else if (key == "torus") {
      if (!parse_triple(val, torus)) { set_error("sim: bad torus: " + val); return -1; }
    } else if (key == "host") {
      host = val;
    } else if (key == "origin") {
      if (!parse_triple(val, origin)) { set_error("sim: bad origin: " + val); return -1; }
      have_origin = true;
    } else if (key == "hbm") {
      hbm = std::strtoll(val.c_str(), nullptr, 10);
      if (hbm <= 0) { set_error("sim: bad hbm: " + val); return -1; }
    } else if (key == "cores") {
      cores = std::atoi(val.c_str());
      if (cores <= 0) { set_error("sim: bad cores: " + val); return -1; }
    } else {
      set_error("sim: unknown spec key: " + key);
      return -1;
    }
  }
  for (int a = 0; a < 3; ++a) {
    if (dims[a] <= 0 || host_block[a] <= 0 || dims[a] % host_block[a] != 0) {
      set_error("sim: host_block must divide dims and both be positive");
      return -1;
    }
  }
  if (have_origin) {
    for (int a = 0; a < 3; ++a) {
      if (origin[a] < 0 || origin[a] + host_block[a] > dims[a] ||
          origin[a] % host_block[a] != 0) {
        set_error("sim: origin not host_block-aligned inside dims");
        return -1;
      }
    }
  } else {
    int hg[3];  /* host grid position parsed from the host name */
    if (std::sscanf(host.c_str(), "host-%d-%d-%d", &hg[0], &hg[1], &hg[2]) != 3) {
      set_error("sim: malformed host name (want host-i-j-k, or pass origin=): " + host);
      return -1;
    }
    for (int a = 0; a < 3; ++a) {
      if (hg[a] < 0 || hg[a] >= dims[a] / host_block[a]) {
        set_error("sim: host outside host grid: " + host);
        return -1;
      }
      origin[a] = hg[a] * host_block[a];
    }
  }

  std::memcpy(g_state.mesh.dims, dims, sizeof dims);
  std::memcpy(g_state.mesh.host_block, host_block, sizeof host_block);
  std::memcpy(g_state.mesh.torus, torus, sizeof torus);
  g_state.chips.clear();

  /* x fastest within the host block, as in the reference */
  int32_t idx = 0;
  for (int dz = 0; dz < host_block[2]; ++dz)
    for (int dy = 0; dy < host_block[1]; ++dy)
      for (int dx = 0; dx < host_block[0]; ++dx) {
        gpuinfo_chip c{};
        c.index = idx;
        c.coord[0] = origin[0] + dx;
        c.coord[1] = origin[1] + dy;
        c.coord[2] = origin[2] + dz;
        std::snprintf(c.chip_id, GPUINFO_MAX_ID, "%s-chip-%d", host.c_str(), idx);
        c.hbm_bytes = hbm;
        c.num_cores = cores;
        c.healthy = 1;
        g_state.chips.push_back(c);
        ++idx;
      }
  g_state.is_sim = true;
  g_state.source = "sim";
  return 0;
}

std::string nvml_reason(const Nvml& n, nvmlReturn_t rc) {
  std::string msg = n.ErrorString != nullptr ? n.ErrorString(rc) : "";
  return msg + " (nvmlReturn " + std::to_string(rc) + ")";
}

std::string nvml_error(const Nvml& n, const char* call, nvmlReturn_t rc) {
  return std::string("real: ") + call + " failed: " + nvml_reason(n, rc);
}

/* Open libnvidia-ml and bind the calls this shim makes (the event calls
 * only when `events`). */
bool load_nvml(const std::string& path, bool events, Nvml* n) {
  n->handle = dlopen(path.c_str(), RTLD_LAZY | RTLD_LOCAL);
  if (n->handle == nullptr) {
    set_error(std::string("real: cannot load NVML: ") + dlerror());
    return false;
  }
  struct Sym {
    const char* name;
    void** slot;
  };
  const Sym required[] = {
      {"nvmlInit_v2", reinterpret_cast<void**>(&n->Init_v2)},
      {"nvmlShutdown", reinterpret_cast<void**>(&n->Shutdown)},
      {"nvmlDeviceGetCount_v2", reinterpret_cast<void**>(&n->DeviceGetCount_v2)},
      {"nvmlDeviceGetHandleByIndex_v2",
       reinterpret_cast<void**>(&n->DeviceGetHandleByIndex_v2)},
      {"nvmlDeviceGetUUID", reinterpret_cast<void**>(&n->DeviceGetUUID)},
      {"nvmlDeviceGetName", reinterpret_cast<void**>(&n->DeviceGetName)},
      {"nvmlDeviceGetMemoryInfo", reinterpret_cast<void**>(&n->DeviceGetMemoryInfo)},
      {"nvmlDeviceGetUtilizationRates",
       reinterpret_cast<void**>(&n->DeviceGetUtilizationRates)},
  };
  const Sym event_calls[] = {
      {"nvmlEventSetCreate", reinterpret_cast<void**>(&n->EventSetCreate)},
      {"nvmlEventSetFree", reinterpret_cast<void**>(&n->EventSetFree)},
      {"nvmlDeviceRegisterEvents", reinterpret_cast<void**>(&n->DeviceRegisterEvents)},
      {"nvmlEventSetWait_v2", reinterpret_cast<void**>(&n->EventSetWait_v2)},
  };
  auto bind = [n](const Sym& s) {
    *s.slot = dlsym(n->handle, s.name);
    if (*s.slot != nullptr) return true;
    set_error(std::string("real: NVML lacks ") + s.name);
    dlclose(n->handle);
    *n = Nvml{};
    return false;
  };
  for (const Sym& s : required)
    if (!bind(s)) return false;
  if (events)
    for (const Sym& s : event_calls)
      if (!bind(s)) return false;
  *reinterpret_cast<void**>(&n->ErrorString) = dlsym(n->handle, "nvmlErrorString");
  return true;
}

/* Read one GPU through NVML into `out`; false (error set) on failure. */
bool read_gpu(const Nvml& n, unsigned i, gpuinfo_chip* out) {
  nvmlDevice_t dev = nullptr;
  nvmlReturn_t rc = n.DeviceGetHandleByIndex_v2(i, &dev);
  if (rc != 0) { set_error(nvml_error(n, "nvmlDeviceGetHandleByIndex_v2", rc)); return false; }
  char uuid[GPUINFO_MAX_ID] = {0};
  rc = n.DeviceGetUUID(dev, uuid, sizeof uuid);
  if (rc != 0) { set_error(nvml_error(n, "nvmlDeviceGetUUID", rc)); return false; }
  char name[kNvmlNameLen] = {0};
  rc = n.DeviceGetName(dev, name, sizeof name);
  if (rc != 0) { set_error(nvml_error(n, "nvmlDeviceGetName", rc)); return false; }
  nvmlMemory_t mem{};
  rc = n.DeviceGetMemoryInfo(dev, &mem);
  if (rc != 0) { set_error(nvml_error(n, "nvmlDeviceGetMemoryInfo", rc)); return false; }
  const SmEntry* sm = nullptr;
  for (const auto& e : kSmTable)
    if (std::strstr(name, e.name_part) != nullptr) { sm = &e; break; }
  if (sm == nullptr) {
    set_error(std::string("real: no SM count known for GPU model: ") + name);
    return false;
  }
  *out = gpuinfo_chip{};
  out->index = static_cast<int32_t>(i);
  std::snprintf(out->chip_id, GPUINFO_MAX_ID, "%s", uuid);
  out->coord[0] = static_cast<int32_t>(i);
  out->hbm_bytes = static_cast<int64_t>(mem.total);
  out->num_cores = sm->sms;
  out->healthy = 1;
  return true;
}

int init_real(const char* spec) {
  std::string nvml_path = "libnvidia-ml.so.1";
  ProbeMode mode = ProbeMode::kXid;
  for (const auto& [key, val] : parse_spec(spec)) {
    if (key == "nvml") {
      nvml_path = val;
    } else if (key == "probe") {
      if (val == "xid") mode = ProbeMode::kXid;
      else if (val == "liveness") mode = ProbeMode::kLiveness;
      else if (val == "off") mode = ProbeMode::kOff;
      else { set_error("real: unknown probe mode: " + val); return -1; }
    } else {
      set_error("real: unknown spec key: " + key);
      return -1;
    }
  }
  Nvml n;
  if (!load_nvml(nvml_path, mode == ProbeMode::kXid, &n)) return -1;
  nvmlEventSet_t events = nullptr;
  auto fail = [&n, &events]() {
    if (events != nullptr) n.EventSetFree(events);
    n.Shutdown();
    dlclose(n.handle);
    return -1;
  };
  nvmlReturn_t rc = n.Init_v2();
  if (rc != 0) {
    set_error(nvml_error(n, "nvmlInit_v2", rc));
    dlclose(n.handle);
    return -1;
  }
  unsigned count = 0;
  rc = n.DeviceGetCount_v2(&count);
  if (rc != 0) { set_error(nvml_error(n, "nvmlDeviceGetCount_v2", rc)); return fail(); }
  if (count == 0) { set_error("real: NVML reports no GPUs"); return fail(); }
  std::vector<gpuinfo_chip> chips(count);
  std::vector<nvmlDevice_t> devices(count);
  for (unsigned i = 0; i < count; ++i) {
    if (!read_gpu(n, i, &chips[i])) return fail();
    rc = n.DeviceGetHandleByIndex_v2(i, &devices[i]);
    if (rc != 0) { set_error(nvml_error(n, "nvmlDeviceGetHandleByIndex_v2", rc)); return fail(); }
  }
  if (mode == ProbeMode::kXid) {
    /* KubeGPU's and NVIDIA's health watch. No fallback to liveness: a node
     * that asked for XID health and cannot have it must say so. */
    rc = n.EventSetCreate(&events);
    if (rc != 0) { set_error(nvml_error(n, "nvmlEventSetCreate", rc)); return fail(); }
    for (unsigned i = 0; i < count; ++i) {
      rc = n.DeviceRegisterEvents(devices[i], kXidCriticalError, events);
      if (rc != 0) {
        set_error(nvml_error(n, "nvmlDeviceRegisterEvents", rc) + " for GPU " +
                  std::to_string(i));
        return fail();
      }
    }
  }

  /* GPUs of one node on a line: NVLink/NVSwitch joins them all to all, so
   * the mesh only orders them (coord x == NVML index). */
  const int32_t c = static_cast<int32_t>(count);
  g_state.mesh = gpuinfo_mesh{{c, 1, 1}, {c, 1, 1}, {0, 0, 0}};
  g_state.chips = std::move(chips);
  g_state.is_sim = false;
  g_state.source = "nvml";
  g_state.nvml = n;
  g_state.probe_mode = mode;
  g_state.events = events;
  g_state.devices = std::move(devices);
  g_state.xid_fault.assign(count, "");
  return 0;
}

bool application_xid(unsigned long long xid) {
  for (unsigned long long a : kApplicationXids)
    if (a == xid) return true;
  return false;
}

/* Take every pending NVML event without waiting; mark the GPUs a critical
 * XID names (every GPU, for one NVML cannot attribute or a failed wait). */
void drain_xid_events() {
  const Nvml& n = g_state.nvml;
  auto mark_all = [](const std::string& reason) {
    for (auto& f : g_state.xid_fault) f = reason;
  };
  for (;;) {
    nvmlEventData_t data{};
    nvmlReturn_t rc = n.EventSetWait_v2(g_state.events, &data, 0);
    if (rc == kNvmlErrorTimeout) return;  /* nothing pending */
    if (rc != 0) {
      mark_all("nvmlEventSetWait_v2 failed: " + nvml_reason(n, rc));
      return;
    }
    if (!(data.eventType & kXidCriticalError) || application_xid(data.eventData))
      continue;
    const std::string xid = "critical XID " + std::to_string(data.eventData);
    size_t i = 0;
    while (i < g_state.devices.size() && g_state.devices[i] != data.device) ++i;
    if (i == g_state.devices.size()) {
      mark_all(xid + " on an unattributed device");
    } else {
      g_state.xid_fault[i] = xid;
    }
  }
}

bool mesh_adjacent(const int32_t a[3], const int32_t b[3]) {
  /* Exactly one axis differs, by 1 (or wraps on a torus axis). */
  int diff_axis = -1;
  for (int axis = 0; axis < 3; ++axis) {
    int32_t d = g_state.mesh.dims[axis];
    if (a[axis] < 0 || a[axis] >= d || b[axis] < 0 || b[axis] >= d) return false;
    if (a[axis] == b[axis]) continue;
    if (diff_axis != -1) return false;
    int32_t delta = a[axis] > b[axis] ? a[axis] - b[axis] : b[axis] - a[axis];
    if (delta != 1 && !(g_state.mesh.torus[axis] && delta == d - 1 && d > 1))
      return false;
    diff_axis = axis;
  }
  return diff_axis != -1;
}

}  // namespace

extern "C" {

int gpuinfo_abi_version(void) { return GPUINFO_ABI_VERSION; }

int gpuinfo_init(const char* backend, const char* spec) {
  if (g_state.initialized) {
    set_error("already initialized (call gpuinfo_shutdown first)");
    return -1;
  }
  if (backend == nullptr) {
    set_error("backend is null");
    return -1;
  }
  int rc;
  if (std::strcmp(backend, "sim") == 0) rc = init_sim(spec);
  else if (std::strcmp(backend, "real") == 0) rc = init_real(spec);
  else {
    set_error(std::string("unknown backend: ") + backend);
    return -1;
  }
  if (rc == 0) g_state.initialized = true;
  return rc;
}

int gpuinfo_shutdown(void) {
  if (!g_state.initialized) {
    set_error("not initialized");
    return -1;
  }
  Nvml n = g_state.nvml;
  nvmlEventSet_t events = g_state.events;
  g_state = State{};
  if (events != nullptr) n.EventSetFree(events);
  if (n.handle != nullptr) {
    nvmlReturn_t rc = n.Shutdown();
    std::string err = rc != 0 ? nvml_error(n, "nvmlShutdown", rc) : "";
    dlclose(n.handle);
    if (rc != 0) { set_error(err); return -1; }
  }
  return 0;
}

int gpuinfo_mesh_get(gpuinfo_mesh* out) {
  if (!g_state.initialized) { set_error("not initialized"); return -1; }
  if (out == nullptr) { set_error("out is null"); return -1; }
  *out = g_state.mesh;
  return 0;
}

int gpuinfo_chip_count(void) {
  if (!g_state.initialized) { set_error("not initialized"); return -1; }
  return static_cast<int>(g_state.chips.size());
}

int gpuinfo_chip_get(int32_t index, gpuinfo_chip* out) {
  if (!g_state.initialized) { set_error("not initialized"); return -1; }
  if (out == nullptr) { set_error("out is null"); return -1; }
  if (index < 0 || index >= static_cast<int32_t>(g_state.chips.size())) {
    set_error("chip index out of range");
    return -1;
  }
  *out = g_state.chips[index];
  return 0;
}

int gpuinfo_chip_links(int32_t index, int32_t* out, int32_t max) {
  if (!g_state.initialized) { set_error("not initialized"); return -1; }
  if (out == nullptr && max > 0) { set_error("out is null"); return -1; }
  if (index < 0 || index >= static_cast<int32_t>(g_state.chips.size())) {
    set_error("chip index out of range");
    return -1;
  }
  const gpuinfo_chip& c = g_state.chips[index];
  int n = 0;
  for (int axis = 0; axis < 3; ++axis) {
    int d = g_state.mesh.dims[axis];
    if (d <= 1) continue;
    for (int step = -1; step <= 1; step += 2) {
      int32_t nb[3] = {c.coord[0], c.coord[1], c.coord[2]};
      nb[axis] += step;
      if (nb[axis] < 0 || nb[axis] >= d) {
        if (!g_state.mesh.torus[axis]) continue;
        nb[axis] = (nb[axis] + d) % d;
      }
      /* length-2 torus axis: both steps reach the same chip; dedup */
      bool dup = false;
      for (int j = 0; j < n; ++j)
        if (out[3 * j] == nb[0] && out[3 * j + 1] == nb[1] && out[3 * j + 2] == nb[2])
          dup = true;
      if (dup || (nb[0] == c.coord[0] && nb[1] == c.coord[1] && nb[2] == c.coord[2]))
        continue;
      if (n >= max) { set_error("links buffer too small"); return -1; }
      out[3 * n] = nb[0];
      out[3 * n + 1] = nb[1];
      out[3 * n + 2] = nb[2];
      ++n;
    }
  }
  return n;
}

int gpuinfo_inject_link_fault(int32_t ax, int32_t ay, int32_t az,
                              int32_t bx, int32_t by, int32_t bz,
                              int32_t up) {
  if (!g_state.initialized) { set_error("not initialized"); return -1; }
  if (!g_state.is_sim) {
    set_error("link fault injection is sim-only");
    return -1;
  }
  int32_t a[3] = {ax, ay, az};
  int32_t b[3] = {bx, by, bz};
  if (!mesh_adjacent(a, b)) {
    set_error("link endpoints are not mesh-adjacent chips");
    return -1;
  }
  LinkPair p;
  bool a_first = std::lexicographical_compare(a, a + 3, b, b + 3);
  const int32_t* lo = a_first ? a : b;
  const int32_t* hi = a_first ? b : a;
  for (int i = 0; i < 3; ++i) { p[i] = lo[i]; p[3 + i] = hi[i]; }
  auto& v = g_state.bad_links;
  for (auto it = v.begin(); it != v.end(); ++it) {
    if (*it == p) {
      if (up) v.erase(it);
      return 0;  /* already down, or just restored */
    }
  }
  if (!up) v.push_back(p);
  return 0;
}

int gpuinfo_link_faults(int32_t* out, int32_t max) {
  if (!g_state.initialized) { set_error("not initialized"); return -1; }
  if (out == nullptr && max > 0) { set_error("out is null"); return -1; }
  int32_t n = static_cast<int32_t>(g_state.bad_links.size());
  int32_t write = n < max ? n : max;
  for (int32_t i = 0; i < write; ++i)
    std::memcpy(out + 6 * i, g_state.bad_links[i].data(), 6 * sizeof(int32_t));
  return n;
}

int gpuinfo_inject_fault(int32_t index, int32_t healthy) {
  if (!g_state.initialized) { set_error("not initialized"); return -1; }
  if (!g_state.is_sim) {
    set_error("fault injection is sim-only");
    return -1;
  }
  if (index < 0 || index >= static_cast<int32_t>(g_state.chips.size())) {
    set_error("chip index out of range");
    return -1;
  }
  g_state.chips[index].healthy = healthy ? 1 : 0;
  return 0;
}

const char* gpuinfo_last_error(void) { return g_last_error.c_str(); }

const char* gpuinfo_source(void) { return g_state.source.c_str(); }

int gpuinfo_probe(void) {
  if (!g_state.initialized) { set_error("not initialized"); return -1; }
  if (g_state.is_sim || g_state.probe_mode == ProbeMode::kOff) return 1;
  const Nvml& n = g_state.nvml;
  if (g_state.probe_mode == ProbeMode::kXid) drain_xid_events();
  int ok = 1;
  std::string why;
  for (auto& c : g_state.chips) {
    const std::string gpu = " GPU " + std::to_string(c.index) + ": ";
    nvmlDevice_t dev = nullptr;
    nvmlMemory_t mem{};
    nvmlReturn_t rc = n.DeviceGetHandleByIndex_v2(static_cast<unsigned>(c.index), &dev);
    if (rc == 0) rc = n.DeviceGetMemoryInfo(dev, &mem);
    if (rc != 0) why += gpu + nvml_reason(n, rc) + ";";
    const std::string& xid = g_state.xid_fault[c.index];
    if (!xid.empty()) why += gpu + xid + ";";
    c.healthy = rc == 0 && xid.empty() ? 1 : 0;
    if (!c.healthy) ok = 0;
  }
  if (!ok) set_error("probe failed:" + why);
  return ok;
}

int gpuinfo_chip_telemetry(int32_t index, uint32_t* util_percent,
                           uint64_t* mem_used) {
  if (!g_state.initialized) { set_error("not initialized"); return -1; }
  if (g_state.is_sim) { set_error("telemetry needs the real backend"); return -1; }
  if (util_percent == nullptr || mem_used == nullptr) { set_error("out is null"); return -1; }
  if (index < 0 || index >= static_cast<int32_t>(g_state.chips.size())) {
    set_error("chip index out of range");
    return -1;
  }
  const Nvml& n = g_state.nvml;
  nvmlDevice_t dev = g_state.devices[index];
  nvmlUtilization_t util{};
  nvmlReturn_t rc = n.DeviceGetUtilizationRates(dev, &util);
  if (rc != 0) { set_error(nvml_error(n, "nvmlDeviceGetUtilizationRates", rc)); return -1; }
  nvmlMemory_t mem{};
  rc = n.DeviceGetMemoryInfo(dev, &mem);
  if (rc != 0) { set_error(nvml_error(n, "nvmlDeviceGetMemoryInfo", rc)); return -1; }
  *util_percent = util.gpu;
  *mem_used = mem.used;
  return 0;
}

}  // extern "C"
