/* libgpuinfo — native GPU enumeration shim (C ABI).
 *
 * The GPU counterpart of tpukube/native/tpuinfo.h, with the same shape so
 * the device manager ports line for line: chip struct, mesh struct,
 * init/shutdown/count/get/links/link-faults/inject/probe/source/last_error.
 *
 * Two backends, selected at init:
 *   "sim"  — topology from a key=value spec, with the same keys and
 *            semantics as libtpuinfo's sim backend (the CPU tests hold the
 *            two against each other).
 *   "real" — NVML, reached through dlopen("libnvidia-ml.so.1"): device
 *            count, UUID, name and total memory. The SM count comes from a
 *            table keyed by the NVML device name. GPUs sit on a line,
 *            coord (i,0,0), no torus. There is no fallback: NVML serves
 *            many clients at once, so an NVML failure is an error.
 *
 * Consumed from Python via ctypes (tpukube_torch/native/gpuinfo.py). All
 * calls return 0 on success, -1 on error; gpuinfo_last_error() describes
 * the failure. Not thread-safe: the Python wrapper serializes calls.
 */
#ifndef TPUKUBE_TORCH_GPUINFO_H
#define TPUKUBE_TORCH_GPUINFO_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define GPUINFO_ABI_VERSION 1
/* NVML_DEVICE_UUID_V2_BUFFER_SIZE: a UUID fits with room to spare */
#define GPUINFO_MAX_ID 96

typedef struct {
  int32_t index;              /* node-local index == NVML index */
  char chip_id[GPUINFO_MAX_ID];  /* NVML UUID ("GPU-...") on real */
  int32_t coord[3];           /* mesh coordinate (x, y, z) */
  int64_t hbm_bytes;          /* NVML total device memory on real */
  int32_t num_cores;          /* streaming multiprocessors on real */
  int32_t healthy;            /* 1 healthy, 0 unhealthy */
} gpuinfo_chip;

typedef struct {
  int32_t dims[3];
  int32_t host_block[3];
  int32_t torus[3];
} gpuinfo_mesh;

int gpuinfo_abi_version(void);

/* backend: "sim" or "real".
 * Sim spec keys: dims=X,Y,Z  host_block=X,Y,Z  torus=0|1,0|1,0|1
 *                host=host-i-j-k  origin=X,Y,Z  hbm=<bytes>  cores=<n>
 * Real spec keys (optional): nvml=<path of libnvidia-ml> (default: the
 *                loader's libnvidia-ml.so.1)
 */
int gpuinfo_init(const char* backend, const char* spec);
int gpuinfo_shutdown(void);

int gpuinfo_mesh_get(gpuinfo_mesh* out);
int gpuinfo_chip_count(void);
int gpuinfo_chip_get(int32_t index, gpuinfo_chip* out);

/* Link table: write up to max neighbor coords (x,y,z triples) of chip
 * `index` into out (length 3*max). Returns the neighbor count, or -1. */
int gpuinfo_chip_links(int32_t index, int32_t* out, int32_t max);

/* Health manipulation — the sim analog of an NVML XID event (sim only). */
int gpuinfo_inject_fault(int32_t index, int32_t healthy);

/* Link faults: an unordered pair of mesh-adjacent chip coords whose link
 * is down. inject (sim only): up=0 marks the link down, up=1 restores it.
 * faults: write up to `max` downed links into out (6 ints each, pair
 * canonicalized a<=b lexicographically). Returns the total count (may
 * exceed max; callers re-ask), or -1. */
int gpuinfo_inject_link_fault(int32_t ax, int32_t ay, int32_t az,
                              int32_t bx, int32_t by, int32_t bz,
                              int32_t up);
int gpuinfo_link_faults(int32_t* out, int32_t max);

const char* gpuinfo_last_error(void);

/* Where the current inventory came from: "sim" or "nvml". Empty string
 * before init. */
const char* gpuinfo_source(void);

/* Liveness re-probe. Real backend: each GPU is healthy while NVML still
 * hands out its handle and answers its memory query; returns 1 when every
 * GPU passed, 0 when any failed (those are marked unhealthy), -1 on error.
 * Sim backend: no-op, returns 1. */
int gpuinfo_probe(void);

#ifdef __cplusplus
}
#endif

#endif /* TPUKUBE_TORCH_GPUINFO_H */
