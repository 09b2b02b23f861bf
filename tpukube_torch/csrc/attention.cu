// Causal grouped-query attention's forward for Hopper (sm_90a): scores and
// probabilities stay on chip, the S x S matrix never reaches device memory.
//
// Built by tpukube_torch/kernels/attention.py into one shared library a
// head-dim pair, with a plain C interface loaded through ctypes:
//   nvcc -O3 -std=c++17 -gencode=arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
//        -DTK_DQ=<dq> -DTK_DV=<dv> -DTK_BM=128 -DTK_BN=<keys a tile> -DTK_STAGES=<tiles of k and v>
// The module's docstring is the design note: what bounds the kernel, what
// the design does about it, and where it rounds.
//
// A block takes BM = 128 query rows of one (sample, head): two consumer
// warpgroups of 64 rows each and one producer warp. The producer loads q's
// tile once and k's and v's tiles of BN keys, up to the diagonal only, with
// the Tensor Memory Accelerator into a ring of STAGES stages in shared
// memory; an mbarrier a stage says a tile has landed, another that both
// warpgroups are done with it. Each warpgroup computes its scores with
// wgmma from shared memory (q and k both K-major), keeps the online softmax
// in registers, and multiplies its bf16 probabilities, still in registers,
// by v (MN-major in shared memory). Shared tiles are rows of 128 bytes
// (64 values) in Hopper's 128-byte swizzle, the layout wgmma reads; a head
// dim is padded with zeros to whole rows (the TMA fills what lies past a
// tensor's edge with zeros), which adds nothing to a sum.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(TK_DQ) || !defined(TK_DV) || !defined(TK_BM) || !defined(TK_BN) || !defined(TK_STAGES)
#error "build with -DTK_DQ, -DTK_DV, -DTK_BM, -DTK_BN and -DTK_STAGES (tpukube_torch/kernels/attention.py)"
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int DQ = TK_DQ, DV = TK_DV, BM = TK_BM, BN = TK_BN, STAGES = TK_STAGES;
// a warpgroup of 128 threads a 64 rows, and one producer warp
constexpr int CONSUMERS = 2 * BM, THREADS = CONSUMERS + 32;
// head dims padded to whole 128-byte rows
constexpr int DQP = (DQ + 63) / 64 * 64, DVP = (DV + 63) / 64 * 64;
constexpr int Q_BYTES = BM * DQP * 2, K_BYTES = BN * DQP * 2, V_BYTES = BN * DVP * 2;
constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
// q's tile, the stages of k and v, and room to align the base to 1,024 bytes
constexpr int SMEM_BYTES = Q_BYTES + STAGES * STAGE_BYTES + 1024;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BN == 64 || BN == 128, "a key tile is 64 or 128 keys");
static_assert(BM == 128, "two warpgroups");
static_assert(STAGES >= 2, "at least two stages");
static_assert(DQ % 8 == 0 && DQ <= 256 && DV % 8 == 0 && DV <= 128, "head dims");

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  // two values rounded to bf16 (to nearest, ties to even) in one conversion
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ float lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// the producer's arrival, and the bytes its copies will bring
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of the tensor map ``map`` (64 values x 1 head x rows x 1 sample)
// at coordinates (d, head, token, sample) into shared memory at ``dst``;
// ``bar`` counts its bytes in.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d, int head, int token,
                                         int sample) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head), "r"(token), "r"(sample)
      : "memory");
}

// A shared-memory matrix descriptor for wgmma in the 128-byte swizzle: the
// start address, the leading and the stride byte offsets, all in 16 bytes.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// wgmma, m64 x n x k16, bf16 in, f32 accumulators: a and b both K-major in
// shared memory (wgmma_ss), or a in registers and b MN-major in shared
// memory (wgmma_rs). An overload a width (n = 2 x the accumulators).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// Keep the compiler from moving other work across an accumulator's wgmma.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// QK^T of this warpgroup's 64 rows against the key tile at ``kt``, into s.
__device__ __forceinline__ void start_scores(float (&s)[BN / 2], uint32_t sq, uint32_t kt, int wg) {
#pragma unroll
  for (int ks = 0; ks < DQP / 16; ++ks) {
    const uint32_t qa = sq + (ks >> 2) * (BM * 128) + wg * (64 * 128) + (ks & 3) * 32;
    const uint32_t ka = kt + (ks >> 2) * (BN * 128) + (ks & 3) * 32;
    wgmma_ss(s, descriptor(qa, 16, 1024), descriptor(ka, 16, 1024), ks);
  }
}

// o += P V for the value tile at ``vt`` (MN-major: 8-key groups 1,024 bytes
// apart, 64-value column chunks BN * 128 bytes apart).
__device__ __forceinline__ void start_values(float (&o)[DVP / 2], const uint32_t (&p)[BN / 16][4], uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<1>(o, p[kk], descriptor(vt + kk * (16 * 128), BN * 128, 1024), 1);
}

// The scores in s to unnormalised probabilities in place, with the chain's
// roundings: the f32 product to bf16, times the scale to bf16; then the
// causal mask where the tile crosses the diagonal (a probability of exactly
// zero), the running max and the row sums in f32. ``alpha`` gets what the
// earlier tiles' sums and products are to be scaled by.
__device__ __forceinline__ void softmax(float (&s)[BN / 2], float (&mrow)[2], float (&lrow)[2], float (&alpha)[2],
                                        float scale, bool diagonal, int n0, int row0, int lane) {
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    uint32_t u = pack(s[i], s[i + 1]);
    u = pack(lo(u) * scale, hi(u) * scale);
    s[i] = lo(u);
    s[i + 1] = hi(u);
    if (diagonal) {
      const int key = n0 + (i >> 2) * 8 + 2 * (lane & 3), row = row0 + 8 * ((i >> 1) & 1);
      if (key > row) s[i] = -INFINITY;
      if (key + 1 > row) s[i + 1] = -INFINITY;
    }
  }
  // each row's max as a tree, not a chain: the values of a row are s[i] with
  // (i / 2) % 2 its row, across the 4 threads of a quad
  float mx[2][BN / 8];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    mx[0][i] = fmaxf(s[4 * i], s[4 * i + 1]);
    mx[1][i] = fmaxf(s[4 * i + 2], s[4 * i + 3]);
  }
#pragma unroll
  for (int w = BN / 16; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) {
      mx[0][i] = fmaxf(mx[0][i], mx[0][i + w]);
      mx[1][i] = fmaxf(mx[1][i], mx[1][i + w]);
    }
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = fmaxf(mrow[r], mx[r][0]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    alpha[r] = ex2((mrow[r] - m) * LOG2E);
    mrow[r] = m;
    shift[r] = m * LOG2E;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], LOG2E, -shift[r]));
    s[i + 1] = ex2(fmaf(s[i + 1], LOG2E, -shift[r]));
    sum[r][(i >> 2) & 1] += s[i] + s[i + 1];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) lrow[r] = lrow[r] * alpha[r] + (sum[r][0] + sum[r][1]);
}

// The probabilities rounded to bf16 as wgmma's a operand: an accumulator's
// layout is the operand's, two values a register.
__device__ __forceinline__ void to_operand(const float (&s)[BN / 2], uint32_t (&p)[BN / 16][4]) {
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) p[i >> 3][(i & 7) >> 1] = pack(s[i], s[i + 1]);
}

__device__ __forceinline__ void rescale(float (&o)[DVP / 2], const float (&alpha)[2]) {
  // a row whose max held has alpha exactly 1: a warp none of whose rows'
  // max moved has nothing to scale
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

}  // namespace

struct AttentionArgs {
  CUtensorMap q, k, v;  // (d, heads, tokens, samples), boxes of 64 x 1 x rows x 1
  bf16* o;
  int S, H, G;          // tokens, query heads, query heads a kv head
  long long sob, sos;   // the output's strides, in elements
  float scale;          // dq^-1/2
};

// One block: BM query rows of one (sample, head); the grid is (query block,
// B * H), the last query block (the longest rows) first.
extern "C" __global__ void __launch_bounds__(THREADS, 1)
    causal_attention_fwd(const __grid_constant__ AttentionArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];
  const uint32_t sq = (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023u) & ~1023u;
  const uint32_t stage0 = sq + Q_BYTES;
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  // full[s]: a stage's tile has landed; empty[s]: both warpgroups are done
  // with it; the last: q's tile has landed
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (STAGES + s); };
  const uint32_t qbar = bar0 + 16 * STAGES;
  auto stage = [&](int j) { return stage0 + (j % STAGES) * STAGE_BYTES; };
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int S = a.S;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, kvh = h / a.G;
  const int nkb = (min(m0 + BM, S) + BN - 1) / BN;  // key tiles up to the diagonal

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread starts every copy
    if (tid == CONSUMERS) {
      mbar_expect(qbar, Q_BYTES);
#pragma unroll
      for (int c = 0; c < DQP / 64; ++c) tma_load(sq + c * (BM * 128), &a.q, qbar, 64 * c, h, m0, b);
      for (int j = 0; j < nkb; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty(s), (j / STAGES - 1) & 1);
        mbar_expect(full(s), STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < DQP / 64; ++c) tma_load(stage(j) + c * (BN * 128), &a.k, full(s), 64 * c, kvh, j * BN, b);
#pragma unroll
        for (int c = 0; c < DVP / 64; ++c)
          tma_load(stage(j) + K_BYTES + c * (BN * 128), &a.v, full(s), 64 * c, kvh, j * BN, b);
      }
    }
    return;
  }

  // this thread's rows of the accumulators: row0 and row0 + 8; its columns
  // 8 j + 2 (lane % 4) + {0, 1} for j = 0, 1, ...
  const int first = m0 + wg * 64;
  const int row0 = first + warp * 16 + (lane >> 2);
  float o[DVP / 2], s[BN / 2], alpha[2];
  uint32_t p[BN / 16][4];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) o[i] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  // Every warpgroup computes every tile, also one that lies wholly past its
  // rows (the last tile of the first warpgroup, where BN < BM): the mask
  // gives it no weight, and wgmma under a branch would be serialised.
  auto scores = [&](int j) {
    mbar_wait(full(j % STAGES), (j / STAGES) & 1);
    fence_operands(s);
    wgmma_fence();
    start_scores(s, sq, stage(j), wg);
    wgmma_commit();
  };
  mbar_wait(qbar, 0);
  // tile j's scores and tile j - 1's products in flight together; tile j's
  // softmax runs while the products are on the tensor cores
  scores(0);
  wgmma_wait<0>();
  fence_operands(s);
  softmax(s, mrow, lrow, alpha, a.scale, BN - 1 > first, 0, row0, lane);
  to_operand(s, p);
  for (int j = 1; j < nkb; ++j) {
    fence_operands(o);
    scores(j);
    start_values(o, p, stage(j - 1) + K_BYTES);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(s);
    softmax(s, mrow, lrow, alpha, a.scale, j * BN + BN - 1 > first, j * BN, row0, lane);
    wgmma_wait<0>();
    fence_operands(o);
    mbar_arrive(empty((j - 1) % STAGES));
    rescale(o, alpha);
    to_operand(s, p);
  }
  fence_operands(o);
  wgmma_fence();
  start_values(o, p, stage(nkb - 1) + K_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);

  // the f32 row sums, then the output divided by them and cast once
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }
  bf16* out = a.o + b * a.sob + h * DV;
#pragma unroll
  for (int i = 0; i < DVP / 2; i += 2) {
    const int r = (i >> 1) & 1, row = row0 + 8 * r, col = (i >> 2) * 8 + 2 * (lane & 3);
    if (row < S && col < DV)
      *reinterpret_cast<uint32_t*>(out + row * a.sos + col) = pack(o[i] / lrow[r], o[i + 1] / lrow[r]);
  }
}

namespace {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tensor map over (d, heads, tokens, samples) of bf16 at ``ptr`` with the
// given element strides (d's is 1), read a box of 64 x 1 x rows x 1 at a
// time into the 128-byte swizzle; what lies past an edge reads as zeros.
int tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d, int heads, int tokens, int samples,
               long long sh, long long ss, long long sb, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(tokens), static_cast<cuuint64_t>(samples)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// The shared memory a block takes, in bytes.
extern "C" int tk_attention_smem_bytes() { return SMEM_BYTES; }

// Launch on ``stream`` (a cudaStream_t) on the current device. Returns 0, a
// cudaError_t of the launch, or 1000 + a CUresult where a tensor map was
// refused. Strides are in elements: q's, k's and v's (sample, token, head),
// the output's (sample, token).
extern "C" int tk_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int G,
                                long long sqb, long long sqs, long long sqh, long long skb, long long sks,
                                long long skh, long long svb, long long svs, long long svh, long long sob,
                                long long sos, float scale, void* stream) {
  static EncodeTiled encode = nullptr;
  static bool ready[64] = {};  // the shared memory limit raised on each device
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                                             &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(causal_attention_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  AttentionArgs a;
  int r = tensor_map(encode, &a.q, q, DQ, H, S, B, sqh, sqs, sqb, BM);
  if (r == CUDA_SUCCESS) r = tensor_map(encode, &a.k, k, DQ, H / G, S, B, skh, sks, skb, BN);
  if (r == CUDA_SUCCESS) r = tensor_map(encode, &a.v, v, DV, H / G, S, B, svh, svs, svb, BN);
  if (r != CUDA_SUCCESS) return 1000 + r;
  a.o = static_cast<bf16*>(o);
  a.S = S;
  a.H = H;
  a.G = G;
  a.sob = sob;
  a.sos = sos;
  a.scale = scale;
  const dim3 grid((S + BM - 1) / BM, B * H);
  causal_attention_fwd<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
