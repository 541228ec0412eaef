// flash_fwd: causal (or full) attention forward for Hopper, FA3-style.
//
// Replaces the five Pallas forwards of ray_lightning_tpu/ops/flash_attention.py
// (TPU kernel rows 1-5: `_fwd_packed_kernel` :298, `_fwd_tri_packed_kernel`
// :349, `_fwd_rowres_kernel` :673, `_fwd_tri_kernel` :149, `_fwd_kernel`
// :98). They differ only in layout and in what they keep in VMEM; the
// function is one, and this kernel computes it for any T and head count.
//
// What bounds it on this card. At the long-context shapes the causal
// products dominate (B=8, T=2048, H=32: 137 GFLOP, 0.139 ms at 989
// TFLOP/s against 0.04 ms for the bytes): operations. At the serve
// path's shapes (B=1, H=12, T <= 1024) the work is a few us of either
// bytes or operations, so a launch is bound by its latency: one wave of
// at most 96 blocks, each walking its k/v tiles in turn. Inside this
// design the softmax holds it back at D=64: a 128 x 128 tile's
// exponentials take the SM's 16 ex2 a clock about as long as the tile's
// two products take the tensor cores, and the scaling, max, sum and
// bf16 rounding add as much again on the FP32 pipes.
//
// What the design does about it:
// - the products run on wgmma, the only path to the tensor cores'
//   Hopper rate: S = Q K^T with both operands in shared memory, the
//   result in registers; O += P V with P as a register A operand and V
//   an MN-major B operand (bf16 allows the transpose);
// - a block takes 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows each and a producer warp that keeps TMA loads
//   of K/V in flight through a ring of STAGES tiles with full and empty
//   mbarriers, so tile j + 1 loads while tile j computes; Q is loaded
//   once by TMA; setmaxnreg moves registers from the producer to the
//   consumers;
// - S, P and O never leave registers: the online softmax takes a row's
//   max and sum from shuffles across the 4 threads that hold it, the
//   bf16 P fragment is reused as the A operand as it stands, and O is
//   rescaled in place;
// - the softmax runs beside the products: a warpgroup issues tile j's
//   Q K^T together with tile j - 1's P V and computes tile j's softmax
//   while P V runs, and the two warpgroups take turns at issuing (named
//   barriers), so one's softmax runs while the other's products do;
// - q, k, v are read through 4-D tensor maps over [B, T, H, D] with the
//   caller's strides (the split views of the fused qkv projection, no
//   copy); TMA zero-fills rows past T (a NaN there would survive
//   0 * NaN in P V) and writes each tile with the swizzle of its row
//   width (32, 64 or 128 bytes; D=128 as two 64-column panels), which
//   the wgmma descriptors name;
// - causal: BM == BN, so a q tile's last k tile is the diagonal, the
//   only one masked (with the ragged end); tiles past it are never
//   loaded; q tiles run heaviest first.
// Rounding points as `_fwd_packed_kernel`: fp32 scores scaled by
// sm_scale, NEG_INF = -1e30 masking, p rounded to bf16 before P V with
// fp32 accumulation, o = acc / l, lse = m + log(l). No atomics: the
// output is the same from run to run.

#include <cuda.h>   // CUtensorMap and its enums; libcuda's encoder is
                    // looked up at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 128;     // query rows per block, 64 per consumer warpgroup
constexpr int BN = 128;     // key rows per tile; BM == BN (see above)
constexpr int STAGES = 3;   // K/V ring depth (D=128: 225 KB in all)
constexpr int NTHREADS = 384;        // producer warpgroup + 2 consumers
constexpr int CONSUMER_WARPS = 8;    // arrivals that free a stage

typedef __nv_bfloat16 bf16;

// Shared memory for head dim D. A tile of R rows is stored as D / PD
// column panels of R rows x PD elements, each as TMA writes it with the
// swizzle of its ROWB-byte rows; every panel starts on a 1024-byte
// boundary (the swizzle pattern's period), so the descriptors' base
// offset is 0.
template <int D>
struct Cfg {
  static constexpr int PD = D < 64 ? D : 64;
  static constexpr int NP = D / PD;
  static constexpr int ROWB = PD * 2;   // 32, 64 or 128 bytes
  static constexpr int Q_PANEL = BM * ROWB;
  static constexpr int KV_PANEL = BN * ROWB;
  static constexpr int Q_BYTES = NP * Q_PANEL;
  static constexpr int KV_BYTES = NP * KV_PANEL;   // one K or V tile
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // q_full, full[STAGES], empty[STAGES]; 1024 bytes of slack to align
  // the dynamic base
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
  // wgmma descriptor layout type: 128-, 64- or 32-byte swizzle
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  // 8-row group stride of a panel
  static constexpr uint32_t SBO = 8 * ROWB;
  static_assert(Q_PANEL % 1024 == 0 && KV_PANEL % 1024 == 0, "alignment");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map at coordinates (d, h, t, b) into shared
// memory; completion counts its bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h),
      "r"(t), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The two consumer warpgroups take turns at issuing products (named
// barriers 1 and 2, 256 threads), so one's softmax runs while the
// other's products do: wait for this warpgroup's turn, pass the turn on
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// keeps the compiler from touching accumulator registers across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, fp32) (+)= A (64 x 16, smem desc) * B (128 x 16,
// smem desc), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 16, fp32) += A (64 x 16, bf16 registers) * B (16 x 16, smem
// desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16, bf16 registers) * B (16 x 32, smem
// desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, smem
// desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// S = Q K^T for one warpgroup's 64 rows of Q (at sQw) against the K tile
// at sK: D / 16 steps of k16, both operands K-major; issued, not waited
// for
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t sQw,
                                         uint32_t sK) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk * 16 % C::PD) * 2;
    const uint32_t panel = kk * 16 / C::PD;
    wgmma_ss_n128(
        sc, make_desc(sQw + panel * C::Q_PANEL + col, C::SBO, C::SBO,
                      C::LAYOUT),
        make_desc(sK + panel * C::KV_PANEL + col, C::SBO, C::SBO, C::LAYOUT),
        kk > 0);
  }
}

// O += P V against the V tile at sV: BN / 16 steps of k16, P's bf16 A
// fragments from registers, V an MN-major operand (one k16 step is 16 of
// its rows); issued, not waited for
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&acc)[Cfg<D>::NP][Cfg<D>::PD / 2], const uint32_t (&pf)[BN / 16][4],
    uint32_t sV) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int p = 0; p < C::NP; ++p) {
      const uint64_t dv = make_desc(sV + p * C::KV_PANEL + kk * 16 * C::ROWB,
                                    C::SBO, C::SBO, C::LAYOUT);
      if constexpr (C::PD == 16) wgmma_rs_n16(acc[p], pf[kk], dv);
      if constexpr (C::PD == 32) wgmma_rs_n32(acc[p], pf[kk], dv);
      if constexpr (C::PD == 64) wgmma_rs_n64(acc[p], pf[kk], dv);
    }
  }
}

// the online softmax of one tile of scores whose first column is k0:
// fp32 scores scaled by sm_scale, NEG_INF where the diagonal or the
// ragged end cuts the tile; updates each row's max m and sum l, leaves
// p = exp(s - m) in sc and the factor that rescales the accumulator in
// alpha. A row's max comes from the 4 threads that hold it.
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             int row_a, int wg_row, int T,
                                             int causal, float sm_scale,
                                             int t4) {
  const bool edge = k0 + BN > T || (causal && k0 + BN - 1 > wg_row);
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    float x = sc[i] * sm_scale;
    if (edge) {
      const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
      const int row = row_a + 8 * ((i >> 1) & 1);
      if (col >= T || (causal && col > row)) x = NEG_INF;
    }
    sc[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f((m[r] - m_new) * LOG2E);
    m[r] = m_new;
    ml[r] = m_new * LOG2E;
    l[r] *= alpha[r];
  }
  // p in fp32 for the sum; rounded to bf16 only for P V (pack_p)
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const float p = exp2f(fmaf(sc[i], LOG2E, -ml[(i >> 1) & 1]));
    sc[i] = p;
    l[(i >> 1) & 1] += p;
  }
}

// the accumulator fragments' rows times their alpha
template <int D>
__device__ __forceinline__ void rescale(
    float (&acc)[Cfg<D>::NP][Cfg<D>::PD / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int p = 0; p < Cfg<D>::NP; ++p)
#pragma unroll
    for (int i = 0; i < Cfg<D>::PD / 2; ++i) acc[p][i] *= alpha[(i >> 1) & 1];
}

// p rounded to bf16 as the A fragments of P V: the accumulator fragments
// of a 16-column slab are an A fragment as they stand
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2],
                                       uint32_t (&pf)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pf[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ o, float* __restrict__ lse, int T, int H,
                 int causal, float sm_scale) {
  using C = Cfg<D>;
  constexpr int PD = C::PD;
  constexpr int NP = C::NP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + C::OFF_K;
  const uint32_t sV = base + C::OFF_V;
  const uint32_t q_full = base + C::OFF_BAR;
  const uint32_t full = q_full + 8;                 // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;         // + 8 * stage

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  // causal q tiles heaviest first: the last ones hold the most k tiles
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BM;
  const int last_row = min(q0 + BM, T) - 1;
  const int n_tiles = causal ? last_row / BN + 1 : (T + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int p = 0; p < NP; ++p)
        tma_load(sQ + p * C::Q_PANEL, &tq, q_full, p * PD, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * C::KV_BYTES);
        for (int p = 0; p < NP; ++p) {
          const uint32_t off = s * C::KV_BYTES + p * C::KV_PANEL;
          tma_load(sK + off, &tk, full + 8 * s, p * PD, h, j * BN, b);
          tma_load(sV + off, &tv, full + 8 * s, p * PD, h, j * BN, b);
        }
      }
    }
  } else {
    // consumer warpgroups: 64 query rows each; a thread holds rows
    // row_a and row_a + 8 of the accumulator fragments. Tile j's
    // S = Q K^T is issued before tile j - 1's O += P V, so the softmax
    // of tile j runs while the tensor cores finish P V.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32;
    const int t4 = lane & 3;
    const int wg_row = q0 + 64 * wg;
    const int row_a = wg_row + 16 * ((threadIdx.x / 32) % 4) + (lane >> 2);
    const uint32_t sQw = sQ + 64 * wg * C::ROWB;

    float acc[NP][PD / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < PD / 2; ++i) acc[p][i] = 0.f;
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    uint32_t pf[BN / 16][4];   // P of the previous tile, bf16 A fragments
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};   // this thread's share of each row's sum
    float alpha[2];

    if (wg == 1) turn_pass(wg);   // warpgroup 0 takes the first turn
    mbar_wait(q_full, 0);
    mbar_wait(full, 0);
    turn_wait(wg);
    wgmma_fence();
    issue_qk<D>(sc, sQw, sK);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, m, l, alpha, 0, row_a, wg_row, T, causal, sm_scale, t4);
    pack_p(sc, pf);
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int sp = (j - 1) % STAGES;
      mbar_wait(full + 8 * s, (j / STAGES) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_qk<D>(sc, sQw, sK + s * C::KV_BYTES);
      wgmma_commit();
      issue_pv<D>(acc, pf, sV + sp * C::KV_BYTES);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();   // S of tile j is in; P V of tile j - 1 may run on
      fence_regs(sc);
      softmax_tile(sc, m, l, alpha, j * BN, row_a, wg_row, T, causal,
                   sm_scale, t4);
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      if (lane == 0) mbar_arrive(empty + 8 * sp);   // stage sp is free
      rescale<D>(acc, alpha);
      pack_p(sc, pf);
    }
    const int sl = (n_tiles - 1) % STAGES;
    turn_wait(wg);
    wgmma_fence();
    issue_pv<D>(acc, pf, sV + sl * C::KV_BYTES);
    wgmma_commit();
    if (wg == 0) turn_pass(wg);   // warpgroup 1 has one turn left
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    if (lane == 0) mbar_arrive(empty + 8 * sl);

    // epilogue: o = acc / l in bf16, lse = m + log(l); rows past T are
    // not written
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row_a + 8 * r;
      if (row >= T) continue;
      const float inv = 1.f / l[r];
      bf16* orow = o + ((static_cast<int64_t>(b) * T + row) * H + h) * D;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < PD / 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(orow + p * PD + 8 * i +
                                             2 * t4) =
              __floats2bfloat162_rn(acc[p][4 * i + 2 * r] * inv,
                                    acc[p][4 * i + 2 * r + 1] * inv);
      if (t4 == 0)
        lse[(static_cast<int64_t>(b) * H + h) * T + row] = m[r] + logf(l[r]);
    }
  }
}

// libcuda's tensor-map encoder, looked up once through the runtime
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// a 4-D map over [B, T, H, D] (innermost first: D, H, T, B) with the
// caller's strides in elements; boxes of `rows` rows x one panel of one
// head, swizzled by the panel's row width; rows past T read as zeros
template <int D>
bool encode_map(CUtensorMap* map, const void* ptr, int B, int T, int H,
                int64_t sb, int64_t st, int64_t sh, int rows) {
  using C = Cfg<D>;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(C::PD), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      C::ROWB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : C::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// cudaFuncSetAttribute once per instantiation and device
template <int D>
cudaError_t allow_smem(int device) {
  static std::atomic<uint64_t> done{0};
  const uint64_t bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<D>::BYTES);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int T, int H, int64_t q_sb,
                   int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
                   int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
                   int causal, float sm_scale, int device,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem<D>(device);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!encode_map<D>(&tq, q, B, T, H, q_sb, q_st, q_sh, BM) ||
      !encode_map<D>(&tk, k, B, T, H, k_sb, k_st, k_sh, BN) ||
      !encode_map<D>(&tv, v, B, T, H, v_sb, v_st, v_sh, BN))
    return cudaErrorInvalidValue;
  dim3 grid(B * H, (T + BM - 1) / BM);
  flash_fwd_kernel<D><<<grid, NTHREADS, Cfg<D>::BYTES, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), T, H,
      causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 [B, T, H, D] with unit stride over D and strides (in
// elements, multiples of 8) *_sb over batch, *_st over rows, *_sh over
// heads; o: bf16 [B, T, H, D] contiguous; lse: fp32 [B, H, T]
// contiguous. The grid is (B * H, ceil(T / 128)). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported head_dim or operands no tensor map can describe).
extern "C" int rlt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int T, int H, int D,
                             int q_sb, int q_st, int q_sh, int k_sb,
                             int k_st, int k_sh, int v_sb, int v_st,
                             int v_sh, int causal, float sm_scale,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, lse, B, T, H, q_sb, q_st, q_sh, k_sb,
                        k_st, k_sh, v_sb, v_st, v_sh, causal, sm_scale,
                        device, s);
    case 32:
      return launch<32>(q, k, v, o, lse, B, T, H, q_sb, q_st, q_sh, k_sb,
                        k_st, k_sh, v_sb, v_st, v_sh, causal, sm_scale,
                        device, s);
    case 64:
      return launch<64>(q, k, v, o, lse, B, T, H, q_sb, q_st, q_sh, k_sb,
                        k_st, k_sh, v_sb, v_st, v_sh, causal, sm_scale,
                        device, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, T, H, q_sb, q_st, q_sh, k_sb,
                         k_st, k_sh, v_sb, v_st, v_sh, causal, sm_scale,
                         device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
