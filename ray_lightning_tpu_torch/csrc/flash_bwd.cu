// flash_bwd: causal (or full) attention backward for Hopper, on wgmma and
// TMA, deterministic.
//
// Replaces the nine Pallas backwards of
// ray_lightning_tpu/ops/flash_attention.py (TPU kernel rows 6-12, 15, 16;
// def / pallas_call lines):
// - `_bwd_packed_kernel` :329 / :872 (row 6), packed heads, one block;
// - `_bwd_dkdv_tri_packed_kernel` :465 / :573 (row 7) and
//   `_bwd_dq_tri_packed_kernel` :511 / :610 (row 8), packed, triangular
//   grids, dk/dv then dq;
// - `_bwd_rowres_kernel` :753 / :832 (row 9), packed, k/v resident with
//   fp32 dk/dv accumulators in VMEM;
// - `_bwd_fused_kernel` :1190 / :1210 (row 10), folded, one block;
// - `_bwd_dkdv_tri_kernel` :1225 / :1315 (row 11) and `_bwd_dq_tri_kernel`
//   :1269 / :1348 (row 12), folded, triangular;
// - `_bwd_dkdv_kernel` :994 / :1414 (row 15) and `_bwd_dq_kernel` :1045 /
//   :1443 (row 16), folded, any other multi-block shape.
// They differ in layout and in what they keep in VMEM; each computes
// `_single_block_bwd_math` (:1091): delta = rowsum(dO * O) in fp32, p =
// exp(s * scale - lse) under NEG_INF masking, dv = p^T dO with p rounded to
// bf16, dp = dO v^T, ds = p (dp - delta) rounded to bf16, dk = ds^T q *
// scale, dq = ds k * scale, fp32 accumulation throughout. Rows 7, 11 and
// 15 map to this file's dk/dv pass, rows 8, 12 and 16 to its dq pass, the
// fused rows 6, 9 and 10 to all three passes of one call.
//
// What bounds it on this card: operations, from T=1024 on. At B=8,
// T=1024, H=12, D=64 the five causal [T, T] products are 32.2 GFLOP
// (0.033 ms at 989 TFLOP/s) against 0.030 ms for q, k, v, o, dO in and
// dq, dk, dv out; products grow as T^2 and bytes as T (B=8, T=2048, H=32:
// 344 GFLOP, 0.35 ms, against 0.10 ms of bytes).
//
// Why seven products and no atomics. A fused pass computes s and dp once
// (five products) but has to add each k tile's share of dq across blocks,
// with fp32 atomics in an order that changes from run to run: dq's bf16
// roundings would then differ between two calls, and the remat recompute
// is held to the same gradients bit for bit. So the backward is three
// passes of one call, each block writing its own rows once:
// - delta: rowsum(dO * O) in fp32, 16-byte loads, D / 8 lanes a row;
// - dk/dv: a block holds 128 k/v rows resident and walks the 64-row q/dO
//   tiles (32 rows at D=128) that see them; each consumer warpgroup
//   computes its 64 k rows' transposed scores S^T = K Q^T and dP^T =
//   V dO^T, so that P^T and dS^T are the register A operands of
//   dV += P^T dO and dK += dS^T Q, and issues each tile's scores behind
//   the previous tile's dV and dK products (ptxas notes that it
//   serializes some of them, C7518; the pipelined walk is still faster
//   than one tile at a time);
// - dq: a block holds 128 q/dO rows resident and walks the 128-row k/v
//   tiles (64 rows at D=128); S = Q K^T, dP = dO V^T, then dQ += dS K with
//   dS from registers.
// s and dp are computed twice: seven products where the fused TPU rows
// do five.
//
// What the design does about the operations bound (the shape of
// flash_fwd.cu): the products run on wgmma, the scores S/dP from shared
// memory, the accumulating products with P or dS as a bf16 register A
// operand and q, dO or k an MN-major B operand; a producer warp keeps TMA
// loads of the streamed tiles in flight through a ring of STAGES tiles
// with full and empty mbarriers (the dk/dv pass's producer also stages
// each tile's lse and delta beside it); setmaxnreg moves registers from
// the producer to the two consumer warpgroups; the accumulators never
// leave registers until the epilogue writes them once.
// q, k, v, o and dO are read through 4-D tensor maps over [B, T, H, D]
// with the caller's strides (the split views of the fused qkv projection,
// no copy), each tile with the swizzle of its row width (D=128 as two
// 64-column panels). Causal: tiles wholly on the masked side of the
// diagonal are neither loaded (the walk's ends) nor multiplied (the
// warpgroup skips them); only tiles that the diagonal or the ragged end
// cuts are masked. The grid is (B * H, 128-row blocks), dk/dv from block
// 0 (the longest walk) and dq from the last, heaviest first.
//
// Ragged T: TMA zero-fills rows past T, but a padded q row's lse loads as
// 0, so exp(s * scale - 0) would be 1 (or inf) there: p is set to 0 for
// every entry outside T or the causal mask, by a select, so neither it nor
// ds = p (dp - delta) carries an inf or NaN into the products (0 * inf
// would survive them).

#include <cuda.h>   // CUtensorMap and its enums; libcuda's encoder is
                    // looked up at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int R = 128;          // resident rows per block, 64 a warpgroup
constexpr int STAGES = 4;       // streamed ring depth (at most 193 KB in all)
constexpr int NTHREADS = 384;   // producer warpgroup + 2 consumers
constexpr int CONSUMERS = 256;  // arrivals that free a stage
constexpr int DELTA_THREADS = 256;

typedef __nv_bfloat16 bf16;

// Shared memory for head dim D: two resident tensors of R rows (A1, A2),
// a ring of STAGES streamed tile pairs of BS rows (B1, B2), then each
// stage's lse and delta (dk/dv pass) and the barriers. A tile is stored
// as D / PD column panels of rows x PD elements, each as TMA writes it
// with the swizzle of its ROWB-byte rows; every panel starts on a
// 1024-byte boundary (the swizzle pattern's period), so the descriptors'
// base offset is 0.
template <int D, bool DKDV>
struct Cfg {
  static constexpr int PD = D < 64 ? D : 64;
  static constexpr int NP = D / PD;
  static constexpr int ROWB = PD * 2;   // 32, 64 or 128 bytes
  // streamed rows per tile: the dq pass's scores take BS fp32 registers a
  // thread beside D / 2 of dQ, the dk/dv pass's BS beside D of dK and dV;
  // at D=128 64-row dk/dv tiles would spill
  static constexpr int BS = DKDV ? (D == 128 ? 32 : 64) : (D == 128 ? 64 : 128);
  static constexpr int RES_PANEL = R * ROWB;
  static constexpr int ST_PANEL = BS * ROWB;
  static constexpr int RES_BYTES = NP * RES_PANEL;   // one resident tensor
  static constexpr int ST_BYTES = NP * ST_PANEL;     // one streamed tile
  static constexpr int OFF_A2 = RES_BYTES;
  static constexpr int OFF_B1 = 2 * RES_BYTES;
  static constexpr int OFF_B2 = OFF_B1 + STAGES * ST_BYTES;
  static constexpr int OFF_STAT = OFF_B2 + STAGES * ST_BYTES;
  // lse * log2(e) and delta of a streamed tile (dk/dv pass)
  static constexpr int STAT_FLOATS = DKDV ? 2 * BS : 0;
  static constexpr int OFF_BAR = OFF_STAT + STAGES * STAT_FLOATS * 4;
  // res_full, full[STAGES], empty[STAGES]; 1024 bytes of slack to align
  // the dynamic base
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
  // wgmma descriptor layout type: 128-, 64- or 32-byte swizzle
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  // 8-row group stride of a panel
  static constexpr uint32_t SBO = 8 * ROWB;
  static_assert(RES_PANEL % 1024 == 0 && ST_PANEL % 1024 == 0, "alignment");
  static_assert(BS == 32 || BS == 64 || BS == 128, "streamed tile height");
  static_assert(BYTES <= 232448, "shared memory");
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

// d (64 x 32, fp32) (+)= A (64 x 16, smem desc) * B (32 x 16, smem desc),
// both K-major
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) (+)= A (64 x 16, smem desc) * B (64 x 16, smem desc),
// both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, fp32) (+)= A (64 x 16, smem desc) * B (128 x 16, smem
// desc), both K-major
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

// X = A_w B^T for one warpgroup's 64 resident rows (at sAw, panels of R
// rows) against the streamed tile at sB (panels of BS rows): D / 16 steps
// of k16, both operands K-major; issued, not waited for
template <int D, bool DKDV>
__device__ __forceinline__ void issue_scores(
    float (&x)[Cfg<D, DKDV>::BS / 2], uint32_t sAw, uint32_t sB) {
  using C = Cfg<D, DKDV>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk * 16 % C::PD) * 2;
    const uint32_t panel = kk * 16 / C::PD;
    const uint64_t da = make_desc(sAw + panel * C::RES_PANEL + col, C::SBO,
                                  C::SBO, C::LAYOUT);
    const uint64_t db = make_desc(sB + panel * C::ST_PANEL + col, C::SBO,
                                  C::SBO, C::LAYOUT);
    if constexpr (C::BS == 32) wgmma_ss_n32(x, da, db, kk > 0);
    if constexpr (C::BS == 64) wgmma_ss_n64(x, da, db, kk > 0);
    if constexpr (C::BS == 128) wgmma_ss_n128(x, da, db, kk > 0);
  }
}

// acc += F B for the streamed tile at sB: BS / 16 steps of k16, F's bf16
// A fragments from registers, B an MN-major operand (one k16 step is 16
// of its rows); issued, not waited for
template <int D, bool DKDV>
__device__ __forceinline__ void issue_acc(
    float (&acc)[Cfg<D, DKDV>::NP][Cfg<D, DKDV>::PD / 2],
    const uint32_t (&f)[Cfg<D, DKDV>::BS / 16][4], uint32_t sB) {
  using C = Cfg<D, DKDV>;
#pragma unroll
  for (int kk = 0; kk < C::BS / 16; ++kk) {
#pragma unroll
    for (int p = 0; p < C::NP; ++p) {
      const uint64_t db = make_desc(sB + p * C::ST_PANEL + kk * 16 * C::ROWB,
                                    C::SBO, C::SBO, C::LAYOUT);
      if constexpr (C::PD == 16) wgmma_rs_n16(acc[p], f[kk], db);
      if constexpr (C::PD == 32) wgmma_rs_n32(acc[p], f[kk], db);
      if constexpr (C::PD == 64) wgmma_rs_n64(acc[p], f[kk], db);
    }
  }
}

// x rounded to bf16 as A fragments: the accumulator fragments of a
// 16-column slab are an A fragment as they stand
template <int BS>
__device__ __forceinline__ void pack_frags(const float (&x)[BS / 2],
                                           uint32_t (&f)[BS / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BS / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// p = exp(x * scale - lse) in place, 0 outside T and the causal mask
// (where `edge`). A thread holds entries (row_a + 8 * (e >> 1), s0 + 8 g
// + 2 t4 + (e & 1)) of the 64 x BS fragment, i = 4 g + e: resident rows by
// row, streamed rows by column. The dk/dv pass's lse (times log2 e)
// indexes the columns, from the tile's stats `st`; the dq pass's its own
// two rows, `lse_r`.
template <int BS, bool DKDV>
__device__ __forceinline__ void tile_p(float (&x)[BS / 2], const float* st,
                                       const float (&lse_r)[2], bool edge,
                                       int row_a, int s0, int t4, int T,
                                       int causal, float scale_log2) {
#pragma unroll
  for (int g = 0; g < BS / 8; ++g) {
    float2 l2 = make_float2(lse_r[0], lse_r[1]);
    if constexpr (DKDV)
      l2 = *reinterpret_cast<const float2*>(st + 8 * g + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * g + e;
      const float l = (DKDV ? (e & 1) : (e >> 1)) ? l2.y : l2.x;
      float p = exp2f(fmaf(x[i], scale_log2, -l));
      if (edge) {
        const int row = row_a + 8 * (e >> 1);
        const int col = s0 + 8 * g + 2 * t4 + (e & 1);
        const int key = DKDV ? row : col;
        const int query = DKDV ? col : row;
        if (row >= T || col >= T || (causal && key > query)) p = 0.f;
      }
      x[i] = p;
    }
  }
}

// ds = p (dp - delta) into x (dp in), delta indexed as lse in tile_p
template <int BS, bool DKDV>
__device__ __forceinline__ void tile_ds(const float (&p)[BS / 2],
                                        float (&x)[BS / 2], const float* st,
                                        const float (&dlt_r)[2], int t4) {
#pragma unroll
  for (int g = 0; g < BS / 8; ++g) {
    float2 d2 = make_float2(dlt_r[0], dlt_r[1]);
    if constexpr (DKDV)
      d2 = *reinterpret_cast<const float2*>(st + BS + 8 * g + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * g + e;
      x[i] = p[i] * (x[i] - ((DKDV ? (e & 1) : (e >> 1)) ? d2.y : d2.x));
    }
  }
}

// The dk/dv pass (DKDV) or the dq pass. Resident A1, A2 and streamed B1,
// B2 are (K, V; Q, dO) in the dk/dv pass and (Q, dO; K, V) in the dq
// pass, so X1 = A1 B1^T and X2 = A2 B2^T are S^T and dP^T or S and dP.
// out_ds gets dS B1 * scale (dK or dQ), out_p gets P B2 (dV, dk/dv pass
// only); both [B, T, H, D] contiguous.
template <int D, bool DKDV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap ta1,
                 const __grid_constant__ CUtensorMap ta2,
                 const __grid_constant__ CUtensorMap tb1,
                 const __grid_constant__ CUtensorMap tb2,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ out_ds,
                 bf16* __restrict__ out_p, int T, int H, int causal,
                 float sm_scale) {
  using C = Cfg<D, DKDV>;
  constexpr int PD = C::PD;
  constexpr int NP = C::NP;
  constexpr int BS = C::BS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sA1 = base;
  const uint32_t sA2 = base + C::OFF_A2;
  const uint32_t sB1 = base + C::OFF_B1;
  const uint32_t sB2 = base + C::OFF_B2;
  float* const stat =
      reinterpret_cast<float*>(smem_raw + (base - raw) + C::OFF_STAT);
  const uint32_t res_full = base + C::OFF_BAR;
  const uint32_t full = res_full + 8;               // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;         // + 8 * stage

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  // heaviest first: under the causal mask dk/dv block 0 and the last dq
  // block walk the most tiles
  const int rb = (!DKDV && causal) ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = rb * R;
  const int n_s = (T + BS - 1) / BS;
  // the streamed tiles that see this block's rows
  const int j0 = (DKDV && causal) ? r0 / BS : 0;
  const int j1 = (!DKDV && causal) ? (min(r0 + R, T) - 1) / BS + 1 : n_s;
  const int64_t stat_row = static_cast<int64_t>(bh) * T;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      // the dk/dv pass's producer warp arrives once more, with the stats
      mbar_init(full + 8 * s, DKDV ? 2 : 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: its first warp issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(res_full, 2 * C::RES_BYTES);
        for (int p = 0; p < NP; ++p) {
          tma_load(sA1 + p * C::RES_PANEL, &ta1, res_full, p * PD, h, r0, b);
          tma_load(sA2 + p * C::RES_PANEL, &ta2, res_full, p * PD, h, r0, b);
        }
      }
      for (int j = j0; j < j1; ++j) {
        const int s = (j - j0) % STAGES;
        mbar_wait(empty + 8 * s, (((j - j0) / STAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, 2 * C::ST_BYTES);
          for (int p = 0; p < NP; ++p) {
            const uint32_t off = s * C::ST_BYTES + p * C::ST_PANEL;
            tma_load(sB1 + off, &tb1, full + 8 * s, p * PD, h, j * BS, b);
            tma_load(sB2 + off, &tb2, full + 8 * s, p * PD, h, j * BS, b);
          }
        }
        if constexpr (DKDV) {
          // the tile's lse (times log2 e) and delta; 0 past T, where p is
          // masked to 0
          float* st = stat + s * C::STAT_FLOATS;
          for (int i = lane; i < BS; i += 32) {
            const int t = j * BS + i;
            const bool in = t < T;
            st[i] = in ? lse[stat_row + t] * LOG2E : 0.f;
            st[BS + i] = in ? delta[stat_row + t] : 0.f;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {
    // consumer warpgroups: 64 resident rows each; a thread holds rows
    // row_a and row_a + 8 of every fragment
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32;
    const int t4 = lane & 3;
    const int rw0 = r0 + 64 * wg;
    const int row_a = rw0 + 16 * ((threadIdx.x / 32) % 4) + (lane >> 2);
    const uint32_t sA1w = sA1 + 64 * wg * C::ROWB;
    const uint32_t sA2w = sA2 + 64 * wg * C::ROWB;
    const float scale_log2 = sm_scale * LOG2E;
    const bool live = rw0 < T;   // a warpgroup wholly past T computes nothing

    float acc_ds[NP][PD / 2];   // dK (dk/dv pass) or dQ
    float acc_p[NP][PD / 2];    // dV (dk/dv pass)
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < PD / 2; ++i) acc_ds[p][i] = acc_p[p][i] = 0.f;
    float x1[BS / 2], x2[BS / 2];
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) x1[i] = x2[i] = 0.f;
    uint32_t pf[BS / 16][4], dsf[BS / 16][4];
    // the dq pass's own rows' lse (times log2 e) and delta
    float lse_r[2] = {0.f, 0.f}, dlt_r[2] = {0.f, 0.f};
    if constexpr (!DKDV) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        if (row < T) {
          lse_r[r] = lse[stat_row + row] * LOG2E;
          dlt_r[r] = delta[stat_row + row];
        }
      }
    }

    // tile j's ring stage: waiting for its load, freeing it, issuing its
    // two score products
    auto stage = [&](int j) { return (j - j0) % STAGES; };
    auto wait_full = [&](int j) {
      mbar_wait(full + 8 * stage(j), ((j - j0) / STAGES) & 1);
    };
    // every consumer thread arrives (no branch on the lane while a
    // product may be in flight)
    auto free_stage = [&](int j) { mbar_arrive(empty + 8 * stage(j)); };
    auto issue_tile_scores = [&](int j) {
      wgmma_fence();
      issue_scores<D, DKDV>(x1, sA1w, sB1 + stage(j) * C::ST_BYTES);
      wgmma_commit();
      issue_scores<D, DKDV>(x2, sA2w, sB2 + stage(j) * C::ST_BYTES);
      wgmma_commit();
    };
    // the diagonal or the ragged end cuts tile j
    auto edge = [&](int j) {
      const int s0 = j * BS;
      return s0 + BS > T || rw0 + 64 > T ||
             (causal && (DKDV ? rw0 + 63 > s0 : s0 + BS - 1 > rw0));
    };
    // this warpgroup's tiles [c0, c1); the rest of [j0, j1) lie wholly on
    // the masked side of the diagonal (or the warpgroup wholly past T),
    // and are only waited for and freed
    int c0 = j0, c1 = j1;
    if (!live) c1 = c0;
    else if (causal && DKDV) c0 = max(j0, rw0 / BS);
    else if (causal) c1 = min(j1, (rw0 + 63) / BS + 1);

    mbar_wait(res_full, 0);
    if constexpr (DKDV) {
      for (int j = j0; j < c0; ++j) {
        wait_full(j);
        free_stage(j);
      }
      if (c0 < c1) {
        wait_full(c0);
        issue_tile_scores(c0);
      }
      // Each tile's score products are issued behind the previous tile's
      // dV and dK products, so the tensor cores run them back to back
      // while this warpgroup waits: its S and dP registers are free once
      // P and dS are packed. A tile's stage is freed at the next tile.
      for (int j = c0; j < c1; ++j) {
        const int s = stage(j);
        const float* st = stat + s * C::STAT_FLOATS;
        wgmma_wait<1>();   // S^T is in, and tile j - 1's products
        fence_regs(x1);
        tile_p<BS, DKDV>(x1, st, lse_r, edge(j), row_a, j * BS, t4, T,
                         causal, scale_log2);
        wgmma_wait<0>();
        fence_regs(x2);
        // nothing in flight: free tile j - 1's stage, wait for tile j + 1
        if (j > c0) free_stage(j - 1);
        if (j + 1 < c1) wait_full(j + 1);
        // dV += P^T dO, running while dS is computed
        pack_frags<BS>(x1, pf);
        wgmma_fence();
        issue_acc<D, DKDV>(acc_p, pf, sB2 + s * C::ST_BYTES);
        wgmma_commit();
        tile_ds<BS, DKDV>(x1, x2, st, dlt_r, t4);
        pack_frags<BS>(x2, dsf);
        wgmma_fence();
        issue_acc<D, DKDV>(acc_ds, dsf, sB1 + s * C::ST_BYTES);   // dK
        wgmma_commit();
        if (j + 1 < c1) issue_tile_scores(j + 1);
      }
      if (c0 < c1) {
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          fence_regs(acc_ds[p]);
          fence_regs(acc_p[p]);
        }
        free_stage(c1 - 1);
      }
      for (int j = c1; j < j1; ++j) {
        wait_full(j);
        free_stage(j);
      }
    } else {
      // the dq pass, a tile at a time (issuing the next tile's scores
      // behind dQ += dS K was slower here)
      for (int j = j0; j < j1; ++j) {
        const int s = stage(j);
        wait_full(j);
        if (j >= c0 && j < c1) {
          issue_tile_scores(j);
          wgmma_wait<1>();   // S is in; dP may still run
          fence_regs(x1);
          tile_p<BS, DKDV>(x1, nullptr, lse_r, edge(j), row_a, j * BS, t4,
                           T, causal, scale_log2);
          wgmma_wait<0>();
          fence_regs(x2);
          tile_ds<BS, DKDV>(x1, x2, nullptr, dlt_r, t4);
          pack_frags<BS>(x2, dsf);
          wgmma_fence();
          issue_acc<D, DKDV>(acc_ds, dsf, sB1 + s * C::ST_BYTES);   // dQ
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int p = 0; p < NP; ++p) fence_regs(acc_ds[p]);
        }
        free_stage(j);
      }
    }

    // epilogue: each resident row < T written once, bf16
    if (live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        if (row >= T) continue;
        const int64_t off = ((static_cast<int64_t>(b) * T + row) * H + h) * D;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int i = 0; i < PD / 8; ++i) {
            const int col = p * PD + 8 * i + 2 * t4;
            *reinterpret_cast<__nv_bfloat162*>(out_ds + off + col) =
                __floats2bfloat162_rn(acc_ds[p][4 * i + 2 * r] * sm_scale,
                                      acc_ds[p][4 * i + 2 * r + 1] * sm_scale);
            if constexpr (DKDV)
              *reinterpret_cast<__nv_bfloat162*>(out_p + off + col) =
                  __floats2bfloat162_rn(acc_p[p][4 * i + 2 * r],
                                        acc_p[p][4 * i + 2 * r + 1]);
          }
      }
    }
  }
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d] in fp32: D / 8
// lanes a row, 16 bytes each, rows in (b, h, t) order so the writes are
// contiguous; a grid-stride loop over blocks of rows
template <int D>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta_kernel(const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       float* __restrict__ delta, int T, int H, int64_t rows,
                       int64_t o_sb, int64_t o_st, int64_t o_sh,
                       int64_t d_sb, int64_t d_st, int64_t d_sh) {
  constexpr int LPR = D / 8;
  constexpr int RPB = DELTA_THREADS / LPR;
  const int c = (threadIdx.x % LPR) * 8;
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * RPB; first < rows;
       first += static_cast<int64_t>(gridDim.x) * RPB) {
    const int64_t n = first + threadIdx.x / LPR;
    float sum = 0.f;
    if (n < rows) {
      const int t = static_cast<int>(n % T);
      const int64_t bh = n / T;
      const int64_t b = bh / H;
      const int h = static_cast<int>(bh % H);
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(
          o + b * o_sb + t * o_st + h * o_sh + c));
      const uint4 g = __ldg(reinterpret_cast<const uint4*>(
          dout + b * d_sb + t * d_st + h * d_sh + c));
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 af = __bfloat1622float2(a2[i]);
        const float2 gf = __bfloat1622float2(g2[i]);
        sum = fmaf(af.x, gf.x, sum);
        sum = fmaf(af.y, gf.y, sum);
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (n < rows && threadIdx.x % LPR == 0) delta[n] = sum;
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
  using C = Cfg<D, true>;   // the panels are the same in both passes
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

// one call's operands: q, k, v, o, dO in, lse in, delta scratch, dq, dk,
// dv out; st: strides (batch, row, head) of q, k, v, o, dO, in that order
struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  int B, T, H;
  int64_t st[15];
  int causal;
  float sm_scale;
  int device;
  cudaStream_t stream;
};

// cudaFuncSetAttribute once per instantiation and device
template <int D, bool DKDV>
cudaError_t allow_smem(int device) {
  static std::atomic<uint64_t> done{0};
  const uint64_t bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<D, DKDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<D, DKDV>::BYTES);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int D>
cudaError_t launch_delta(const Args& a) {
  constexpr int RPB = DELTA_THREADS / (D / 8);
  const int64_t rows = static_cast<int64_t>(a.B) * a.T * a.H;
  const int64_t blocks = (rows + RPB - 1) / RPB;
  // enough blocks to fill the card many times; the rest loop
  const unsigned grid = static_cast<unsigned>(blocks < 65536 ? blocks : 65536);
  flash_bwd_delta_kernel<D><<<grid, DELTA_THREADS, 0, a.stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      static_cast<float*>(a.delta), a.T, a.H, rows, a.st[9], a.st[10],
      a.st[11], a.st[12], a.st[13], a.st[14]);
  return cudaGetLastError();
}

template <int D, bool DKDV>
cudaError_t launch_pass(const Args& a) {
  cudaError_t err = allow_smem<D, DKDV>(a.device);
  if (err != cudaSuccess) return err;
  // resident and streamed tensors, by their index in st / 3: q 0, k 1,
  // v 2, dO 4
  const void* ptr[5] = {a.q, a.k, a.v, a.o, a.dout};
  const int res[2] = {DKDV ? 1 : 0, DKDV ? 2 : 4};
  const int str[2] = {DKDV ? 0 : 1, DKDV ? 4 : 2};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const int x = i < 2 ? res[i] : str[i - 2];
    if (!encode_map<D>(&maps[i], ptr[x], a.B, a.T, a.H, a.st[3 * x],
                       a.st[3 * x + 1], a.st[3 * x + 2],
                       i < 2 ? R : Cfg<D, DKDV>::BS))
      return cudaErrorInvalidValue;
  }
  dim3 grid(a.B * a.H, (a.T + R - 1) / R);
  flash_bwd_kernel<D, DKDV><<<grid, NTHREADS, Cfg<D, DKDV>::BYTES,
                              a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta),
      static_cast<bf16*>(DKDV ? a.dk : a.dq),
      static_cast<bf16*>(DKDV ? a.dv : nullptr), a.T, a.H, a.causal,
      a.sm_scale);
  return cudaGetLastError();
}

enum Pass { DELTA = 1, DKDV = 2, DQ = 4, ALL = 7 };

template <int D>
cudaError_t run(int passes, const Args& a) {
  cudaError_t err = cudaSuccess;
  if (passes & DELTA) err = launch_delta<D>(a);
  if (err == cudaSuccess && (passes & DKDV)) err = launch_pass<D, true>(a);
  if (err == cudaSuccess && (passes & DQ)) err = launch_pass<D, false>(a);
  return err;
}

#define RLT_BWD_PARAMS                                                      \
  const void *q, const void *k, const void *v, const void *o,              \
      const void *dout, const void *lse, void *delta, void *dq, void *dk,  \
      void *dv, int B, int T, int H, int D, int q_sb, int q_st, int q_sh,  \
      int k_sb, int k_st, int k_sh, int v_sb, int v_st, int v_sh,          \
      int o_sb, int o_st, int o_sh, int d_sb, int d_st, int d_sh,          \
      int causal, float sm_scale, int device, void *stream
#define RLT_BWD_ARGS                                                        \
  q, k, v, o, dout, lse, delta, dq, dk, dv, B, T, H, D, q_sb, q_st, q_sh,  \
      k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, d_sb, d_st,    \
      d_sh, causal, sm_scale, device, stream

int run_passes(int passes, RLT_BWD_PARAMS) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, T, H,
               {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb,
                o_st, o_sh, d_sb, d_st, d_sh},
               causal, sm_scale, device, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return static_cast<int>(run<16>(passes, a));
    case 32: return static_cast<int>(run<32>(passes, a));
    case 64: return static_cast<int>(run<64>(passes, a));
    case 128: return static_cast<int>(run<128>(passes, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, o, dO: bf16 [B, T, H, D] with unit stride over D and strides
// (in elements, multiples of 8) *_sb over batch, *_st over rows, *_sh over
// heads; lse: fp32 [B, H, T] contiguous (the forward's); delta: fp32
// [B, H, T] scratch; dq, dk, dv: bf16 [B, T, H, D] contiguous. The dk/dv
// and dq grids are (B * H, ceil(T / 128)). Each entry returns
// cudaGetLastError() after its launches (cudaErrorInvalidValue for an
// unsupported head_dim or operands no tensor map can describe).
//
// The whole backward: delta, dk/dv and dq on the stream, in that order.
extern "C" int rlt_flash_bwd(RLT_BWD_PARAMS) {
  return run_passes(ALL, RLT_BWD_ARGS);
}

// Each pass alone, same arguments (to time one pass): delta writes delta;
// dk/dv and dq read it.
extern "C" int rlt_flash_bwd_delta(RLT_BWD_PARAMS) {
  return run_passes(DELTA, RLT_BWD_ARGS);
}

extern "C" int rlt_flash_bwd_dkdv(RLT_BWD_PARAMS) {
  return run_passes(DKDV, RLT_BWD_ARGS);
}

extern "C" int rlt_flash_bwd_dq(RLT_BWD_PARAMS) {
  return run_passes(DQ, RLT_BWD_ARGS);
}
