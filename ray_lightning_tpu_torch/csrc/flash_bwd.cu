// flash_bwd: causal (or full) attention backward for Hopper, FA2-style.
//
// Replaces: ray_lightning_tpu/ops/flash_attention.py `_bwd_packed_kernel`
// (launched by `_bwd_packed`, reached from the `_flash` custom VJP ->
// `_flash_bwd` -> `_bwd`), the single-block head-packed Pallas backward
// that every training step at T <= 1024 takes (gpt2-small, B=8, T=1024).
// Its math is `_single_block_bwd_math`: delta = rowsum(dO * O), p =
// exp(s - lse), dv = p^T dO with p rounded to bf16, dp = dO v^T, ds =
// p * (dp - delta) rounded to bf16, dk = ds^T q * scale, dq = ds k * scale,
// fp32 accumulation throughout.
//
// What bounds it on this card: at B=8, T=1024, H=12, D=64 the five causal
// products are 5 * T^2 * D flops a head (32.2 GFLOP, 0.033 ms at 989
// TFLOP/s); q, k, v, o, dO in and dq, dk, dv out are 8 * 12.6 MB (0.030 ms
// at 3.35 TB/s). So the work sits at the ridge, operations by a little.
// A simple kernel is bound by neither: it is bound by the mma.sync rate
// that wmma reaches without wgmma, shared-memory traffic and latency.
//
// What the design does about that, simply and correctly first. The TPU
// kernel keeps a whole T <= 1024 row of q/k/v/dO of a two-head pack in
// VMEM and walks a 256-row staircase; at T=1024 that is >= 512 KB a head,
// which does not fit 227 KB of shared memory, and blocks here run in
// parallel in no order. So the port is the FA2 backward in three passes of
// one call:
// - delta: one warp per (b, t, h) row, rowsum(dO * O) in fp32;
// - dk/dv: a block per (64-row k/v tile, b * h) holds its k/v tile in
//   shared memory and walks the q tiles at or below it (causal tile
//   skipping), recomputing s and p from the forward's lse, with dk and dv
//   accumulated in wmma fragments (registers) across the walk;
// - dq: a block per (64-row q tile, b * h) walks the k tiles at or before
//   it and recomputes s, p and dp, with dq in registers.
// The two-pass form is deterministic (no atomics), at the price of seven
// [T, T]-sized products where the TPU kernel does five (s and dp twice).
// Rows past a ragged T load as zeros and their p is set to 0, so they add
// nothing (0 * NaN would survive). q, k, v, o and dO are read by strides
// (the split views of the fused qkv projection); dq, dk, dv are written
// contiguous [B, T, H, D]. wgmma, TMA and one fused pass are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // q rows per tile
constexpr int BN = 64;        // k rows per tile
constexpr int NWARPS = 4;     // each warp owns 16 rows of a tile
constexpr int NTHREADS = NWARPS * 32;

typedef __nv_bfloat16 bf16;

template <int D>
struct Layout {
  // padded row strides (elements) against shared-memory bank conflicts;
  // every wmma tile start stays 32-byte aligned
  static constexpr int LDB = D + 8;   // bf16 q/k/v/dO tiles
  static constexpr int LDS = BN + 4;  // fp32 scores / dp
  static constexpr int LDP = BN + 8;  // bf16 p / ds
  static constexpr int LDO = D + 4;   // fp32 output staging (aliases S, DP)
  static constexpr size_t TILE = sizeof(bf16) * BM * LDB;
  static constexpr size_t A = 0;                 // q (dkdv) / k (dq)
  static constexpr size_t B = A + TILE;          // dO (dkdv) / v (dq)
  static constexpr size_t C = B + TILE;          // k (dkdv) / q (dq)
  static constexpr size_t E = C + TILE;          // v (dkdv) / dO (dq)
  static constexpr size_t S = E + TILE;
  static constexpr size_t DP = S + sizeof(float) * BM * LDS;
  static constexpr size_t P = DP + sizeof(float) * BM * LDS;
  static constexpr size_t DS = P + sizeof(bf16) * BM * LDP;
  static constexpr size_t L = DS + sizeof(bf16) * BM * LDP;
  static constexpr size_t DL = L + sizeof(float) * BM;
  static constexpr size_t BYTES = DL + sizeof(float) * BM;
  static_assert(sizeof(float) * BM * LDO <= 2 * sizeof(float) * BM * LDS,
                "output staging must fit in the S and DP buffers");
};

// rows [row0, row0 + nrows) of one head into shared memory, 16 bytes a
// thread; rows at or past T are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int nrows, int T,
                                          int64_t row_stride) {
  constexpr int CHUNKS = D / 8;
  for (int idx = threadIdx.x; idx < nrows * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    const int t = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) {
      val = *reinterpret_cast<const uint4*>(src + t * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LDB + c) = val;
  }
}

// out[16 rows at `a`, 64 cols] = A (16 x D, row-major) x B^T, where B is
// 64 x D row-major (so B^T is read col-major): the s = q k^T and
// dp = dO v^T products for one warp's 16 rows, into fp32 `out` (ld LDS)
template <int D>
__device__ __forceinline__ void rows_times_tile_t(const bf16* a,
                                                  const bf16* b,
                                                  float* out) {
  using Lay = Layout<D>;
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, Lay::LDB);
      wmma::load_matrix_sync(fb, b + j * 16 * Lay::LDB + kk * 16, Lay::LDB);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, Lay::LDS, wmma::mem_row_major);
  }
}

// p and ds for one warp's 16 q rows of the tile (rows q0 + wrow.., cols
// k0..): p = exp(s * scale - lse) where the entry is live (inside T and
// under the causal mask) and 0 elsewhere; ds = p * (dp - delta). Both are
// rounded to bf16 into sP / sDS. Lane covers columns lane and lane + 32.
template <int D>
__device__ __forceinline__ void p_and_ds(const float* sS, const float* sDP,
                                         const float* sL, const float* sDL,
                                         bf16* sP, bf16* sDS, int wrow,
                                         int q0, int k0, int T, int causal,
                                         float sm_scale) {
  using Lay = Layout<D>;
  const int lane = threadIdx.x % 32;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wrow + rr;
    const int row = q0 + r;
    const float lse = sL[r];
    const float delta = sDL[r];
#pragma unroll
    for (int c = 0; c < BN / 32; ++c) {
      const int cc = lane + 32 * c;
      const int col = k0 + cc;
      const bool ok = row < T && col < T && (!causal || col <= row);
      const float p = ok ? __expf(sS[r * Lay::LDS + cc] * sm_scale - lse)
                         : 0.f;
      const float ds = p * (sDP[r * Lay::LDS + cc] - delta);
      sP[r * Lay::LDP + cc] = __float2bfloat16(p);
      sDS[r * Lay::LDP + cc] = __float2bfloat16(ds);
    }
  }
}

// acc[fragments of 16 rows x D] (scaled by `scale`) -> bf16 rows of a
// contiguous [B, T, H, D] output, through fp32 staging in shared memory
template <int D>
__device__ __forceinline__ void store_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    float* stage, bf16* out, int b, int h, int row0, int T, int H,
    float scale) {
  using Lay = Layout<D>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int i = 0; i < acc[j].num_elements; ++i) acc[j].x[i] *= scale;
    wmma::store_matrix_sync(stage + wrow * Lay::LDO + j * 16, acc[j],
                            Lay::LDO, wmma::mem_row_major);
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int t = row0 + wrow + rr;
    if (t >= T) break;
    bf16* orow = out + ((static_cast<int64_t>(b) * T + t) * H + h) * D;
    for (int d = lane; d < D; d += 32)
      orow[d] = __float2bfloat16(stage[(wrow + rr) * Lay::LDO + d]);
  }
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d] in fp32, a warp a
// row
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       float* __restrict__ delta, int B, int T, int H,
                       int64_t o_sb, int64_t o_st, int64_t o_sh,
                       int64_t d_sb, int64_t d_st, int64_t d_sh) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x
                       + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(B) * T * H) return;
  const int h = row % H;
  const int t = (row / H) % T;
  const int b = row / (static_cast<int64_t>(H) * T);
  const bf16* orow = o + b * o_sb + t * o_st + h * o_sh;
  const bf16* drow = dout + b * d_sb + t * d_st + h * d_sh;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32)
    sum += __bfloat162float(orow[d]) * __bfloat162float(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[(static_cast<int64_t>(b) * H + h) * T + t] = sum;
}

// dk, dv for one 64-row k/v tile of one (b, h): walk the q tiles that see
// it
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int T,
                      int H, int64_t q_sb, int64_t q_st, int64_t q_sh,
                      int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb,
                      int64_t v_st, int64_t v_sh, int64_t d_sb, int64_t d_st,
                      int64_t d_sh, int causal, float sm_scale) {
  using Lay = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + Lay::A);
  bf16* sDO = reinterpret_cast<bf16*>(smem + Lay::B);
  bf16* sK = reinterpret_cast<bf16*>(smem + Lay::C);
  bf16* sV = reinterpret_cast<bf16*>(smem + Lay::E);
  float* sS = reinterpret_cast<float*>(smem + Lay::S);
  float* sDP = reinterpret_cast<float*>(smem + Lay::DP);
  bf16* sP = reinterpret_cast<bf16*>(smem + Lay::P);
  bf16* sDS = reinterpret_cast<bf16*>(smem + Lay::DS);
  float* sL = reinterpret_cast<float*>(smem + Lay::L);
  float* sDL = reinterpret_cast<float*>(smem + Lay::DL);

  const int k0 = blockIdx.x * BN;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int warp = threadIdx.x / 32;
  const int wrow = warp * 16;

  const bf16* qh = q + b * q_sb + h * q_sh;
  const bf16* kh = k + b * k_sb + h * k_sh;
  const bf16* vh = v + b * v_sb + h * v_sh;
  const bf16* dh = dout + b * d_sb + h * d_sh;
  const float* lh = lse + (static_cast<int64_t>(b) * H + h) * T;
  const float* dlh = delta + (static_cast<int64_t>(b) * H + h) * T;

  load_tile<D>(sK, kh, k0, BN, T, k_st);
  load_tile<D>(sV, vh, k0, BN, T, v_st);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_dk[D / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_dv[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.f);
    wmma::fill_fragment(acc_dv[j], 0.f);
  }

  // causal: q tiles before this k tile see none of it (BM == BN)
  const int first = causal ? k0 / BM : 0;
  const int n_q = (T + BM - 1) / BM;
  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();   // the previous tile's products are done with sQ..sDS
    load_tile<D>(sQ, qh, q0, BM, T, q_st);
    load_tile<D>(sDO, dh, q0, BM, T, d_st);
    for (int i = threadIdx.x; i < BM; i += NTHREADS) {
      const bool in = q0 + i < T;
      sL[i] = in ? lh[q0 + i] : 0.f;
      sDL[i] = in ? dlh[q0 + i] : 0.f;
    }
    __syncthreads();

    // s = q k^T and dp = dO v^T for this warp's 16 q rows
    rows_times_tile_t<D>(sQ + wrow * Lay::LDB, sK, sS + wrow * Lay::LDS);
    rows_times_tile_t<D>(sDO + wrow * Lay::LDB, sV, sDP + wrow * Lay::LDS);
    __syncwarp();
    p_and_ds<D>(sS, sDP, sL, sDL, sP, sDS, wrow, q0, k0, T, causal,
                sm_scale);
    __syncthreads();   // every q row of p and ds is in shared memory

    // dv[k rows] += p^T dO and dk[k rows] += ds^T q for this warp's 16 k
    // rows: p^T and ds^T are p and ds read col-major
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + kk * 16 * Lay::LDP + wrow, Lay::LDP);
        wmma::load_matrix_sync(fb, sDO + kk * 16 * Lay::LDB + j * 16,
                               Lay::LDB);
        wmma::mma_sync(acc_dv[j], fa, fb, acc_dv[j]);
        wmma::load_matrix_sync(fa, sDS + kk * 16 * Lay::LDP + wrow,
                               Lay::LDP);
        wmma::load_matrix_sync(fb, sQ + kk * 16 * Lay::LDB + j * 16,
                               Lay::LDB);
        wmma::mma_sync(acc_dk[j], fa, fb, acc_dk[j]);
      }
    }
  }

  __syncthreads();   // S and DP become the output staging
  float* stage = sS;
  store_rows<D>(acc_dk, stage, dk, b, h, k0, T, H, sm_scale);
  __syncwarp();      // each warp stages and reads back only its own rows
  store_rows<D>(acc_dv, stage, dv, b, h, k0, T, H, 1.f);
}

// dq for one 64-row q tile of one (b, h): walk the k tiles it sees
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int T, int H, int64_t q_sb, int64_t q_st, int64_t q_sh,
                    int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb,
                    int64_t v_st, int64_t v_sh, int64_t d_sb, int64_t d_st,
                    int64_t d_sh, int causal, float sm_scale) {
  using Lay = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + Lay::A);
  bf16* sV = reinterpret_cast<bf16*>(smem + Lay::B);
  bf16* sQ = reinterpret_cast<bf16*>(smem + Lay::C);
  bf16* sDO = reinterpret_cast<bf16*>(smem + Lay::E);
  float* sS = reinterpret_cast<float*>(smem + Lay::S);
  float* sDP = reinterpret_cast<float*>(smem + Lay::DP);
  bf16* sP = reinterpret_cast<bf16*>(smem + Lay::P);
  bf16* sDS = reinterpret_cast<bf16*>(smem + Lay::DS);
  float* sL = reinterpret_cast<float*>(smem + Lay::L);
  float* sDL = reinterpret_cast<float*>(smem + Lay::DL);

  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int warp = threadIdx.x / 32;
  const int wrow = warp * 16;

  const bf16* qh = q + b * q_sb + h * q_sh;
  const bf16* kh = k + b * k_sb + h * k_sh;
  const bf16* vh = v + b * v_sb + h * v_sh;
  const bf16* dh = dout + b * d_sb + h * d_sh;
  const float* lh = lse + (static_cast<int64_t>(b) * H + h) * T;
  const float* dlh = delta + (static_cast<int64_t>(b) * H + h) * T;

  load_tile<D>(sQ, qh, q0, BM, T, q_st);
  load_tile<D>(sDO, dh, q0, BM, T, d_st);
  for (int i = threadIdx.x; i < BM; i += NTHREADS) {
    const bool in = q0 + i < T;
    sL[i] = in ? lh[q0 + i] : 0.f;
    sDL[i] = in ? dlh[q0 + i] : 0.f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_dq[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc_dq[j], 0.f);

  const int last_row = min(q0 + BM, T) - 1;
  const int n_k = causal ? last_row / BN + 1 : (T + BN - 1) / BN;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();   // the previous tile's products are done with sK/sV
    load_tile<D>(sK, kh, k0, BN, T, k_st);
    load_tile<D>(sV, vh, k0, BN, T, v_st);
    __syncthreads();

    // everything below touches only this warp's 16 q rows
    rows_times_tile_t<D>(sQ + wrow * Lay::LDB, sK, sS + wrow * Lay::LDS);
    rows_times_tile_t<D>(sDO + wrow * Lay::LDB, sV, sDP + wrow * Lay::LDS);
    __syncwarp();
    p_and_ds<D>(sS, sDP, sL, sDL, sP, sDS, wrow, q0, k0, T, causal,
                sm_scale);
    __syncwarp();
    // dq[q rows] += ds k
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sDS + wrow * Lay::LDP + kk * 16,
                               Lay::LDP);
        wmma::load_matrix_sync(fb, sK + kk * 16 * Lay::LDB + j * 16,
                               Lay::LDB);
        wmma::mma_sync(acc_dq[j], fa, fb, acc_dq[j]);
      }
    }
  }

  __syncthreads();
  store_rows<D>(acc_dq, sS, dq, b, h, q0, T, H, sm_scale);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv, int B, int T,
                   int H, const int* st, int causal, float sm_scale,
                   cudaStream_t stream) {
  // st: strides (batch, row, head) of q, k, v, o, dO, in that order
  constexpr size_t smem = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;

  const int64_t rows = static_cast<int64_t>(B) * T * H;
  const int64_t delta_blocks = (rows * 32 + 255) / 256;
  flash_bwd_delta_kernel<D><<<static_cast<unsigned>(delta_blocks), 256, 0,
                              stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), B, T, H, st[9], st[10], st[11], st[12],
      st[13], st[14]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_k((T + BN - 1) / BN, B * H);
  flash_bwd_dkdv_kernel<D><<<grid_k, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13],
      st[14], causal, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_q((T + BM - 1) / BM, B * H);
  flash_bwd_dq_kernel<D><<<grid_q, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), T, H, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[12], st[13], st[14], causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dO: bf16 [B, T, H, D] with unit stride over D and strides
// (in elements) *_sb over batch, *_st over rows, *_sh over heads; lse:
// fp32 [B, H, T] contiguous (the forward's); delta: fp32 [B, H, T]
// scratch; dq, dk, dv: bf16 [B, T, H, D] contiguous. Three kernels on the
// stream (delta, dk/dv, dq). Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for an unsupported head_dim).
extern "C" int rlt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const void* lse, void* delta, void* dq,
                             void* dk, void* dv, int B, int T, int H, int D,
                             int q_sb, int q_st, int q_sh, int k_sb,
                             int k_st, int k_sh, int v_sb, int v_st,
                             int v_sh, int o_sb, int o_st, int o_sh,
                             int d_sb, int d_st, int d_sh, int causal,
                             float sm_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int st[15] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                      v_sh, o_sb, o_st, o_sh, d_sb, d_st, d_sh};
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, T, H,
                        st, causal, sm_scale, s);
    case 32:
      return launch<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, T, H,
                        st, causal, sm_scale, s);
    case 64:
      return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, T, H,
                        st, causal, sm_scale, s);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, T, H,
                         st, causal, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
