// flash_fwd: causal (or full) attention forward for Hopper, FA2-style.
//
// Replaces: ray_lightning_tpu/ops/flash_attention.py `_fwd_packed_kernel`
// (launched by `_fwd_packed`, reached from `flash_attention` -> `_fwd`),
// the single-block head-packed Pallas forward that serves every prefill
// bucket T <= 1024 at head_dim 64.
//
// What bounds it on this card: at the serve path's shapes (B=1, H=12,
// D=64, T <= 1024) the work is small. One layer's q, k, v and o are
// 4 * T * 768 * 2 bytes (6.3 MB at T=1024), about 2 us at 3.35 TB/s; its
// causal matmuls are 2 * 2 * T^2/2 * 64 * 12 flops (1.6 GFLOP), about 2 us
// at 989 TFLOP/s. So it sits near the ridge and a simple kernel is bound
// by neither: it is bound by latency, shared-memory traffic and the
// mma.sync rate that wmma reaches without wgmma.
//
// What the design does about that, simply and correctly first:
// - grid (q tile of 64 rows, batch * head), 4 warps, each warp owns 16
//   query rows; a loop over 64-row k/v tiles held in shared memory, so
//   k/v are read from device memory once per q tile, never the T x T
//   scores;
// - online softmax with fp32 running max, sum and accumulator (the
//   accumulator lives in shared memory so rows can be rescaled; the
//   TPU kernel's whole-row softmax and 256-row staircase answer VMEM
//   and lane limits this card does not have);
// - causal tile skipping: a q tile stops at the k tile holding its last
//   row; masking of the ragged last tile (rows past T load as zeros,
//   columns past T are masked), so any T >= 1 works;
// - q/k/v are read in the caller's [B, T, H*D] layout by strides (the
//   split views of the fused qkv projection), with no transpose;
// - NEG_INF = -1e30 masking, scores scaled by sm_scale in fp32, p cast
//   to bf16 before the PV product (as the TPU kernel does), bf16 in and
//   out, fp32 lse [B, H, T] written for the backward pass to come.
// wgmma, TMA and a producer warp are for a later, faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // key rows per tile
constexpr int NWARPS = 4;     // each warp owns 16 query rows
constexpr int NTHREADS = NWARPS * 32;

typedef __nv_bfloat16 bf16;

template <int D>
struct Layout {
  // padded row strides (elements) against shared-memory bank conflicts;
  // every wmma tile start stays 32-byte aligned
  static constexpr int LDB = D + 8;   // bf16 q/k/v tiles
  static constexpr int LDS = BN + 4;  // fp32 scores
  static constexpr int LDP = BN + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // fp32 output accumulator
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + sizeof(bf16) * BM * LDB;
  static constexpr size_t V = K + sizeof(bf16) * BN * LDB;
  static constexpr size_t S = V + sizeof(bf16) * BN * LDB;
  static constexpr size_t P = S + sizeof(float) * BM * LDS;
  static constexpr size_t O = P + sizeof(bf16) * BM * LDP;
  static constexpr size_t M = O + sizeof(float) * BM * LDO;
  static constexpr size_t L = M + sizeof(float) * BM;
  static constexpr size_t A = L + sizeof(float) * BM;
  static constexpr size_t BYTES = A + sizeof(float) * BM;
};

// rows [row0, row0 + nrows) of one head into shared memory, 16 bytes a
// thread; rows at or past T are zero-filled (a NaN there would survive
// 0 * NaN in the PV product)
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

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int H, int64_t q_sb,
                 int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
                 int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
                 int causal, float sm_scale) {
  using Lay = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + Lay::Q);
  bf16* sK = reinterpret_cast<bf16*>(smem + Lay::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + Lay::V);
  float* sS = reinterpret_cast<float*>(smem + Lay::S);
  bf16* sP = reinterpret_cast<bf16*>(smem + Lay::P);
  float* sO = reinterpret_cast<float*>(smem + Lay::O);
  float* sM = reinterpret_cast<float*>(smem + Lay::M);
  float* sL = reinterpret_cast<float*>(smem + Lay::L);
  float* sA = reinterpret_cast<float*>(smem + Lay::A);

  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;   // this warp's first row inside the tile

  const bf16* qh = q + b * q_sb + h * q_sh;
  const bf16* kh = k + b * k_sb + h * k_sh;
  const bf16* vh = v + b * v_sb + h * v_sh;

  load_tile<D>(sQ, qh, q0, BM, T, q_st);
  for (int i = threadIdx.x; i < BM * Lay::LDO; i += NTHREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BM; i += NTHREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }

  const int last_row = min(q0 + BM, T) - 1;
  const int n_tiles = causal ? last_row / BN + 1 : (T + BN - 1) / BN;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();   // the previous tile's PV is done with sK/sV
    load_tile<D>(sK, kh, k0, BN, T, k_st);
    load_tile<D>(sV, vh, k0, BN, T, v_st);
    __syncthreads();

    // S[wrow:wrow+16, :] = Q K^T for this warp's rows
    for (int j = 0; j < BN / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, sQ + wrow * Lay::LDB + kk * 16, Lay::LDB);
        wmma::load_matrix_sync(bt, sK + j * 16 * Lay::LDB + kk * 16,
                               Lay::LDB);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(sS + wrow * Lay::LDS + j * 16, acc, Lay::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this warp's 16 rows; lane covers columns
    // lane and lane + 32 of the tile
    for (int rr = 0; rr < 16; ++rr) {
      const int r = wrow + rr;
      const int row = q0 + r;
      float s[BN / 32];
      bool ok[BN / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        const int col = k0 + lane + 32 * c;
        ok[c] = col < T && (!causal || col <= row);
        s[c] = ok[c] ? sS[r * Lay::LDS + lane + 32 * c] * sm_scale : NEG_INF;
        mx = fmaxf(mx, s[c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        const float p = ok[c] ? __expf(s[c] - m_new) : 0.f;
        sum += p;
        sP[r * Lay::LDP + lane + 32 * c] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = wrow + rr;
      const float alpha = sA[r];
      for (int d = lane; d < D; d += 32) sO[r * Lay::LDO + d] *= alpha;
    }
    __syncwarp();

    // O[wrow:wrow+16, :] += P V
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + wrow * Lay::LDO + j * 16, Lay::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sP + wrow * Lay::LDP + kk * 16, Lay::LDP);
        wmma::load_matrix_sync(bv, sV + kk * 16 * Lay::LDB + j * 16,
                               Lay::LDB);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(sO + wrow * Lay::LDO + j * 16, acc, Lay::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // epilogue: o = acc / l in bf16, lse = m + log(l); rows past T are
  // not written
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wrow + rr;
    const int row = q0 + r;
    if (row >= T) break;
    const float l = sL[r];
    const float inv = 1.f / l;
    bf16* orow = o + ((static_cast<int64_t>(b) * T + row) * H + h) * D;
    for (int d = lane; d < D; d += 32)
      orow[d] = __float2bfloat16(sO[r * Lay::LDO + d] * inv);
    if (lane == 0)
      lse[(static_cast<int64_t>(b) * H + h) * T + row] = sM[r] + logf(l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int T, int H, int64_t q_sb,
                   int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
                   int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
                   int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((T + BM - 1) / BM, B * H);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), T, H, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
      v_sb, v_st, v_sh, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 [B, T, H, D] with unit stride over D and strides (in
// elements) *_sb over batch, *_st over rows, *_sh over heads; o: bf16
// [B, T, H, D] contiguous; lse: fp32 [B, H, T] contiguous. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported head_dim).
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
                        k_st, k_sh, v_sb, v_st, v_sh, causal, sm_scale, s);
    case 32:
      return launch<32>(q, k, v, o, lse, B, T, H, q_sb, q_st, q_sh, k_sb,
                        k_st, k_sh, v_sb, v_st, v_sh, causal, sm_scale, s);
    case 64:
      return launch<64>(q, k, v, o, lse, B, T, H, q_sb, q_st, q_sh, k_sb,
                        k_st, k_sh, v_sb, v_st, v_sh, causal, sm_scale, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, T, H, q_sb, q_st, q_sh, k_sb,
                         k_st, k_sh, v_sb, v_st, v_sh, causal, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
