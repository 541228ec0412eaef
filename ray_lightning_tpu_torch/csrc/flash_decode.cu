// flash_decode: one query token per slot against the slot KV cache, read
// either slot-contiguously or through a page table.
//
// Replaces: ray_lightning_tpu/ops/flash_decode.py `flash_decode_kernel`
// (body `_decode_body`, launched by `flash_decode_attention`), the
// length-aware Pallas decode kernel of the serve plane's decode step
// (entry point rlt_flash_decode); and `flash_decode_paged_kernel`, the
// same body whose KV BlockSpec walks a page table (`flash_decode_
// attention(..., page_table=)`: paged decode, the prefix-reuse suffix
// step, speculative draft and verify; entry point rlt_flash_decode_paged).
//
// What bounds it on this card: bytes. Each (slot, head) reads its q row
// and the positions[s] + 1 live rows of k and v, and does 4 flops per
// byte pair it reads, far below the ~295 flops a byte where the tensor
// cores would become the limit. At S=16 slots and a full 1024-row
// context one layer's live K+V is 2 * 16 * 1024 * 768 * 2 B = 50 MB,
// about 15 us at 3.35 TB/s.
//
// What the design does about that:
// - length-aware reads, the point of the TPU kernel's `kv_block_bound`
//   clamp: the block walks 64-row tiles only up to positions[s], and no
//   row past positions[s] is loaded, so a short context costs what it
//   holds, not the cache's L;
// - one block per (slot, head), 4 warps; in the score phase D/8 lanes
//   share one row with 16-byte loads, in the PV phase D/2 lanes share
//   one row with 4-byte loads, so each warp's loads are contiguous;
// - online softmax in fp32 (running max, sum, accumulator in registers,
//   rescaled per tile), p cast to bf16 before the PV product as the TPU
//   kernel does, output bf16; any L, with no fallback to a dense path
//   (the TPU fallback answered a lane constraint this card lacks).
// The page-table walk: the TPU kernel fetches one whole page a grid step
// (its block_k is the page size), so its indirection is per block. Here
// a 64-row tile spans 64 / page_size pages (4 at the default page size
// 16) and page_size may be any divisor of L, so the address is resolved
// per row: logical row r of slot s is row r % page_size of physical page
// table[s, r / page_size]. Both kernels share one body through a
// row-addressing policy (SlotCache, PagedCache), so they do the same
// arithmetic in the same order. Cache rows and the table go through the
// read-only load path (__ldg); the table costs one int a row, cached in
// L1 across the block's warps. Masking stays in logical rows, so rows
// past positions[s], and the table entries of their pages, are never
// read. A page id outside [0, n_pages) is clamped
// into it: a bad table gives wrong numbers, never an out-of-bounds read.
// Split-KV across SMs (not done yet): at S=16, S * H = 192 blocks already
// cover the 132 SMs; at S <= 4 (48 blocks) most SMs would idle, and
// splitting each context over several blocks plus an lse combine is the
// answer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;         // cache rows per tile
constexpr int NTHREADS = 128;  // 4 warps
constexpr int NWARPS = NTHREADS / 32;

typedef __nv_bfloat16 bf16;

// The slot-contiguous cache [S, L, H, D] ...
struct SlotCache {
  const bf16* p;
  int64_t ss, sl, sh;  // slot, row and head strides

  struct Rows {
    const bf16* base;  // row 0 of one slot and head
    int64_t sl;
    __device__ __forceinline__ const bf16* row(int r) const {
      return base + r * sl;
    }
  };

  __device__ __forceinline__ Rows at(int s, int h) const {
    return Rows{p + s * ss + h * sh, sl};
  }
};

// ... and the page view [n_pages, page_size, H, D] through a table
// [S, n_cols] of physical page ids.
struct PagedCache {
  const bf16* p;
  const int* table;
  int n_pages, n_cols, page_size;
  int64_t sp, sl, sh;  // page, row and head strides

  struct Rows {
    const bf16* base;   // page 0, row 0 of one head
    const int* table;   // one slot's row of the table
    int n_pages, page_size;
    int64_t sp, sl;
    __device__ __forceinline__ const bf16* row(int r) const {
      const int pg =
          min(max(__ldg(table + r / page_size), 0), n_pages - 1);
      return base + pg * sp + (r % page_size) * sl;
    }
  };

  __device__ __forceinline__ Rows at(int s, int h) const {
    return Rows{p + h * sh, table + static_cast<int64_t>(s) * n_cols,
                n_pages, page_size, sp, sl};
  }
};

__device__ __forceinline__ float dot8(const float* qf, uint4 raw) {
  const __nv_bfloat162* kv = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(kv[i]);
    acc = fmaf(qf[2 * i], f.x, acc);
    acc = fmaf(qf[2 * i + 1], f.y, acc);
  }
  return acc;
}

template <int D, class Cache>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_kernel(const bf16* __restrict__ q, const Cache kc,
                    const Cache vc, const int* __restrict__ positions,
                    bf16* __restrict__ o, int L, int H, int64_t q_ss,
                    int64_t q_sh, float sm_scale) {
  constexpr int LPR = D / 8;         // score phase: lanes per row
  constexpr int RPW = 32 / LPR;      // score phase: rows per warp step
  constexpr int DP = D / 2;          // PV phase: threads per row
  constexpr int RG = NTHREADS / DP;  // PV phase: row groups
  static_assert(BK % (NWARPS * RPW) == 0, "score rows must tile BK");

  __shared__ float sP[BK];
  __shared__ float sAcc[RG][D];
  __shared__ float sL[RG];

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // a position past the cache is clamped to its last row, as the
  // plain version does; the serve scheduler never sends one
  const int pos = min(max(positions[s], 0), L - 1);

  const typename Cache::Rows kr = kc.at(s, h);
  const typename Cache::Rows vr = vc.at(s, h);

  // score phase: this lane's 8-element slice of q in fp32
  const int sub = lane % LPR;
  float qf[8];
  {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + s * q_ss + h * q_sh + sub * 8);
    const __nv_bfloat162* qv = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(qv[i]);
      qf[2 * i] = f.x;
      qf[2 * i + 1] = f.y;
    }
  }

  // PV phase: this thread's two output columns and row group
  const int dcol = (tid % DP) * 2;
  const int rg = tid / DP;
  float acc0 = 0.f, acc1 = 0.f, l_part = 0.f;
  float m_run = NEG_INF;

  const int n_tiles = pos / BK + 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int base = t * BK;

    // scores of the tile's live rows; rows past pos are never loaded
#pragma unroll
    for (int r0 = 0; r0 < BK; r0 += NWARPS * RPW) {
      const int r = r0 + warp * RPW + lane / LPR;
      const int row = base + r;
      float part = 0.f;
      if (row <= pos)
        part = dot8(qf, __ldg(reinterpret_cast<const uint4*>(
                            kr.row(row) + sub * 8)));
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (sub == 0) sP[r] = row <= pos ? part * sm_scale : NEG_INF;
    }
    __syncthreads();

    // tile max, computed redundantly by every warp (no extra barrier)
    float mx = NEG_INF;
    for (int r = lane; r < BK; r += 32) mx = fmaxf(mx, sP[r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = __expf(m_run - m_new);
    m_run = m_new;
    __syncthreads();   // every warp has read the scores
    if (tid < BK)
      sP[tid] = base + tid <= pos ? __expf(sP[tid] - m_new) : 0.f;
    __syncthreads();

    // PV over the tile: l sums fp32 p, the product takes bf16(p)
    acc0 *= alpha;
    acc1 *= alpha;
    l_part *= alpha;
    for (int r = rg; r < BK; r += RG) {
      const int row = base + r;
      if (row > pos) break;
      const float p = sP[r];
      const float pb = __bfloat162float(__float2bfloat16(p));
      const unsigned int vbits =
          __ldg(reinterpret_cast<const unsigned int*>(vr.row(row) + dcol));
      const float2 vv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&vbits));
      acc0 = fmaf(pb, vv.x, acc0);
      acc1 = fmaf(pb, vv.y, acc1);
      l_part += p;
    }
    __syncthreads();   // sP is rewritten by the next tile
  }

  // combine the row groups: o = sum(acc) / sum(l)
  sAcc[rg][dcol] = acc0;
  sAcc[rg][dcol + 1] = acc1;
  if (tid % DP == 0) sL[rg] = l_part;
  __syncthreads();
  if (tid < D) {
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int g = 0; g < RG; ++g) {
      a += sAcc[g][tid];
      l += sL[g];
    }
    // l > 0: row 0 is always live
    o[(static_cast<int64_t>(s) * H + h) * D + tid] = __float2bfloat16(a / l);
  }
}

template <int D, class Cache>
cudaError_t launch(const void* q, const Cache& kc, const Cache& vc,
                   const void* positions, void* o, int S, int L, int H,
                   int64_t q_ss, int64_t q_sh, float sm_scale,
                   cudaStream_t stream) {
  dim3 grid(S, H);
  flash_decode_kernel<D, Cache><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), kc, vc,
      static_cast<const int*>(positions), static_cast<bf16*>(o), L, H, q_ss,
      q_sh, sm_scale);
  return cudaGetLastError();
}

template <class Cache>
int dispatch(int D, const void* q, const Cache& kc, const Cache& vc,
             const void* positions, void* o, int S, int L, int H,
             int64_t q_ss, int64_t q_sh, float sm_scale, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      err = launch<16>(q, kc, vc, positions, o, S, L, H, q_ss, q_sh,
                       sm_scale, st);
      break;
    case 32:
      err = launch<32>(q, kc, vc, positions, o, S, L, H, q_ss, q_sh,
                       sm_scale, st);
      break;
    case 64:
      err = launch<64>(q, kc, vc, positions, o, S, L, H, q_ss, q_sh,
                       sm_scale, st);
      break;
    case 128:
      err = launch<128>(q, kc, vc, positions, o, S, L, H, q_ss, q_sh,
                        sm_scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// q: bf16 [S, 1, H, D] (strides q_ss over slots, q_sh over heads);
// k_cache, v_cache: bf16 [S, L, H, D] (strides *_ss, *_sl, *_sh); unit
// stride over D everywhere; positions: int32 [S] on the device; o: bf16
// [S, 1, H, D] contiguous. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported head_dim).
extern "C" int rlt_flash_decode(const void* q, const void* k_cache,
                                const void* v_cache, const void* positions,
                                void* o, int S, int L, int H, int D,
                                int q_ss, int q_sh, int k_ss, int k_sl,
                                int k_sh, int v_ss, int v_sl, int v_sh,
                                float sm_scale, int device, void* stream) {
  const SlotCache kc{static_cast<const bf16*>(k_cache), k_ss, k_sl, k_sh};
  const SlotCache vc{static_cast<const bf16*>(v_cache), v_ss, v_sl, v_sh};
  return dispatch(D, q, kc, vc, positions, o, S, L, H, q_ss, q_sh,
                  sm_scale, device, stream);
}

// The paged form. k_pages, v_pages: bf16 [N, page_size, H, D] (strides
// *_sp over pages, *_sl over rows, *_sh over heads; unit stride over D);
// table: int32 [S, P] contiguous on the device, physical page ids; slot
// s attends its logical rows <= positions[s] of L = P * page_size. The
// rest as rlt_flash_decode.
extern "C" int rlt_flash_decode_paged(
    const void* q, const void* k_pages, const void* v_pages,
    const void* positions, const void* table, void* o, int S, int N, int P,
    int page_size, int H, int D, int q_ss, int q_sh, int k_sp, int k_sl,
    int k_sh, int v_sp, int v_sl, int v_sh, float sm_scale, int device,
    void* stream) {
  const int* tab = static_cast<const int*>(table);
  const PagedCache kc{static_cast<const bf16*>(k_pages), tab, N, P,
                      page_size, k_sp, k_sl, k_sh};
  const PagedCache vc{static_cast<const bf16*>(v_pages), tab, N, P,
                      page_size, v_sp, v_sl, v_sh};
  return dispatch(D, q, kc, vc, positions, o, S, P * page_size, H, q_ss,
                  q_sh, sm_scale, device, stream);
}
