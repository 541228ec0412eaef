// flash_decode: one query token per slot against the slot KV cache, read
// either slot-contiguously or through a page table, as a split-KV
// (flash-decoding) kernel for Hopper.
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
// cores would become the limit; with one query row per (slot, head) the
// products are M = 1, so tensor cores are not the lever either. The
// bound is the live rows' bytes: at S=16 slots, H=12, D=64 and the
// smoke's mixed positions (7,145 live rows) one layer's live K+V is
// 2 * 7145 * 768 * 2 B = 22 MB, 6.6 us at 3.35 TB/s. So little data
// spread over 132 SMs is bound by latency unless many blocks keep many
// bytes in flight at once.
//
// What the design does about that:
// - split-KV: the grid is (head, slot, split); split j of (s, h) walks
//   rows [j * chunk, min((j + 1) * chunk, positions[s] + 1)) in 64-row
//   tiles, and a split that starts past positions[s] exits at once. The
//   chunk (a multiple of 64) and the split count come from the shapes
//   and the card's SM count alone (ops/flash_decode.py
//   `decode_split_plan`), never from the positions, which stay on the
//   device;
// - bytes in flight: a block streams its K and V tiles through a ring of
//   up to 6 stages in shared memory (16 KB a stage at D=64) with 16-byte
//   cp.async.cg copies: every stage is filled at the start, so a split
//   of at most that many tiles is in flight at once, and a longer one
//   keeps nst - 1 tiles ahead of the one it computes; one __syncthreads
//   a tile (the wait for tile t also frees tile t - 1's stage, which the
//   next copy refills). Rows past positions[s] are zero-filled by the
//   copy (source size 0) and never read;
// - the compute reads shared memory only: each of the 4 warps takes 16
//   rows of every tile and keeps its own online softmax (running max,
//   sum, fp32 accumulator), so a tile needs no barrier between warps:
//   the score phase puts D/8 lanes on a row (16-byte reads), the PV
//   phase min(32, D/2) lanes on a row; the warps merge once, at the end;
// - the paged form resolves the table once per page: a block first
//   loads the table entries of the pages its live rows touch into
//   shared memory (clamped into [0, n_pages): a bad table gives wrong
//   numbers, never an out-of-bounds read); a copy's source is then
//   page base + row in page. No table entry past positions[s]'s page
//   is read;
// - deterministic combine in the same launch: a (slot, head) whose live
//   rows fit in split 0 writes o directly. Otherwise each split leaves
//   fp32 (m_j, l_j, acc_j[D]) in a workspace, and the last of its live
//   splits to arrive (an int ticket taken by a release-acquire add after
//   a block barrier, the pattern of CUTLASS's semaphores) merges
//   them in index order (all (m_j, l_j) staged in shared memory in one
//   round trip, 8 acc loads in flight a column), M = max m_j, o = sum e^(m_j - M) acc_j /
//   sum e^(m_j - M) l_j, and resets the ticket to 0. No float atomics:
//   two calls agree bit for bit. The wrapper allocates the workspace and
//   the tickets (zeroed once); the kernel allocates nothing.
// Rounding points as `_decode_body`: fp32 scores scaled by sm_scale,
// NEG_INF = -1e30 masking, p = exp(s - m_run) rounded to bf16 before the
// PV product with fp32 accumulation, l summing the fp32 p, bf16 output.
// p is taken against the warp's running max over its rows of the split
// (the TPU body's against its running max per 128-row block) and
// rescaled in fp32 at the merges. Both entry points run one body with
// one plan and one order of arithmetic, so the paged kernel equals the
// slot-contiguous one bit for bit on the same logical cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;          // cache rows per tile
constexpr int NTHREADS = 128;   // 4 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int WROWS = BK / NWARPS;   // rows of a tile each warp takes
constexpr int MAX_STAGES = 8;   // ring depth, cp_async_wait's cases
constexpr int RING_BYTES = 96 * 1024;
// dynamic shared memory a launch may ask for (ring, parts' (m, l),
// table slice)
constexpr int SMEM_CAP = 200 * 1024;
constexpr int MERGE_BATCH = 8;  // merge: acc loads in flight a thread

typedef __nv_bfloat16 bf16;

// The cache as the kernel addresses it: element (lead, row, h, 0) at
// p + lead * s_lead + row * s_row + h * s_head. Slot-contiguous
// [S, L, H, D]: lead is the slot, row the cache row. Page view
// [N, page_size, H, D]: lead is the physical page, row the row in it.
struct Cache {
  const bf16* p;
  int64_t s_lead, s_row, s_head;
};

// The page table: [S, n_cols] int32 physical page ids (paged form only).
struct Table {
  const int* p;
  int n_pages, n_cols, page_size;
};

// 16 bytes global -> shared, bypassing L1; L2 fetches the whole 128-byte
// line (a D=64 row: its other 7 chunks are the neighbouring lanes')
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(d),
      "l"(src), "r"(src_bytes)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

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

// The lane layouts for head dim D.
template <int D>
struct Lanes {
  static constexpr int CH = D / 8;               // 16-byte chunks a row
  static constexpr int KL = D / 8;               // score: lanes a row
  static constexpr int KR = 32 / KL;             // score: rows a step
  static constexpr int KSTEPS = WROWS / KR;      // score: steps a tile
  static constexpr int VL = D / 2 < 32 ? D / 2 : 32;   // PV: lanes a row
  static constexpr int VC = D / VL;              // PV: columns a lane
  static constexpr int VG = 32 / VL;             // PV: row groups a warp
  static constexpr int STAGE = 2 * BK * D;       // bf16 elements a stage
  static_assert(WROWS % KR == 0 && WROWS % VG == 0, "lane layout");
  static_assert(VC == 2 || VC == 4, "PV loads 4 or 8 bytes a lane");
};

template <int D, bool PAGED>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_kernel(const bf16* __restrict__ q, const Cache kc,
                    const Cache vc, const Table tab,
                    const int* __restrict__ positions, bf16* __restrict__ o,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    int* __restrict__ tickets, int L, int H, int64_t q_ss,
                    int64_t q_sh, int chunk, int n_split, int nst,
                    float sm_scale) {
  using G = Lanes<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* sML = reinterpret_cast<float*>(ring + nst * G::STAGE);
  int* sTab = reinterpret_cast<int*>(sML + 2 * n_split);
  __shared__ float sP[NWARPS][WROWS];
  __shared__ float sM[NWARPS], sL[NWARPS];
  __shared__ float sAcc[NWARPS][D];
  __shared__ int sLast;

  // every (slot, head)'s split 0 is dispatched first, the splits that
  // positions leave empty (and exit at once) last
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int j = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // score phase: this lane's 8-element slice of q in fp32 (loaded
  // before the position, which it does not depend on)
  const int sub = lane % G::KL;
  const uint4 qraw = *reinterpret_cast<const uint4*>(
      q + s * q_ss + h * q_sh + sub * 8);
  // a position past the cache is clamped to its last row, as the plain
  // version does; the serve scheduler never sends one
  const int pos = min(max(positions[s], 0), L - 1);
  const int lo = j * chunk;
  if (lo > pos) return;           // no live row in this split
  const int hi = min(lo + chunk, pos + 1);     // live rows [lo, hi)
  const int n_tiles = (hi - lo + BK - 1) / BK;
  const int n_live = pos / chunk + 1;          // splits with a live row

  float qf[8];
  {
    const __nv_bfloat162* qv = reinterpret_cast<const __nv_bfloat162*>(&qraw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(qv[i]);
      qf[2 * i] = f.x;
      qf[2 * i + 1] = f.y;
    }
  }

  // the paged form: the table entries of the pages rows [lo, hi) touch
  int first_page = 0;
  if constexpr (PAGED) {
    first_page = lo / tab.page_size;
    const int n = (hi - 1) / tab.page_size - first_page + 1;
    const int* row = tab.p + static_cast<int64_t>(s) * tab.n_cols;
    for (int i = tid; i < n; i += NTHREADS)
      sTab[i] = min(max(__ldg(row + first_page + i), 0), tab.n_pages - 1);
    __syncthreads();
  }
  const bf16* kbase = kc.p + h * kc.s_head;
  const bf16* vbase = vc.p + h * vc.s_head;

  // copy tile t of the split into stage t % nst (rows past the position
  // zero-filled from a live row's address, read nowhere), one group
  auto issue = [&](int t) {
    if (t < n_tiles) {
      bf16* sk = ring + (t % nst) * G::STAGE;
      bf16* sv = sk + BK * D;
      const int base = lo + t * BK;
#pragma unroll
      for (int i = 0; i < BK * G::CH / NTHREADS; ++i) {
        const int c = tid + i * NTHREADS;
        const int r = c / G::CH;
        const int cc = (c % G::CH) * 8;
        const int row = base + r;
        const int src = row < hi ? row : pos;
        int64_t lead, rr;
        if constexpr (PAGED) {
          lead = sTab[src / tab.page_size - first_page];
          rr = src % tab.page_size;
        } else {
          lead = s;
          rr = src;
        }
        const int bytes = row < hi ? 16 : 0;
        cp_async16(sk + r * D + cc,
                   kbase + lead * kc.s_lead + rr * kc.s_row + cc, bytes);
        cp_async16(sv + r * D + cc,
                   vbase + lead * vc.s_lead + rr * vc.s_row + cc, bytes);
      }
    }
    cp_async_commit();
  };

  // PV phase: this lane's columns and row group
  const int vl = lane % G::VL;
  const int vg = lane / G::VL;
  float acc[G::VC];
#pragma unroll
  for (int c = 0; c < G::VC; ++c) acc[c] = 0.f;
  float l_part = 0.f;
  float m_run = NEG_INF;

  // every stage filled first (a split of at most nst tiles is then all
  // in flight); each later tile refills the stage its tile - nst freed
  for (int t = 0; t < nst; ++t) issue(t);
  for (int t = 0; t < n_tiles; ++t) {
    // this thread's copies of tile t landed: nst groups were committed
    // before tile 0, one more before each later tile
    cp_async_wait(t == 0 ? nst - 1 : nst - 2);
    __syncthreads();          // everyone's did, and tile t - 1 is done
    if (t > 0) issue(t - 1 + nst);   // into tile t - 1's stage

    const bf16* sk = ring + (t % nst) * G::STAGE + warp * WROWS * D;
    const bf16* sv = sk + BK * D;
    const int base = lo + t * BK + warp * WROWS;   // this warp's row 0

    // scores of this warp's 16 rows; rows past the position are masked
    float sc[G::KSTEPS];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < G::KSTEPS; ++i) {
      const int r = i * G::KR + lane / G::KL;
      float part = dot8(qf, *reinterpret_cast<const uint4*>(
                                sk + r * D + sub * 8));
#pragma unroll
      for (int off = G::KL / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      sc[i] = base + r < hi ? part * sm_scale : NEG_INF;
      mx = fmaxf(mx, sc[i]);
    }
#pragma unroll
    for (int off = 16; off >= G::KL; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = __expf(m_run - m_new);
    m_run = m_new;
    if (sub == 0) {
#pragma unroll
      for (int i = 0; i < G::KSTEPS; ++i) {
        const int r = i * G::KR + lane / G::KL;
        sP[warp][r] = base + r < hi ? __expf(sc[i] - m_new) : 0.f;
      }
    }
    __syncwarp();

    // PV over the warp's rows: l sums fp32 p, the product takes bf16(p)
#pragma unroll
    for (int c = 0; c < G::VC; ++c) acc[c] *= alpha;
    l_part *= alpha;
#pragma unroll
    for (int i = 0; i < WROWS / G::VG; ++i) {
      const int r = i * G::VG + vg;
      const float p = sP[warp][r];
      const float pb = __bfloat162float(__float2bfloat16(p));
      const bf16* vrow = sv + r * D + vl * G::VC;
      if constexpr (G::VC == 2) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vrow));
        acc[0] = fmaf(pb, v.x, acc[0]);
        acc[1] = fmaf(pb, v.y, acc[1]);
      } else {
        const uint2 raw = *reinterpret_cast<const uint2*>(vrow);
        const __nv_bfloat162* v2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a = __bfloat1622float2(v2[0]);
        const float2 b = __bfloat1622float2(v2[1]);
        acc[0] = fmaf(pb, a.x, acc[0]);
        acc[1] = fmaf(pb, a.y, acc[1]);
        acc[2] = fmaf(pb, b.x, acc[2]);
        acc[3] = fmaf(pb, b.y, acc[3]);
      }
      l_part += p;
    }
    __syncwarp();             // sP is rewritten by the next tile
  }

  // the warp's row groups, then the warps: (m, l, acc) of the split
#pragma unroll
  for (int off = G::VL; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < G::VC; ++c)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    l_part += __shfl_xor_sync(0xffffffffu, l_part, off);
  }
  if (lane < G::VL) {
#pragma unroll
    for (int c = 0; c < G::VC; ++c) sAcc[warp][vl * G::VC + c] = acc[c];
  }
  if (lane == 0) {
    sM[warp] = m_run;
    sL[warp] = l_part;
  }
  __syncthreads();
  float m_j = sM[0], l_j = 0.f, a_j = 0.f;
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) m_j = fmaxf(m_j, sM[w]);
  const int col = tid < D ? tid : 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    // a warp with no live row has m = NEG_INF: weight 0 (warp 0 always
    // holds row lo, so m_j is finite)
    const float e = __expf(sM[w] - m_j);
    a_j = fmaf(e, sAcc[w][col], a_j);
    l_j = fmaf(e, sL[w], l_j);
  }
  const int64_t cell = static_cast<int64_t>(s) * H + h;
  if (n_live == 1) {          // short context: split 0 is the answer
    if (tid < D) o[cell * D + tid] = __float2bfloat16(a_j / l_j);
    return;
  }

  // leave the split's part, take a ticket; the last live split merges
  const int64_t slot = cell * n_split + j;
  if (tid < D) ws_acc[slot * D + tid] = a_j;
  if (tid == 0) {
    ws_ml[2 * slot] = m_j;
    ws_ml[2 * slot + 1] = l_j;
  }
  // the block's writes, then one gpu-scope release-acquire add: it
  // publishes them (cumulative through the barrier) and, in the last
  // block, makes every other split's visible to the reads after the
  // next barrier
  __syncthreads();
  if (tid == 0) {
    int ticket;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(tickets + cell)
                 : "memory");
    sLast = ticket == n_live - 1;
  }
  __syncthreads();
  if (!sLast) return;
  // the parts' (m, l) in one round trip, then each column's acc in
  // batches of MERGE_BATCH loads in flight, summed in index order
  const float* ml = ws_ml + 2 * cell * n_split;
  for (int i = tid; i < 2 * n_live; i += NTHREADS) sML[i] = __ldcg(ml + i);
  __syncthreads();
  if (tid < D) {
    const float* pa = ws_acc + cell * n_split * D + tid;
    float M = sML[0];
    for (int i = 1; i < n_live; ++i) M = fmaxf(M, sML[2 * i]);
    float num = 0.f, den = 0.f;
    for (int i0 = 0; i0 < n_live; i0 += MERGE_BATCH) {
      float a[MERGE_BATCH];
#pragma unroll
      for (int k = 0; k < MERGE_BATCH; ++k)
        a[k] = i0 + k < n_live
                   ? __ldcg(pa + static_cast<int64_t>(i0 + k) * D)
                   : 0.f;
#pragma unroll
      for (int k = 0; k < MERGE_BATCH; ++k) {
        if (i0 + k < n_live) {
          const float e = __expf(sML[2 * (i0 + k)] - M);
          num = fmaf(e, a[k], num);
          den = fmaf(e, sML[2 * (i0 + k) + 1], den);
        }
      }
    }
    o[cell * D + tid] = __float2bfloat16(num / den);
  }
  if (tid == 0) tickets[cell] = 0;   // ready for the next launch
}

// cudaFuncSetAttribute once per instantiation and device
template <int D, bool PAGED>
cudaError_t allow_smem(int device) {
  static std::atomic<uint64_t> done{0};
  const uint64_t bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<D, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

struct Args {
  const void *q, *positions;
  void *o, *ws, *tickets;
  Cache kc, vc;
  Table tab;
  int S, L, H;
  int64_t q_ss, q_sh;
  int chunk, n_split;
  float sm_scale;
  int device;
  cudaStream_t stream;
};

// the ring: as deep as the split (a short split all in flight at once),
// at most RING_BYTES (3 stages at D=128) and MAX_STAGES
template <int D>
int ring_stages(int chunk) {
  int n = chunk / BK;
  const int by_bytes = RING_BYTES / (Lanes<D>::STAGE * 2);
  if (n > by_bytes) n = by_bytes;
  return n < MAX_STAGES ? n : MAX_STAGES;
}

template <int D, bool PAGED>
cudaError_t launch(const Args& a) {
  if (a.chunk < BK || a.chunk % BK || a.n_split < 1 ||
      a.n_split > 65535 || a.S > 65535 ||
      static_cast<int64_t>(a.chunk) * (a.n_split - 1) >= a.L ||
      static_cast<int64_t>(a.chunk) * a.n_split < a.L)
    return cudaErrorInvalidValue;
  const int nst = ring_stages<D>(a.chunk);
  int64_t smem = static_cast<int64_t>(nst) * Lanes<D>::STAGE * 2 +
                 8 * static_cast<int64_t>(a.n_split);
  if (PAGED) smem += 4 * ((a.chunk - 1) / a.tab.page_size + 2);
  if (smem > SMEM_CAP) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<D, PAGED>(a.device);
  if (err != cudaSuccess) return err;
  const int64_t cells = static_cast<int64_t>(a.S) * a.H;
  float* ws_acc = static_cast<float*>(a.ws);
  float* ws_ml = ws_acc + cells * a.n_split * D;
  dim3 grid(a.H, a.S, a.n_split);
  flash_decode_kernel<D, PAGED><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), a.kc, a.vc, a.tab,
      static_cast<const int*>(a.positions), static_cast<bf16*>(a.o), ws_acc,
      ws_ml, static_cast<int*>(a.tickets), a.L, a.H, a.q_ss, a.q_sh,
      a.chunk, a.n_split, nst, a.sm_scale);
  return cudaGetLastError();
}

template <bool PAGED>
int dispatch(int D, const Args& a) {
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (D) {
    case 16: err = launch<16, PAGED>(a); break;
    case 32: err = launch<32, PAGED>(a); break;
    case 64: err = launch<64, PAGED>(a); break;
    case 128: err = launch<128, PAGED>(a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// q: bf16 [S, 1, H, D] (strides q_ss over slots, q_sh over heads);
// k_cache, v_cache: bf16 [S, L, H, D] (strides *_ss, *_sl, *_sh); unit
// stride over D everywhere; positions: int32 [S] on the device; o: bf16
// [S, 1, H, D] contiguous. chunk, n_split: the split plan (chunk a
// multiple of 64, (n_split - 1) * chunk < L <= n_split * chunk). ws: fp32
// workspace of S * H * n_split * (D + 2) floats; tickets: int32 [S * H],
// zero before the launch and left zero after it. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported head_dim or plan).
extern "C" int rlt_flash_decode(const void* q, const void* k_cache,
                                const void* v_cache, const void* positions,
                                void* o, void* ws, void* tickets, int S,
                                int L, int H, int D, int q_ss, int q_sh,
                                int k_ss, int k_sl, int k_sh, int v_ss,
                                int v_sl, int v_sh, int chunk, int n_split,
                                float sm_scale, int device, void* stream) {
  Args a{q, positions, o, ws, tickets,
         Cache{static_cast<const bf16*>(k_cache), k_ss, k_sl, k_sh},
         Cache{static_cast<const bf16*>(v_cache), v_ss, v_sl, v_sh},
         Table{nullptr, 1, 1, 1}, S, L, H, q_ss, q_sh, chunk, n_split,
         sm_scale, device, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(D, a);
}

// The paged form. k_pages, v_pages: bf16 [N, page_size, H, D] (strides
// *_sp over pages, *_sl over rows, *_sh over heads; unit stride over D);
// table: int32 [S, P] contiguous on the device, physical page ids; slot
// s attends its logical rows <= positions[s] of L = P * page_size. The
// rest as rlt_flash_decode, the plan that of the same L.
extern "C" int rlt_flash_decode_paged(
    const void* q, const void* k_pages, const void* v_pages,
    const void* positions, const void* table, void* o, void* ws,
    void* tickets, int S, int N, int P, int page_size, int H, int D,
    int q_ss, int q_sh, int k_sp, int k_sl, int k_sh, int v_sp, int v_sl,
    int v_sh, int chunk, int n_split, float sm_scale, int device,
    void* stream) {
  Args a{q, positions, o, ws, tickets,
         Cache{static_cast<const bf16*>(k_pages), k_sp, k_sl, k_sh},
         Cache{static_cast<const bf16*>(v_pages), v_sp, v_sl, v_sh},
         Table{static_cast<const int*>(table), N, P, page_size}, S,
         P * page_size, H, q_ss, q_sh, chunk, n_split, sm_scale, device,
         static_cast<cudaStream_t>(stream)};
  return dispatch<true>(D, a);
}
