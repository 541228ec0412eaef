// philox_uniform: keyed uniform draws for dropout masks and the masked
// LM's mask, read from a key in device memory so a CUDA graph replays
// fresh numbers each step.
//
// Replaces: no TPU kernel. The JAX package draws its masks with
// jax.random (threefry, lowered by XLA) from a key that is an argument of
// the jitted step (ray_lightning_tpu/core/module.py `make_rng`, flax's
// nn.Dropout). A torch.Generator cannot read its seed from device memory,
// so a captured torch.rand would replay one seed; this kernel takes the
// step's key as a device pointer instead (ops/random.py).
//
// The function: Philox4x32-10 (Salmon et al., "Parallel random numbers:
// as easy as 1, 2, 3", SC'11) with key (key[0], key[1]) (two uint32 words
// held in an int64 [2] tensor) and counter (g lo, g hi, stream lo, stream
// hi) for element group g = i / 4; element i takes word i % 4 of its
// group, and its value is (word >> 8) * 2^-24, a float32 in [0, 1) that is
// exact, so ops/random.py's plain version gives the same bits on any
// device.
//
// What bounds it on this card: bytes. It reads 16 bytes of key and writes
// 4 bytes an element; ten rounds of two 32-bit multiplies a group are
// ~100 integer operations for 16 bytes written, well under the integer
// rate that would bound it. The design: one thread a group of 4 elements,
// a 16-byte store where the group is whole and aligned, no shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t M0 = 0xD2511F53u;
constexpr uint32_t M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u;
constexpr uint32_t W1 = 0xBB67AE85u;
constexpr int NTHREADS = 256;

__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += W0;
    k1 += W1;
  }
  return c;
}

__device__ __forceinline__ float unit(uint32_t w) {
  return static_cast<float>(w >> 8) * (1.0f / 16777216.0f);
}

__global__ void philox_uniform_kernel(const long long* __restrict__ key,
                                      float* __restrict__ out, long long n,
                                      uint32_t s_lo, uint32_t s_hi) {
  const long long g = static_cast<long long>(blockIdx.x) * NTHREADS
      + threadIdx.x;
  const long long i = g * 4;
  if (i >= n) return;
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const uint4 w = philox(make_uint4(static_cast<uint32_t>(g),
                                    static_cast<uint32_t>(g >> 32), s_lo,
                                    s_hi), k0, k1);
  if (i + 4 <= n && (reinterpret_cast<uintptr_t>(out + i) & 15) == 0) {
    *reinterpret_cast<float4*>(out + i) =
        make_float4(unit(w.x), unit(w.y), unit(w.z), unit(w.w));
    return;
  }
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  for (int j = 0; j < 4 && i + j < n; ++j) out[i + j] = unit(words[j]);
}

}  // namespace

// key: int64 [2] on the device (uint32 words); out: float32 [n]; the
// stream id's two words select the draw site. Returns cudaGetLastError().
extern "C" int rlt_philox_uniform(const void* key, void* out, int n,
                                  unsigned s_lo, unsigned s_hi, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  const long long groups = (static_cast<long long>(n) + 3) / 4;
  const unsigned blocks =
      static_cast<unsigned>((groups + NTHREADS - 1) / NTHREADS);
  philox_uniform_kernel<<<blocks, NTHREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key), static_cast<float*>(out), n, s_lo,
      s_hi);
  return cudaGetLastError();
}
