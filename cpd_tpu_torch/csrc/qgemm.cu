// The quantized-Kahan-accumulator GEMM: (M, K) @ (K, N) -> (M, N) fp32
// with every intermediate of the Kahan-compensated dot product re-cast
// to eXmY (RTNE), K walked strictly in ascending order.
//
// Replaces K8, cpd_tpu/ops/qgemm.py:64 qgemm_pallas (body _qgemm_kernel
// :41), itself bit-identical to cpd_tpu/quant/quant_function.py's
// faithful lax.scan (:254-289).  Per output element, for k = 0..K-1:
//   tmp = q(a[m,k] * b[k,n]);  y = q(tmp - c);  t = q(s + y);
//   c = q(q(t - s) - y);  s = t
// with s = c = 0 to start and q the RTNE cast of exmy.cuh (bitwise the
// plain version's cast_body).  Every float op is __fmul_rn/__fadd_rn/
// __fsub_rn: no FMA contraction, no flush of subnormal products, so the
// card computes the bits the plain torch scan computes.  K is never
// padded: a zero step is not a Kahan no-op once c != 0.
//
// What bounds it.  Five casts and five float ops per (m, n, k) step, all
// on the CUDA cores: tensor cores cannot requantize after every product,
// the same trade the reference's tvm_gemm and the TPU kernel (VPU, not
// MXU) made.  A cast is ~30 integer/logic instructions, so a step is
// ~150 instructions, most of them on the 64-lane ALU pipe: the kernel is
// bound by that pipe (chip_smoke.py counts the inner loop's SASS).  The
// bytes (each operand read once) are negligible beside it.
//
// Design.  A CTA owns a 16 x 16 output tile, one output per thread with s
// and c in registers.  K goes through shared memory in chunks of 32:
// A's chunk transposed (As[k][m]), B's as it lies (Bs[k][n]), so each
// step reads one broadcast word of A and one word of B per lane.  The k
// loop is not unrolled: a step is ~150 instructions already, and one
// output per thread keeps the loop body small in the instruction cache
// while 8 CTAs of 256 threads per SM hide the casts' dependent chains.
// M and N tails are masked (their lanes run on zeros and store nothing);
// the last K chunk runs only its k < K steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "exmy.cuh"

namespace {

constexpr int kTile = 16;          // output tile side (threads per side)
constexpr int kChunk = 32;         // K steps staged in shared memory

// one step of the quantized Kahan recurrence (quant_function.py:276-279)
__device__ __forceinline__ void kahan_step(float& s, float& c, float a,
                                           float b, int eb, int mb) {
  const float tmp = exmy::cast(__fmul_rn(a, b), eb, mb);
  const float y = exmy::cast(__fsub_rn(tmp, c), eb, mb);
  const float t = exmy::cast(__fadd_rn(s, y), eb, mb);
  c = exmy::cast(__fsub_rn(exmy::cast(__fsub_rn(t, s), eb, mb), y), eb,
                 mb);
  s = t;
}

__global__ void __launch_bounds__(kTile* kTile)
    qgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int m, int n, int k, int eb,
                 int mb) {
  __shared__ float as[kChunk][kTile];
  __shared__ float bs[kChunk][kTile];
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  float s = 0.0f, c = 0.0f;
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kc = min(kChunk, k - k0);
    // stage A[row0 : row0+16, k0 : k0+32] transposed and
    // B[k0 : k0+32, col0 : col0+16]; 512 words each, two per thread
    for (int i = threadIdx.x; i < kChunk * kTile; i += kTile * kTile) {
      const int r = i / kChunk, kk = i % kChunk;       // A: along k
      const int gr = row0 + r;
      as[kk][r] = (gr < m && kk < kc)
                      ? a[static_cast<long long>(gr) * k + k0 + kk]
                      : 0.0f;
      const int kb = i / kTile, cc = i % kTile;        // B: along n
      const int gc = col0 + cc;
      bs[kb][cc] = (gc < n && kb < kc)
                       ? b[static_cast<long long>(k0 + kb) * n + gc]
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll 1
    for (int kk = 0; kk < kc; ++kk) kahan_step(s, c, as[kk][ty], bs[kk][tx],
                                               eb, mb);
    __syncthreads();
  }
  const int gr = row0 + ty, gc = col0 + tx;
  if (gr < m && gc < n) out[static_cast<long long>(gr) * n + gc] = s;
}

}  // namespace

// out (m, n) = the quantized-Kahan product of a (m, k) and b (k, n), all
// fp32, contiguous row-major.  Returns the cudaError of the launch.
extern "C" int qgemm_launch(const void* a, const void* b, void* out, int m,
                            int n, int k, int exp_bits, int man_bits,
                            void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  qgemm_kernel<<<grid, kTile * kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), m, n, k, exp_bits, man_bits);
  return int(cudaGetLastError());
}

extern "C" const char* qgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
