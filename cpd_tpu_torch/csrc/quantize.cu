// The eXmY quantize kernels of the ring reduce: the elementwise cast, the
// fused add-and-cast, and the fused hop that unpacks, adds, casts, re-packs
// and digests the packed wire.
//
// Replaces four TPU kernels of cpd_tpu/ops/quantize.py:
//   K1 quantize_pallas (:69, body _quantize_kernel :42)   cast(x)
//   K3 quantize_add_pallas (:107, body :95)               cast(x + y)
//   K6 quantize_pack_pallas (:634)    hop 0: cast(g), pack (+ out digest)
//   K5 hop_pack_pallas (:512)         hop t: cast(unpack(wire) + g), pack
//                                     (+ digests of both wires)
// K5 and K6 share their body (_make_wire_kernel :271 / _wire_call :409),
// and so do their ports here: one kernel templated on kFirst (as K1/K3
// share one templated on kAdd).  The per-element arithmetic is exmy.cuh,
// bitwise the plain version's.
//
// What bounds them.  Each is a streaming pass of a few integer ops per
// element: 8 bytes per element for the cast (read 4, write 4), 12 for the
// add, 8 + wb for hop 0 and 2 (4 + wb) for a later hop, at 3.35 TB/s.
// At the ring chunk of ResNet-18/CIFAR (988,944 elements at W = 4) a
// (5, 2) hop moves ~9.9 MB: a ~3 us bound, so launch latency and the
// byte loads are what the design has to keep small.
//
// Design.  The TPU kernels stream (512, 128) tiles through VMEM in grid
// order; here every thread owns elements at a grid stride, so any n is
// covered, a ragged tail included.  K1/K3 load and store float4 when every
// pointer is 16-byte aligned (torch allocations are), with a scalar tail.
// The wire kernel reads and writes each element's wb code bytes (byte k of
// the little-endian word in column k of the (n, wb) wire, pack_exmy's
// layout).  With a digest, each thread accumulates the Fletcher sums
//   s1 = sum byte,   s2 = sum byte * ((pos mod 65521) + 1),  pos = i*wb + k
// of the received and the emitted wire in 64-bit registers; each block
// reduces its threads' sums and stores them mod 65521, and a one-block
// fold kernel sums the block partials and writes (s2 << 16) | s1 per
// wire.  The position weight makes any split of the sum exact, so the
// digest is deterministic and equals integrity.wire_digest.  Overflow:
// one byte term is < 256 * 65521 < 2^24 and a thread sums at most
// ceil(n / (blocks * threads)) * wb terms, so a 64-bit sum cannot wrap
// below 2^40 elements; block partials are < 65521 and at most 4096 of
// them are folded.

#include <cuda_runtime.h>
#include <stdint.h>

#include "exmy.cuh"

namespace {

constexpr int kThreads = 256;

// K1 (kAdd = false) and K3 (kAdd = true): out = cast(x [+ y]).  Two
// instantiations, so a profile tells the two kernels apart by name.
template <bool kAdd>
__global__ void cast_kernel(const float* __restrict__ x,
                            const float* __restrict__ y,
                            float* __restrict__ out, int64_t n, int eb,
                            int mb, int vec) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      float4 a = x4[i];
      if (kAdd) {
        const float4 b = y4[i];
        a.x = __fadd_rn(a.x, b.x);
        a.y = __fadd_rn(a.y, b.y);
        a.z = __fadd_rn(a.z, b.z);
        a.w = __fadd_rn(a.w, b.w);
      }
      float4 r;
      r.x = exmy::cast(a.x, eb, mb);
      r.y = exmy::cast(a.y, eb, mb);
      r.z = exmy::cast(a.z, eb, mb);
      r.w = exmy::cast(a.w, eb, mb);
      o4[i] = r;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = exmy::cast(kAdd ? __fadd_rn(x[i], y[i]) : x[i], eb, mb);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K6 (kFirst, no wire_in) and K5: res = cast([unpack(wire_in) +] g),
// wire_out = pack(res); partials (4 per block: in s1, in s2, out s1,
// out s2, each mod 65521) when partials != nullptr
template <bool kFirst>
__global__ void wire_kernel(const uint8_t* __restrict__ wire_in,
                            const float* __restrict__ g,
                            float* __restrict__ res,
                            uint8_t* __restrict__ wire_out,
                            unsigned long long* __restrict__ partials,
                            int64_t n, int wb, int eb, int mb) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  unsigned long long s[4] = {0ull, 0ull, 0ull, 0ull};
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = g[i];
    uint32_t code_in = 0u;
    if (!kFirst) {
      const uint8_t* w = wire_in + i * wb;
      for (int k = 0; k < wb; ++k) code_in |= uint32_t(w[k]) << (8 * k);
      v = __fadd_rn(exmy::unpack_code(code_in, eb, mb), v);
    }
    const float q = exmy::cast(v, eb, mb);
    res[i] = q;
    const uint32_t code = exmy::pack_code(q, eb, mb);
    uint8_t* o = wire_out + i * wb;
    for (int k = 0; k < wb; ++k) o[k] = uint8_t(code >> (8 * k));
    if (partials) {
      for (int k = 0; k < wb; ++k) {
        const unsigned long long pos =
            (unsigned long long)(i * wb + k) % exmy::kDigestMod + 1ull;
        const unsigned long long bo = (code >> (8 * k)) & 0xFFu;
        const unsigned long long bi = (code_in >> (8 * k)) & 0xFFu;
        s[0] += bi;
        s[1] += bi * pos;
        s[2] += bo;
        s[3] += bo * pos;
      }
    }
  }
  if (!partials) return;
  __shared__ unsigned long long red[4][kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = warp_sum(s[j]);
    if (lane == 0) red[j][warp] = s[j];
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / 32;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned long long v = lane < nw ? red[j][lane] : 0ull;
      v = warp_sum(v);
      if (lane == 0) partials[size_t(blockIdx.x) * 4 + j] = v % exmy::kDigestMod;
    }
  }
}

// one block: digest[0] = received wire, digest[1] = emitted wire
__global__ void fold_kernel(const unsigned long long* __restrict__ partials,
                            int blocks, uint32_t* __restrict__ digest) {
  __shared__ unsigned long long red[4][kThreads / 32];
  unsigned long long s[4] = {0ull, 0ull, 0ull, 0ull};
  for (int b = threadIdx.x; b < blocks; b += blockDim.x)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] += partials[size_t(b) * 4 + j];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = warp_sum(s[j]);
    if (lane == 0) red[j][warp] = s[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t m[4];
    for (int j = 0; j < 4; ++j) {
      unsigned long long v = 0ull;
      for (int w = 0; w < int(blockDim.x / 32); ++w) v += red[j][w];
      m[j] = uint32_t(v % exmy::kDigestMod);
    }
    digest[0] = (m[1] << 16) | m[0];
    digest[1] = (m[3] << 16) | m[2];
  }
}

int grid_for(int64_t work, int max_blocks) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return int(b < 1 ? 1 : (b > max_blocks ? max_blocks : b));
}

}  // namespace

// K1 (y == NULL) / K3.  Returns the CUDA error code of the launch.
extern "C" int quantize_cast_launch(const void* x, const void* y, void* out,
                                    long long n, int exp_bits, int man_bits,
                                    void* stream) {
  const uintptr_t mask = uintptr_t(x) | uintptr_t(y) | uintptr_t(out);
  const int vec = (mask & 15u) == 0;
  const int blocks = grid_for(vec ? n / 4 + (n % 4) : n, 4096);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* of = static_cast<float*>(out);
  if (y == nullptr)
    cast_kernel<false><<<blocks, kThreads, 0, s>>>(xf, yf, of, n, exp_bits,
                                                   man_bits, vec);
  else
    cast_kernel<true><<<blocks, kThreads, 0, s>>>(xf, yf, of, n, exp_bits,
                                                  man_bits, vec);
  return int(cudaGetLastError());
}

// Blocks the wire kernel launches for n elements: the size (in groups of
// 4 uint64 words) of the `partials` scratch a digesting launch needs.
extern "C" int quantize_wire_blocks(long long n) {
  return grid_for(n, 4096);
}

// K6 (wire_in == NULL) / K5.  With partials != NULL also writes
// digest[0] (received wire; 0 for K6) and digest[1] (emitted wire).
extern "C" int quantize_wire_launch(const void* wire_in, const void* g,
                                    void* res, void* wire_out,
                                    void* partials, void* digest,
                                    long long n, int wb, int exp_bits,
                                    int man_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n, 4096);
  const uint8_t* in = static_cast<const uint8_t*>(wire_in);
  const float* gf = static_cast<const float*>(g);
  float* rf = static_cast<float*>(res);
  uint8_t* out = static_cast<uint8_t*>(wire_out);
  unsigned long long* part = static_cast<unsigned long long*>(partials);
  if (wire_in == nullptr)
    wire_kernel<true><<<blocks, kThreads, 0, s>>>(in, gf, rf, out, part, n,
                                                  wb, exp_bits, man_bits);
  else
    wire_kernel<false><<<blocks, kThreads, 0, s>>>(in, gf, rf, out, part, n,
                                                   wb, exp_bits, man_bits);
  int err = int(cudaGetLastError());
  if (err != 0 || partials == nullptr) return err;
  fold_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const unsigned long long*>(partials), blocks,
      static_cast<uint32_t*>(digest));
  return int(cudaGetLastError());
}

extern "C" const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
