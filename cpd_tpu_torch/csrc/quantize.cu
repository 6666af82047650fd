// The eXmY quantize kernels of the ring reduce: the elementwise cast, the
// fused add-and-cast, the fused hop that unpacks, adds, casts, re-packs
// and digests the packed wire, each with round-to-nearest-even or
// stochastic rounding, and the SR bit generator they are fed from.
//
// Replaces six TPU kernels of cpd_tpu/ops/quantize.py:
//   K1 quantize_pallas (:69, body _quantize_kernel :42)   cast(x)
//   K2 quantize_pallas_sr (:170, body :46)                cast_sr(x, r)
//   K3 quantize_add_pallas (:107, body :95)               cast(x + y)
//   K4 quantize_add_pallas_bits (:137, body :100)         cast_sr(x + y, r)
//   K6 quantize_pack_pallas (:634)    hop 0: cast[_sr](g), pack (+ digest)
//   K5 hop_pack_pallas (:512)         hop t: cast[_sr](unpack(wire) + g),
//                                     pack (+ digests of both wires)
// K5 and K6 share their body (_make_wire_kernel :271 / _wire_call :409),
// and so do their ports here: one kernel templated on kFirst and kSR (as
// K1-K4 share one templated on kAdd and kSR).  The per-element arithmetic
// is exmy.cuh, bitwise the plain version's.  Like the TPU kernels, the SR
// arms take their uint32 round bits as an operand.  Those bits come from
// sr_bits_kernel, the port of what the JAX package computes in XLA
// (numerics.sr_bits_at: two threefry2x32 per element); it is bound by
// the integer instructions it issues per element (about two on the
// 64-lane ALU pipe per threefry round), not by its 4 written bytes.
//
// What bounds them.  Each is a streaming pass of a few integer ops per
// element: 8 bytes per element for the cast (read 4, write 4), 12 for the
// add, 8 + wb for hop 0 and 2 (4 + wb) for a later hop, at 3.35 TB/s;
// the SR arms read 4 more bytes of round bits.
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

// out = cast[_sr](x [+ y] [, r]): K1 <false, false>, K3 <true, false>,
// K2 <false, true>, K4 <true, true>.  Four instantiations, so a profile
// tells the kernels apart by name.
template <bool kAdd, bool kSR>
__device__ __forceinline__ float cast_one(float x, float y, uint32_t r,
                                          int eb, int mb) {
  const float v = kAdd ? __fadd_rn(x, y) : x;
  return kSR ? exmy::cast_sr(v, eb, mb, r) : exmy::cast(v, eb, mb);
}

template <bool kAdd, bool kSR>
__global__ void cast_kernel(const float* __restrict__ x,
                            const float* __restrict__ y,
                            const uint32_t* __restrict__ rbits,
                            float* __restrict__ out, int64_t n, int eb,
                            int mb, int vec) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    const uint4* r4 = reinterpret_cast<const uint4*>(rbits);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 a = x4[i];
      const float4 b = kAdd ? y4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      const uint4 r = kSR ? r4[i] : make_uint4(0u, 0u, 0u, 0u);
      float4 o;
      o.x = cast_one<kAdd, kSR>(a.x, b.x, r.x, eb, mb);
      o.y = cast_one<kAdd, kSR>(a.y, b.y, r.y, eb, mb);
      o.z = cast_one<kAdd, kSR>(a.z, b.z, r.z, eb, mb);
      o.w = cast_one<kAdd, kSR>(a.w, b.w, r.w, eb, mb);
      o4[i] = o;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = cast_one<kAdd, kSR>(x[i], kAdd ? y[i] : 0.f,
                                 kSR ? rbits[i] : 0u, eb, mb);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K6 (kFirst, no wire_in) and K5: res = cast[_sr]([unpack(wire_in) +] g
// [, rbits]), wire_out = pack(res); partials (4 per block: in s1, in s2,
// out s1, out s2, each mod 65521) when partials != nullptr
template <bool kFirst, bool kSR>
__global__ void wire_kernel(const uint8_t* __restrict__ wire_in,
                            const float* __restrict__ g,
                            const uint32_t* __restrict__ rbits,
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
    const float q = kSR ? exmy::cast_sr(v, eb, mb, rbits[i])
                        : exmy::cast(v, eb, mb);
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

// out[i] = sr_bits_at((k0, k1), start + i), the offset wrapping mod 2^32
// as the JAX package's uint32 offsets do
__global__ void sr_bits_kernel(uint32_t* __restrict__ out, int64_t n,
                               uint32_t start, uint32_t k0, uint32_t k1) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = exmy::sr_bits_at(k0, k1, start + uint32_t(i));
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

template <bool kAdd, bool kSR>
void launch_cast(int blocks, cudaStream_t s, const float* x, const float* y,
                 const uint32_t* r, float* out, long long n, int eb, int mb,
                 int vec) {
  cast_kernel<kAdd, kSR><<<blocks, kThreads, 0, s>>>(x, y, r, out, n, eb,
                                                      mb, vec);
}

// K1 (y == NULL, rbits == NULL) / K3 (rbits == NULL) / K2 (y == NULL) /
// K4.  Returns the CUDA error code of the launch.
extern "C" int quantize_cast_launch(const void* x, const void* y,
                                    const void* rbits, void* out,
                                    long long n, int exp_bits, int man_bits,
                                    void* stream) {
  const uintptr_t mask = uintptr_t(x) | uintptr_t(y) | uintptr_t(rbits) |
                         uintptr_t(out);
  const int vec = (mask & 15u) == 0;
  const int blocks = grid_for(vec ? n / 4 + (n % 4) : n, 4096);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const uint32_t* r = static_cast<const uint32_t*>(rbits);
  float* of = static_cast<float*>(out);
  if (y == nullptr && r == nullptr)
    launch_cast<false, false>(blocks, s, xf, yf, r, of, n, exp_bits,
                              man_bits, vec);
  else if (r == nullptr)
    launch_cast<true, false>(blocks, s, xf, yf, r, of, n, exp_bits,
                             man_bits, vec);
  else if (y == nullptr)
    launch_cast<false, true>(blocks, s, xf, yf, r, of, n, exp_bits,
                             man_bits, vec);
  else
    launch_cast<true, true>(blocks, s, xf, yf, r, of, n, exp_bits, man_bits,
                            vec);
  return int(cudaGetLastError());
}

// The SR bits of n elements at the offsets start + i.
extern "C" int quantize_sr_bits_launch(void* out, long long n,
                                       unsigned int start, unsigned int k0,
                                       unsigned int k1, void* stream) {
  sr_bits_kernel<<<grid_for(n, 4096), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, start, k0, k1);
  return int(cudaGetLastError());
}

// Blocks the wire kernel launches for n elements: the size (in groups of
// 4 uint64 words) of the `partials` scratch a digesting launch needs.
extern "C" int quantize_wire_blocks(long long n) {
  return grid_for(n, 4096);
}

template <bool kFirst, bool kSR>
void launch_wire(int blocks, cudaStream_t s, const uint8_t* in,
                 const float* g, const uint32_t* r, float* res, uint8_t* out,
                 unsigned long long* part, long long n, int wb, int eb,
                 int mb) {
  wire_kernel<kFirst, kSR><<<blocks, kThreads, 0, s>>>(in, g, r, res, out,
                                                        part, n, wb, eb, mb);
}

// K6 (wire_in == NULL) / K5, RTNE (rbits == NULL) or SR.  With partials
// != NULL also writes digest[0] (received wire; 0 for K6) and digest[1]
// (emitted wire).
extern "C" int quantize_wire_launch(const void* wire_in, const void* g,
                                    const void* rbits, void* res,
                                    void* wire_out, void* partials,
                                    void* digest, long long n, int wb,
                                    int exp_bits, int man_bits,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n, 4096);
  const uint8_t* in = static_cast<const uint8_t*>(wire_in);
  const float* gf = static_cast<const float*>(g);
  const uint32_t* r = static_cast<const uint32_t*>(rbits);
  float* rf = static_cast<float*>(res);
  uint8_t* out = static_cast<uint8_t*>(wire_out);
  unsigned long long* part = static_cast<unsigned long long*>(partials);
  if (wire_in == nullptr && r == nullptr)
    launch_wire<true, false>(blocks, s, in, gf, r, rf, out, part, n, wb,
                             exp_bits, man_bits);
  else if (wire_in == nullptr)
    launch_wire<true, true>(blocks, s, in, gf, r, rf, out, part, n, wb,
                            exp_bits, man_bits);
  else if (r == nullptr)
    launch_wire<false, false>(blocks, s, in, gf, r, rf, out, part, n, wb,
                              exp_bits, man_bits);
  else
    launch_wire<false, true>(blocks, s, in, gf, r, rf, out, part, n, wb,
                             exp_bits, man_bits);
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
