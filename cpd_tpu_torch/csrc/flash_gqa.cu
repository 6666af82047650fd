// Flash attention on the CUDA cores: the forward with its per-row
// log-sum-exp, and the backward as a dq kernel and a dk/dv kernel, for
// fp32 or bf16 elements and head_dim 32, 64, 128 or 256 (the templates)
// or any multiple of 128 past 256 (the head_dim-split arm, below the
// templates), accumulating in fp32.
//
// At head_dim 32, 64 and 128 no path runs these kernels: K9, K10 and K11
// run on the tensor cores there, bf16 on flash_mha_tc.cu's mma.sync
// kernels and fp32 on flash_f32_tc.cu's 3xTF32 kernels, and both arms
// stay here as the yardstick those are timed against
// (ops.flash_gqa.core_launchers).  At head_dim 256 these kernels are
// K9-K11's arm in both dtypes: the wrappers zero-pad any head_dim in
// (128, 256] to 256 and launch them (ops.flash_gqa.launchers); the
// tensor-core builds hold no D = 256 tile within their registers.  Past
// 256 the wrappers pad D to the next multiple of 128, the JAX kernel's
// rule, and launch the head_dim-split arm (flash_split_*_launch), whose
// tiles are those of D = 256 with a grid axis over 128-column chunks of
// D; it recomputes the logits in every chunk's CTA, D/128 times the
// logit work, a simple kernel that is right before a fast one.
//
// Computes the function of three TPU kernels:
//   K9  cpd_tpu/ops/flash_gqa.py _flash_gqa_fwd_call (:151; body
//       _flash_gqa_kernel :64)
//         out = softmax(mask(q k^T * scale)) v, lse = m + log(l)
//   K10 cpd_tpu/ops/flash_gqa.py _flash_gqa_bwd_call (:298; bodies
//       _flash_gqa_bwd_dq_kernel :231 and _flash_gqa_bwd_dkv_kernel :259,
//       shared recompute _bwd_p_ds :203)
//         p = exp(s - lse), dp = do v^T, ds = p (dp - delta) scale,
//         dq = ds k, dk = sum_rep ds^T q, dv = sum_rep p^T do
//   K11 cpd_tpu/ops/attention.py:116 _flash_attention, the stock Pallas
//       TPU kernel jax.experimental.pallas.ops.tpu.flash_attention (its
//       forward :388-477 and its own backward, dkv :796-938, dq
//       :1146-1261): the same function at rep = 1 (MHA), which runs in
//       bf16 on flash_mha_tc.cu and in fp32 on flash_f32_tc.cu
// with q (B, Tq, H, D), k/v (B, Tk, H_kv, D) unexpanded (kv head g serves
// query heads g*rep .. g*rep + rep - 1).  Logits, softmax and every
// product accumulate in fp32; with bf16 elements the TPU kernels' roundings
// are kept: p is rounded to the element type before p v (its fp32 value
// feeds l), p and ds before the backward's products, and each output once
// at its store.  In fp32 every rounding is the identity.  The GQA
// contract: a masked p is zeroed by the mask, not by exp(-1e30); causal
// key blocks wholly above the diagonal are skipped; out = acc /
// max(l, 1e-30) and lse = m + log(max(l, 1e-30)), so a fully masked row
// gives 0; pad keys past Tk are masked by position.  K11's callers have
// no fully masked row (zero offsets, Tk a multiple of 128), where the
// stock kernel's additive mask (-0.7 FLT_MAX) gives the same p = 0.
// delta = sum_d do*out is one torch op outside the kernels, as in JAX.
//
// What bounds them.  fp32 multiply-adds outside the tensor cores (67
// TFLOP/s on an H100 SXM): the forward does 2 products of (Tq, D) x
// (D, Tk) per head (half under the causal mask), the backward 5.  At
// B=4, T=1024, H=8, D=64 causal that is ~4.3 / ~10.7 GFLOP, 0.064 /
// 0.160 ms at that rate; the bytes (~21 MB in fp32) take 0.006 ms.  bf16
// elements are widened to fp32 in shared memory and take the same
// fp32 arithmetic, so they move half the bytes at the same bound; the
// bf16 tensor cores (989 TFLOP/s) bound them 15x lower, which K9-K11's
// bf16 calls reach through flash_mha_tc.cu (mma.sync bf16 tiles).  fp32
// products on the tensor cores, 3xTF32 at 165 TFLOP/s, are
// flash_f32_tc.cu's.
//
// Design.  A CTA of 4 x R threads (16 x R/4) owns an R-row tile, R = 64
// at head_dim <= 128 and 32 at 256 (`tile_rows`; R keys per key tile
// too), which keeps the dq and dk/dv tiles within 227 KB at D = 256: the
// forward and dq a (b, head, 64 queries) tile walking the key blocks,
// dk/dv a (b, kv head, 64 keys) tile walking the query blocks of all rep
// heads of its kv head (the GQA group sum inside the kernel: no atomics,
// nothing rep-sized in memory).  Every product is C[i][c] += sum_t
// X[t][i] Y[t][c] over fp32 tiles in shared memory (`mma`): a thread
// holds rows ty*4 .. ty*4+3 (one float4 of X, broadcast over its row's
// 16 lanes) and columns tx + 16 c (conflict-free words of Y), so tiles
// are staged transposed where the reduction runs over D.  The 16 lanes
// of a row reduce the online softmax's max and sum with shuffles.  The
// dk/dv kernel writes p and ds over the transposed query tiles once the
// logits are taken, which keeps it within a block's 227 KB at D = 128.
// Shared memory at D = 64 / 128: 70 / 118 KB (forward), 104 / 186 KB
// (dq), 103 / 203 KB (dk/dv); at D = 256 (R = 32): 109 / 181 / 209 KB.
// The grid's y extent is B * H (B * H_kv for dk/dv), at most 65535: the
// launchers run a larger batch in chunks of whole batch rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPad = 4;             // keeps rows 16-byte aligned
constexpr float kNegInf = -1e30f;   // the JAX package's _NEG_INF
constexpr int kGridY = 65535;       // the grid's y extent

// query rows of a tile and keys of a key tile at head_dim d, the threads
// of a CTA (16 lanes x 4 rows each) and the row stride of a [t][R] tile
__host__ __device__ constexpr int tile_rows(int d) { return d > 128 ? 32 : 64; }
__host__ __device__ constexpr int threads_of(int d) { return 4 * tile_rows(d); }
__host__ __device__ constexpr int ld_of(int d) { return tile_rows(d) + kPad; }

// the element types: fp32 (dtype code 0) and bf16 (1), read into and
// rounded from fp32
template <class T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ int lane_x() { return threadIdx.x % 16; }
__device__ __forceinline__ int lane_y() { return threadIdx.x / 16; }

// rows [r0, r0 + R) of one head of a (B, T, heads, D) tensor (row
// stride `stride` elements from `src`), zero past `t_len`, widened to
// fp32: transposed into dst[d][r] (row stride ld_of(D)) or as they lie
// into dst[r][d] (D+kPad)
template <class T, int D, bool kTrans>
__device__ void load_tile(float* dst, const T* src, long long stride,
                          int r0, int t_len) {
  constexpr int kB = tile_rows(D), kLd = ld_of(D);
  for (int i = threadIdx.x; i < kB * D; i += threads_of(D)) {
    const int r = i / D, d = i % D;
    const float x =
        r0 + r < t_len ? Elem<T>::load(src + (r0 + r) * stride + d) : 0.0f;
    if (kTrans)
      dst[d * kLd + r] = x;
    else
      dst[r * (D + kPad) + d] = x;
  }
}

// acc[i][c] += sum_{t < T} X[t][ty*4 + i] * Y[t][tx + 16 c]
template <int NC, int T>
__device__ __forceinline__ void mma(float (&acc)[4][NC], const float* x,
                                    int ldx, const float* y, int ldy) {
  const int tx = lane_x(), ty = lane_y();
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const float4 xv = *reinterpret_cast<const float4*>(x + t * ldx + ty * 4);
    float yv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) yv[c] = y[t * ldy + tx + 16 * c];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[0][c] = fmaf(xv.x, yv[c], acc[0][c]);
      acc[1][c] = fmaf(xv.y, yv[c], acc[1][c]);
      acc[2][c] = fmaf(xv.z, yv[c], acc[2][c]);
      acc[3][c] = fmaf(xv.w, yv[c], acc[3][c]);
    }
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&a)[4][NC]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) a[i][c] = 0.0f;
}

// reductions over the 16 lanes that hold one row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool valid_at(int qpos, int kpos, int tq, int tk,
                                         int causal) {
  return qpos < tq && kpos < tk && (!causal || qpos >= kpos);
}

// forward: grid (ceil(Tq/R), B*H)
template <class T, int D>
__global__ void __launch_bounds__(threads_of(D))
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, int tq, int tk, int h, int hkv,
               int causal, float scale) {
  constexpr int NC = D / 16, LdD = D + kPad;
  constexpr int kB = tile_rows(D), kLd = ld_of(D), KC = kB / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // [D][R] queries
  float* kt = qt + D * kLd;         // [D][R] keys
  float* vs = kt + D * kLd;         // [R][D] values
  float* pt = vs + kB * LdD;        // [R keys][R queries] probabilities
  const int tx = lane_x(), ty = lane_y();
  const int b = blockIdx.y / h, hh = blockIdx.y % h, g = hh / (h / hkv);
  const int q0 = blockIdx.x * kB;
  const long long qs = static_cast<long long>(h) * D;
  const long long ks = static_cast<long long>(hkv) * D;
  const T* kb = k + (static_cast<long long>(b) * tk * hkv + g) * D;
  const T* vb = v + (static_cast<long long>(b) * tk * hkv + g) * D;
  load_tile<T, D, true>(qt, q + (static_cast<long long>(b) * tq * h + hh) * D,
                        qs, q0, tq);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.0f;
  zero(acc);
  const int n_k = (tk + kB - 1) / kB;
  const int n_j = causal ? min(n_k, static_cast<int>(blockIdx.x) + 1) : n_k;
  for (int j = 0; j < n_j; ++j) {
    const int k0 = j * kB;
    __syncthreads();
    load_tile<T, D, true>(kt, kb, ks, k0, tk);
    load_tile<T, D, false>(vs, vb, ks, k0, tk);
    __syncthreads();
    float s[4][KC];
    zero(s);
    mma<KC, D>(s, qt, kLd, kt, kLd);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const bool ok = valid_at(qpos, k0 + tx + 16 * c, tq, tk, causal);
        s[i][c] = ok ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const bool ok = valid_at(qpos, k0 + tx + 16 * c, tq, tk, causal);
        const float p = ok ? expf(s[i][c] - m_new) : 0.0f;
        // l sums p in fp32; p v takes p rounded to the element type
        pt[(tx + 16 * c) * kLd + ty * 4 + i] = Elem<T>::round(p);
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    mma<NC, kB>(acc, pt, kLd, vs, LdD);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<long long>(b) * tq + qpos) * h + hh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) Elem<T>::store(o + tx + 16 * c, acc[i][c] / den);
    if (tx == 0)
      lse[(static_cast<long long>(b) * h + hh) * tq + qpos] =
          m[i] + logf(den);
  }
}

// p and ds of one (query rows ty*4+i, keys tx+16c) tile from the logits
// s = q k^T and dp = do v^T (the shared recompute, _bwd_p_ds), both in
// fp32 (ds from the unrounded p)
template <int KC>
__device__ __forceinline__ void p_ds(float (&s)[4][KC], float (&dp)[4][KC],
                                     const float (&lse)[4],
                                     const float (&delta)[4], int q0, int k0,
                                     int tq, int tk, int causal,
                                     float scale) {
  const int tx = lane_x(), ty = lane_y();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const bool ok =
          valid_at(q0 + ty * 4 + i, k0 + tx + 16 * c, tq, tk, causal);
      const float p = ok ? expf(s[i][c] * scale - lse[i]) : 0.0f;
      s[i][c] = p;
      dp[i][c] = p * (dp[i][c] - delta[i]) * scale;
    }
}

// backward, dq: grid (ceil(Tq/R), B*H); keys innermost
template <class T, int D>
__global__ void __launch_bounds__(threads_of(D))
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int tq, int tk, int h, int hkv,
              int causal, float scale) {
  constexpr int NC = D / 16, LdD = D + kPad;
  constexpr int kB = tile_rows(D), kLd = ld_of(D), KC = kB / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // [D][R]
  float* dot = qt + D * kLd;        // [D][R]
  float* kt = dot + D * kLd;        // [D][R]
  float* vt = kt + D * kLd;         // [D][R]
  float* ksm = vt + D * kLd;        // [R][D]
  float* dst = ksm + kB * LdD;      // [R keys][R queries] ds
  const int tx = lane_x(), ty = lane_y();
  const int b = blockIdx.y / h, hh = blockIdx.y % h, g = hh / (h / hkv);
  const int q0 = blockIdx.x * kB;
  const long long qs = static_cast<long long>(h) * D;
  const long long ks = static_cast<long long>(hkv) * D;
  const long long qoff = (static_cast<long long>(b) * tq * h + hh) * D;
  const T* kb = k + (static_cast<long long>(b) * tk * hkv + g) * D;
  const T* vb = v + (static_cast<long long>(b) * tk * hkv + g) * D;
  load_tile<T, D, true>(qt, q + qoff, qs, q0, tq);
  load_tile<T, D, true>(dot, dout + qoff, qs, q0, tq);
  float rl[4], rd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    const long long at = (static_cast<long long>(b) * h + hh) * tq + qpos;
    rl[i] = qpos < tq ? lse[at] : 0.0f;
    rd[i] = qpos < tq ? delta[at] : 0.0f;
  }
  float acc[4][NC];
  zero(acc);
  const int n_k = (tk + kB - 1) / kB;
  const int n_j = causal ? min(n_k, static_cast<int>(blockIdx.x) + 1) : n_k;
  for (int j = 0; j < n_j; ++j) {
    const int k0 = j * kB;
    __syncthreads();
    load_tile<T, D, true>(kt, kb, ks, k0, tk);
    load_tile<T, D, true>(vt, vb, ks, k0, tk);
    load_tile<T, D, false>(ksm, kb, ks, k0, tk);
    __syncthreads();
    float s[4][KC], dp[4][KC];
    zero(s);
    zero(dp);
    mma<KC, D>(s, qt, kLd, kt, kLd);
    mma<KC, D>(dp, dot, kLd, vt, kLd);
    p_ds(s, dp, rl, rd, q0, k0, tq, tk, causal, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < KC; ++c) dst[(tx + 16 * c) * kLd + ty * 4 + i] =
          Elem<T>::round(dp[i][c]);
    __syncthreads();
    mma<NC, kB>(acc, dst, kLd, ksm, LdD);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= tq) continue;
    T* o = dq + ((static_cast<long long>(b) * tq + qpos) * h + hh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) Elem<T>::store(o + tx + 16 * c, acc[i][c]);
  }
}

// a [D][R] query tile, later the [R][R] p or ds tile written over it
__host__ __device__ constexpr int qtile(int d) {
  return (d > tile_rows(d) ? d : tile_rows(d)) * ld_of(d);
}

// backward, dk/dv: grid (ceil(Tk/R), B*H_kv); queries of the rep heads
// innermost, their sums in registers
template <class T, int D>
__global__ void __launch_bounds__(threads_of(D))
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int tq, int tk, int h, int hkv,
               int causal, float scale) {
  constexpr int NC = D / 16, LdD = D + kPad;
  constexpr int kB = tile_rows(D), kLd = ld_of(D), KC = kB / 16;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                 // [D][R] keys
  float* vt = kt + D * kLd;         // [D][R]
  float* qt = vt + D * kLd;         // [D][R] queries, then p [R q][R k]
  float* dot = qt + qtile(D);       // [D][R], then ds [R q][R k]
  float* qsm = dot + qtile(D);      // [R][D]
  float* dos = qsm + kB * LdD;      // [R][D]
  float* rows = dos + kB * LdD;     // lse[R], delta[R]
  float* ps = qt;
  float* dss = dot;
  const int tx = lane_x(), ty = lane_y();
  const int b = blockIdx.y / hkv, g = blockIdx.y % hkv, rep = h / hkv;
  const int k0 = blockIdx.x * kB;
  const long long qs = static_cast<long long>(h) * D;
  const long long ks = static_cast<long long>(hkv) * D;
  const long long kvoff = (static_cast<long long>(b) * tk * hkv + g) * D;
  load_tile<T, D, true>(kt, k + kvoff, ks, k0, tk);
  load_tile<T, D, true>(vt, v + kvoff, ks, k0, tk);
  float dk_acc[4][NC], dv_acc[4][NC];
  zero(dk_acc);
  zero(dv_acc);
  const int n_q = (tq + kB - 1) / kB;
  // causal: a query block wholly above this key block contributes nothing
  const int i0 = causal ? static_cast<int>(blockIdx.x) : 0;
  for (int r = 0; r < rep; ++r) {
    const int hh = g * rep + r;
    const long long qoff = (static_cast<long long>(b) * tq * h + hh) * D;
    const long long roff = (static_cast<long long>(b) * h + hh) * tq;
    for (int i = i0; i < n_q; ++i) {
      const int q0 = i * kB;
      __syncthreads();
      load_tile<T, D, true>(qt, q + qoff, qs, q0, tq);
      load_tile<T, D, true>(dot, dout + qoff, qs, q0, tq);
      load_tile<T, D, false>(qsm, q + qoff, qs, q0, tq);
      load_tile<T, D, false>(dos, dout + qoff, qs, q0, tq);
      if (threadIdx.x < kB) {
        const int qpos = q0 + threadIdx.x;
        rows[threadIdx.x] = qpos < tq ? lse[roff + qpos] : 0.0f;
        rows[kB + threadIdx.x] = qpos < tq ? delta[roff + qpos] : 0.0f;
      }
      __syncthreads();
      float s[4][KC], dp[4][KC], rl[4], rd[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        rl[ii] = rows[ty * 4 + ii];
        rd[ii] = rows[kB + ty * 4 + ii];
      }
      zero(s);
      zero(dp);
      mma<KC, D>(s, qt, kLd, kt, kLd);
      mma<KC, D>(dp, dot, kLd, vt, kLd);
      p_ds(s, dp, rl, rd, q0, k0, tq, tk, causal, scale);
      __syncthreads();              // every lane is done with qt and dot
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          ps[(ty * 4 + ii) * kLd + tx + 16 * c] = Elem<T>::round(s[ii][c]);
          dss[(ty * 4 + ii) * kLd + tx + 16 * c] = Elem<T>::round(dp[ii][c]);
        }
      __syncthreads();
      mma<NC, kB>(dv_acc, ps, kLd, dos, LdD);
      mma<NC, kB>(dk_acc, dss, kLd, qsm, LdD);
    }
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int kpos = k0 + ty * 4 + ii;
    if (kpos >= tk) continue;
    const long long at = kvoff + static_cast<long long>(kpos) * ks;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      Elem<T>::store(dk + at + tx + 16 * c, dk_acc[ii][c]);
      Elem<T>::store(dv + at + tx + 16 * c, dv_acc[ii][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// The head_dim-split arm: D a multiple of 128 past 256, which no tile of
// the templates above holds within 227 KB.  A fourth grid axis (z) takes
// D in chunks of 128 columns.  Every CTA accumulates the logits q k^T
// (and dp = do v^T) over ALL chunks, staging 128 columns of each operand
// at a time in the order t = 0 .. D-1 of the templates' sums, so every
// chunk's CTA computes the same logits bitwise; it then produces only its
// own chunk's 128 columns of the output (out, dq, or dk and dv).  The
// recompute costs D/128 times the logit work.  Tiles as at D = 256: R =
// 32 rows, 128 threads (16 lanes x 8 rows).

constexpr int kDC = 128;                    // columns of a D chunk
constexpr int kSR = tile_rows(256);         // rows of a tile (32)
constexpr int kSLd = ld_of(256);            // [t][R] row stride
constexpr int kSLdC = kDC + kPad;           // [R][t] row stride
constexpr int kSThreads = threads_of(256);  // 128

// columns [c0, c0 + 128) of rows [r0, r0 + R) of one head (row stride
// `stride`), zero past t_len, widened to fp32: transposed into dst[d][r]
// or as they lie into dst[r][d]
template <class T, bool kTrans>
__device__ void load_chunk(float* dst, const T* src, long long stride,
                           int c0, int r0, int t_len) {
  for (int i = threadIdx.x; i < kSR * kDC; i += kSThreads) {
    const int r = i / kDC, d = i % kDC;
    const float x = r0 + r < t_len
                        ? Elem<T>::load(src + (r0 + r) * stride + c0 + d)
                        : 0.0f;
    if (kTrans)
      dst[d * kSLd + r] = x;
    else
      dst[r * kSLdC + d] = x;
  }
}

// forward: grid (ceil(Tq/R), B*H, D/128)
template <class T>
__global__ void __launch_bounds__(kSThreads)
    split_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int tq, int tk, int h,
                     int hkv, int d, int causal, float scale) {
  constexpr int NC = kDC / 16, KC = kSR / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // [128][R] queries, chunk cc
  float* kt = qt + kDC * kSLd;      // [128][R] keys, chunk cc
  float* vs = kt + kDC * kSLd;      // [R][128] values, chunk c
  float* pt = vs + kSR * kSLdC;     // [R keys][R queries]
  const int tx = lane_x(), ty = lane_y();
  const int b = blockIdx.y / h, hh = blockIdx.y % h, g = hh / (h / hkv);
  const int q0 = blockIdx.x * kSR, c0 = blockIdx.z * kDC, chunks = d / kDC;
  const long long qs = static_cast<long long>(h) * d;
  const long long ks = static_cast<long long>(hkv) * d;
  const T* qb = q + (static_cast<long long>(b) * tq * h + hh) * d;
  const T* kb = k + (static_cast<long long>(b) * tk * hkv + g) * d;
  const T* vb = v + (static_cast<long long>(b) * tk * hkv + g) * d;
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.0f;
  zero(acc);
  const int n_k = (tk + kSR - 1) / kSR;
  const int n_j = causal ? min(n_k, static_cast<int>(blockIdx.x) + 1) : n_k;
  for (int j = 0; j < n_j; ++j) {
    const int k0 = j * kSR;
    float s[4][KC];
    zero(s);
    for (int cc = 0; cc < chunks; ++cc) {
      __syncthreads();   // the last products are done with every tile
      load_chunk<T, true>(qt, qb, qs, cc * kDC, q0, tq);
      load_chunk<T, true>(kt, kb, ks, cc * kDC, k0, tk);
      if (cc == 0) load_chunk<T, false>(vs, vb, ks, c0, k0, tk);
      __syncthreads();
      mma<KC, kDC>(s, qt, kSLd, kt, kSLd);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const bool ok = valid_at(qpos, k0 + tx + 16 * c, tq, tk, causal);
        s[i][c] = ok ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const bool ok = valid_at(qpos, k0 + tx + 16 * c, tq, tk, causal);
        const float p = ok ? expf(s[i][c] - m_new) : 0.0f;
        pt[(tx + 16 * c) * kSLd + ty * 4 + i] = Elem<T>::round(p);
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    mma<NC, kSR>(acc, pt, kSLd, vs, kSLdC);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<long long>(b) * tq + qpos) * h + hh) * d + c0;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      Elem<T>::store(o + tx + 16 * c, acc[i][c] / den);
    if (tx == 0 && blockIdx.z == 0)
      lse[(static_cast<long long>(b) * h + hh) * tq + qpos] =
          m[i] + logf(den);
  }
}

// backward, dq: grid (ceil(Tq/R), B*H, D/128); keys innermost
template <class T>
__global__ void __launch_bounds__(kSThreads)
    split_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int tq, int tk, int h, int hkv, int d, int causal,
                    float scale) {
  constexpr int NC = kDC / 16, KC = kSR / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // [128][R], chunk cc
  float* dot = qt + kDC * kSLd;     // [128][R]
  float* kt = dot + kDC * kSLd;     // [128][R]
  float* vt = kt + kDC * kSLd;      // [128][R]
  float* ksm = vt + kDC * kSLd;     // [R][128] keys, chunk c
  float* dst = ksm + kSR * kSLdC;   // [R keys][R queries] ds
  const int tx = lane_x(), ty = lane_y();
  const int b = blockIdx.y / h, hh = blockIdx.y % h, g = hh / (h / hkv);
  const int q0 = blockIdx.x * kSR, c0 = blockIdx.z * kDC, chunks = d / kDC;
  const long long qs = static_cast<long long>(h) * d;
  const long long ks = static_cast<long long>(hkv) * d;
  const long long qoff = (static_cast<long long>(b) * tq * h + hh) * d;
  const T* kb = k + (static_cast<long long>(b) * tk * hkv + g) * d;
  const T* vb = v + (static_cast<long long>(b) * tk * hkv + g) * d;
  float rl[4], rd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    const long long at = (static_cast<long long>(b) * h + hh) * tq + qpos;
    rl[i] = qpos < tq ? lse[at] : 0.0f;
    rd[i] = qpos < tq ? delta[at] : 0.0f;
  }
  float acc[4][NC];
  zero(acc);
  const int n_k = (tk + kSR - 1) / kSR;
  const int n_j = causal ? min(n_k, static_cast<int>(blockIdx.x) + 1) : n_k;
  for (int j = 0; j < n_j; ++j) {
    const int k0 = j * kSR;
    float s[4][KC], dp[4][KC];
    zero(s);
    zero(dp);
    for (int cc = 0; cc < chunks; ++cc) {
      __syncthreads();
      load_chunk<T, true>(qt, q + qoff, qs, cc * kDC, q0, tq);
      load_chunk<T, true>(dot, dout + qoff, qs, cc * kDC, q0, tq);
      load_chunk<T, true>(kt, kb, ks, cc * kDC, k0, tk);
      load_chunk<T, true>(vt, vb, ks, cc * kDC, k0, tk);
      if (cc == 0) load_chunk<T, false>(ksm, kb, ks, c0, k0, tk);
      __syncthreads();
      mma<KC, kDC>(s, qt, kSLd, kt, kSLd);
      mma<KC, kDC>(dp, dot, kSLd, vt, kSLd);
    }
    p_ds(s, dp, rl, rd, q0, k0, tq, tk, causal, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < KC; ++c)
        dst[(tx + 16 * c) * kSLd + ty * 4 + i] = Elem<T>::round(dp[i][c]);
    __syncthreads();
    mma<NC, kSR>(acc, dst, kSLd, ksm, kSLdC);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= tq) continue;
    T* o = dq + ((static_cast<long long>(b) * tq + qpos) * h + hh) * d + c0;
#pragma unroll
    for (int c = 0; c < NC; ++c) Elem<T>::store(o + tx + 16 * c, acc[i][c]);
  }
}

// backward, dk/dv: grid (ceil(Tk/R), B*H_kv, D/128); the query blocks of
// the rep heads innermost, in the templates' order, their sums in
// registers
template <class T>
__global__ void __launch_bounds__(kSThreads)
    split_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int tq, int tk, int h, int hkv,
                     int d, int causal, float scale) {
  constexpr int NC = kDC / 16, KC = kSR / 16;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                 // [128][R] keys, chunk cc
  float* vt = kt + kDC * kSLd;      // [128][R]
  float* qt = vt + kDC * kSLd;      // [128][R] queries, chunk cc
  float* dot = qt + kDC * kSLd;     // [128][R]
  float* qsm = dot + kDC * kSLd;    // [R][128] queries, chunk c
  float* dos = qsm + kSR * kSLdC;   // [R][128]
  float* ps = dos + kSR * kSLdC;    // [R q][R k] p
  float* dss = ps + kSR * kSLd;     // [R q][R k] ds
  float* rows = dss + kSR * kSLd;   // lse[R], delta[R]
  const int tx = lane_x(), ty = lane_y();
  const int b = blockIdx.y / hkv, g = blockIdx.y % hkv, rep = h / hkv;
  const int k0 = blockIdx.x * kSR, c0 = blockIdx.z * kDC, chunks = d / kDC;
  const long long qs = static_cast<long long>(h) * d;
  const long long ks = static_cast<long long>(hkv) * d;
  const long long kvoff = (static_cast<long long>(b) * tk * hkv + g) * d;
  float dk_acc[4][NC], dv_acc[4][NC];
  zero(dk_acc);
  zero(dv_acc);
  const int n_q = (tq + kSR - 1) / kSR;
  const int i0 = causal ? static_cast<int>(blockIdx.x) : 0;
  for (int r = 0; r < rep; ++r) {
    const int hh = g * rep + r;
    const long long qoff = (static_cast<long long>(b) * tq * h + hh) * d;
    const long long roff = (static_cast<long long>(b) * h + hh) * tq;
    for (int i = i0; i < n_q; ++i) {
      const int q0 = i * kSR;
      float s[4][KC], dp[4][KC];
      zero(s);
      zero(dp);
      for (int cc = 0; cc < chunks; ++cc) {
        __syncthreads();
        load_chunk<T, true>(kt, k + kvoff, ks, cc * kDC, k0, tk);
        load_chunk<T, true>(vt, v + kvoff, ks, cc * kDC, k0, tk);
        load_chunk<T, true>(qt, q + qoff, qs, cc * kDC, q0, tq);
        load_chunk<T, true>(dot, dout + qoff, qs, cc * kDC, q0, tq);
        if (cc == 0) {
          load_chunk<T, false>(qsm, q + qoff, qs, c0, q0, tq);
          load_chunk<T, false>(dos, dout + qoff, qs, c0, q0, tq);
          if (threadIdx.x < kSR) {
            const int qpos = q0 + threadIdx.x;
            rows[threadIdx.x] = qpos < tq ? lse[roff + qpos] : 0.0f;
            rows[kSR + threadIdx.x] = qpos < tq ? delta[roff + qpos] : 0.0f;
          }
        }
        __syncthreads();
        mma<KC, kDC>(s, qt, kSLd, kt, kSLd);
        mma<KC, kDC>(dp, dot, kSLd, vt, kSLd);
      }
      float rl[4], rd[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        rl[ii] = rows[ty * 4 + ii];
        rd[ii] = rows[kSR + ty * 4 + ii];
      }
      p_ds(s, dp, rl, rd, q0, k0, tq, tk, causal, scale);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          ps[(ty * 4 + ii) * kSLd + tx + 16 * c] = Elem<T>::round(s[ii][c]);
          dss[(ty * 4 + ii) * kSLd + tx + 16 * c] = Elem<T>::round(dp[ii][c]);
        }
      __syncthreads();
      mma<NC, kSR>(dv_acc, ps, kSLd, dos, kSLdC);
      mma<NC, kSR>(dk_acc, dss, kSLd, qsm, kSLdC);
    }
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int kpos = k0 + ty * 4 + ii;
    if (kpos >= tk) continue;
    const long long at = kvoff + static_cast<long long>(kpos) * ks + c0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      Elem<T>::store(dk + at + tx + 16 * c, dk_acc[ii][c]);
      Elem<T>::store(dv + at + tx + 16 * c, dv_acc[ii][c]);
    }
  }
}

constexpr int split_fwd_smem() {
  return (2 * kDC * kSLd + kSR * (kSLdC + kSLd)) * 4;
}
constexpr int split_dq_smem() {
  return (4 * kDC * kSLd + kSR * (kSLdC + kSLd)) * 4;
}
constexpr int split_dkv_smem() {
  return (4 * kDC * kSLd + 2 * kSR * (kSLdC + kSLd) + 2 * kSR) * 4;
}
static_assert(split_fwd_smem() <= 232448 && split_dq_smem() <= 232448 &&
                  split_dkv_smem() <= 232448,
              "head_dim-split tiles exceed 227 KB");

constexpr int fwd_smem(int d) {
  return (2 * d * ld_of(d) + tile_rows(d) * (d + kPad + ld_of(d))) * 4;
}
constexpr int dq_smem(int d) {
  return (4 * d * ld_of(d) + tile_rows(d) * (d + kPad + ld_of(d))) * 4;
}
constexpr int dkv_smem(int d) {
  return (2 * d * ld_of(d) + 2 * qtile(d) +
          2 * tile_rows(d) * (d + kPad + 1)) * 4;
}
static_assert(dkv_smem(128) <= 232448 && dkv_smem(256) <= 232448,
              "dk/dv tiles exceed 227 KB");
static_assert(dq_smem(128) <= 232448 && dq_smem(256) <= 232448,
              "dq tiles exceed 227 KB");
static_assert(fwd_smem(256) <= 232448, "forward tiles exceed 227 KB");

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

struct Shape {
  int b, tq, tk, h, hkv, causal;
  float scale;
};

// batches of at most `per` rows each, so that a grid's y extent of
// (batch rows) x `per_row` stays within 65535: launch(b0, rows) for each
// chunk in order, stopping at the first error
template <class L>
int batch_chunks(int b, int per_row, L launch) {
  if (per_row < 1 || per_row > kGridY) return int(cudaErrorInvalidValue);
  const int per = kGridY / per_row;
  for (int b0 = 0; b0 < b; b0 += per) {
    const int e = launch(b0, b - b0 < per ? b - b0 : per);
    if (e != 0) return e;
  }
  return 0;
}

template <class T, int D>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse,
        Shape n, cudaStream_t s) {
  constexpr int kB = tile_rows(D);
  cudaError_t e = allow_smem(fwd_kernel<T, D>, fwd_smem(D));
  if (e != cudaSuccess) return int(e);
  const long long qb = static_cast<long long>(n.tq) * n.h * D;
  const long long kb = static_cast<long long>(n.tk) * n.hkv * D;
  return batch_chunks(n.b, n.h, [&](int b0, int rows) {
    const dim3 grid((n.tq + kB - 1) / kB, rows * n.h);
    fwd_kernel<T, D><<<grid, threads_of(D), fwd_smem(D), s>>>(
        static_cast<const T*>(q) + b0 * qb, static_cast<const T*>(k) + b0 * kb,
        static_cast<const T*>(v) + b0 * kb, static_cast<T*>(out) + b0 * qb,
        lse + static_cast<long long>(b0) * n.h * n.tq, n.tq, n.tk, n.h,
        n.hkv, n.causal, n.scale);
    return int(cudaGetLastError());
  });
}

template <class T, int D>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq, void* dk, void* dv,
        Shape n, cudaStream_t s) {
  constexpr int kB = tile_rows(D);
  cudaError_t e = allow_smem(dq_kernel<T, D>, dq_smem(D));
  if (e == cudaSuccess) e = allow_smem(dkv_kernel<T, D>, dkv_smem(D));
  if (e != cudaSuccess) return int(e);
  const long long qb = static_cast<long long>(n.tq) * n.h * D;
  const long long kb = static_cast<long long>(n.tk) * n.hkv * D;
  const long long rb = static_cast<long long>(n.h) * n.tq;
  return batch_chunks(n.b, n.h, [&](int b0, int rows) {
    const T* qt = static_cast<const T*>(q) + b0 * qb;
    const T* kt = static_cast<const T*>(k) + b0 * kb;
    const T* vt = static_cast<const T*>(v) + b0 * kb;
    const T* dt = static_cast<const T*>(dout) + b0 * qb;
    const float* lt = lse + b0 * rb;
    const float* et = delta + b0 * rb;
    dq_kernel<T, D><<<dim3((n.tq + kB - 1) / kB, rows * n.h), threads_of(D),
                      dq_smem(D), s>>>(qt, kt, vt, dt, lt, et,
                                       static_cast<T*>(dq) + b0 * qb, n.tq,
                                       n.tk, n.h, n.hkv, n.causal, n.scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    dkv_kernel<T, D><<<dim3((n.tk + kB - 1) / kB, rows * n.hkv),
                       threads_of(D), dkv_smem(D), s>>>(
        qt, kt, vt, dt, lt, et, static_cast<T*>(dk) + b0 * kb,
        static_cast<T*>(dv) + b0 * kb, n.tq, n.tk, n.h, n.hkv, n.causal,
        n.scale);
    return int(cudaGetLastError());
  });
}

// the instantiation for (element type code, head_dim): 0 fp32, 1 bf16
template <template <class, int> class F, class... A>
int dispatch(int dtype, int d, A... args) {
  if (dtype == 0) {
    if (d == 32) return F<float, 32>::run(args...);
    if (d == 64) return F<float, 64>::run(args...);
    if (d == 128) return F<float, 128>::run(args...);
    if (d == 256) return F<float, 256>::run(args...);
  } else if (dtype == 1) {
    if (d == 32) return F<__nv_bfloat16, 32>::run(args...);
    if (d == 64) return F<__nv_bfloat16, 64>::run(args...);
    if (d == 128) return F<__nv_bfloat16, 128>::run(args...);
    if (d == 256) return F<__nv_bfloat16, 256>::run(args...);
  }
  return int(cudaErrorInvalidValue);
}

template <class T>
int split_fwd(const void* q, const void* k, const void* v, void* out,
              float* lse, Shape n, int d, cudaStream_t s) {
  cudaError_t e = allow_smem(split_fwd_kernel<T>, split_fwd_smem());
  if (e != cudaSuccess) return int(e);
  const long long qb = static_cast<long long>(n.tq) * n.h * d;
  const long long kb = static_cast<long long>(n.tk) * n.hkv * d;
  return batch_chunks(n.b, n.h, [&](int b0, int rows) {
    const dim3 grid((n.tq + kSR - 1) / kSR, rows * n.h, d / kDC);
    split_fwd_kernel<T><<<grid, kSThreads, split_fwd_smem(), s>>>(
        static_cast<const T*>(q) + b0 * qb, static_cast<const T*>(k) + b0 * kb,
        static_cast<const T*>(v) + b0 * kb, static_cast<T*>(out) + b0 * qb,
        lse + static_cast<long long>(b0) * n.h * n.tq, n.tq, n.tk, n.h,
        n.hkv, d, n.causal, n.scale);
    return int(cudaGetLastError());
  });
}

template <class T>
int split_bwd(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, void* dk,
              void* dv, Shape n, int d, cudaStream_t s) {
  cudaError_t e = allow_smem(split_dq_kernel<T>, split_dq_smem());
  if (e == cudaSuccess) e = allow_smem(split_dkv_kernel<T>, split_dkv_smem());
  if (e != cudaSuccess) return int(e);
  const long long qb = static_cast<long long>(n.tq) * n.h * d;
  const long long kb = static_cast<long long>(n.tk) * n.hkv * d;
  const long long rb = static_cast<long long>(n.h) * n.tq;
  return batch_chunks(n.b, n.h, [&](int b0, int rows) {
    const T* qt = static_cast<const T*>(q) + b0 * qb;
    const T* kt = static_cast<const T*>(k) + b0 * kb;
    const T* vt = static_cast<const T*>(v) + b0 * kb;
    const T* dt = static_cast<const T*>(dout) + b0 * qb;
    const float* lt = lse + b0 * rb;
    const float* et = delta + b0 * rb;
    split_dq_kernel<T><<<dim3((n.tq + kSR - 1) / kSR, rows * n.h, d / kDC),
                         kSThreads, split_dq_smem(), s>>>(
        qt, kt, vt, dt, lt, et, static_cast<T*>(dq) + b0 * qb, n.tq, n.tk,
        n.h, n.hkv, d, n.causal, n.scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    split_dkv_kernel<T><<<dim3((n.tk + kSR - 1) / kSR, rows * n.hkv,
                               d / kDC),
                          kSThreads, split_dkv_smem(), s>>>(
        qt, kt, vt, dt, lt, et, static_cast<T*>(dk) + b0 * kb,
        static_cast<T*>(dv) + b0 * kb, n.tq, n.tk, n.h, n.hkv, d, n.causal,
        n.scale);
    return int(cudaGetLastError());
  });
}

template <class T, int D>
struct Fwd {
  template <class... A>
  static int run(A... args) { return fwd<T, D>(args...); }
};
template <class T, int D>
struct Bwd {
  template <class... A>
  static int run(A... args) { return bwd<T, D>(args...); }
};

}  // namespace

// forward: out (B, Tq, H, D) and lse (B, H, Tq) fp32 from q (B, Tq, H, D),
// k and v (B, Tk, H_kv, D), all contiguous, of element type `dtype` (0
// fp32, 1 bf16); head_dim 32, 64, 128 or 256, any batch.  Returns the
// cudaError of the launch (cudaErrorInvalidValue for another dtype or
// head_dim, or more than 65535 heads).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int b, int tq, int tk,
                                int h, int hkv, int d, int dtype, int causal,
                                float scale, void* stream) {
  const Shape n{b, tq, tk, h, hkv, causal, scale};
  return dispatch<Fwd>(dtype, d, q, k, v, out, static_cast<float*>(lse), n,
                       static_cast<cudaStream_t>(stream));
}

// backward: dq (B, Tq, H, D), dk and dv (B, Tk, H_kv, D) from the
// forward's inputs, the output gradient dout, lse and delta (B, H, Tq)
// fp32; the element type of q, k, v, dout and the gradients is `dtype`.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* dk,
                                void* dv, int b, int tq, int tk, int h,
                                int hkv, int d, int dtype, int causal,
                                float scale, void* stream) {
  const Shape n{b, tq, tk, h, hkv, causal, scale};
  return dispatch<Bwd>(dtype, d, q, k, v, dout,
                       static_cast<const float*>(lse),
                       static_cast<const float*>(delta), dq, dk, dv, n,
                       static_cast<cudaStream_t>(stream));
}

// the head_dim-split arm: flash_fwd_launch / flash_bwd_launch's function
// for head_dim d a multiple of 128 past 256 (cudaErrorInvalidValue for
// another d or dtype)
extern "C" int flash_split_fwd_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int b, int tq, int tk, int h, int hkv,
                                      int d, int dtype, int causal,
                                      float scale, void* stream) {
  if (d <= 256 || d % kDC != 0) return int(cudaErrorInvalidValue);
  const Shape n{b, tq, tk, h, hkv, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return split_fwd<float>(q, k, v, out, l, n, d, s);
  if (dtype == 1) return split_fwd<__nv_bfloat16>(q, k, v, out, l, n, d, s);
  return int(cudaErrorInvalidValue);
}

extern "C" int flash_split_bwd_launch(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv, int b,
                                      int tq, int tk, int h, int hkv, int d,
                                      int dtype, int causal, float scale,
                                      void* stream) {
  if (d <= 256 || d % kDC != 0) return int(cudaErrorInvalidValue);
  const Shape n{b, tq, tk, h, hkv, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* e = static_cast<const float*>(delta);
  if (dtype == 0)
    return split_bwd<float>(q, k, v, dout, l, e, dq, dk, dv, n, d, s);
  if (dtype == 1)
    return split_bwd<__nv_bfloat16>(q, k, v, dout, l, e, dq, dk, dv, n, d, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
