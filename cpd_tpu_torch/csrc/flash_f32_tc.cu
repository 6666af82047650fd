// Flash attention in fp32 on the tensor cores: the forward with its
// per-row log-sum-exp, and the backward as a dq kernel and a dk/dv kernel,
// for fp32 q (B, Tq, H, D) and unexpanded k, v (B, Tk, H_kv, D), head_dim
// 32, 64 or 128; kv head g serves query heads g*rep .. g*rep + rep - 1 for
// any rep = H / H_kv >= 1.  Every product is 3xTF32 mma.sync.
//
// Replaces, in fp32, three TPU kernels:
//   K9  cpd_tpu/ops/flash_gqa.py _flash_gqa_fwd_call (:151; body
//       _flash_gqa_kernel :64), the forward at rep = 4 on the GQA LM
//   K10 cpd_tpu/ops/flash_gqa.py _flash_gqa_bwd_call (:298; bodies
//       _bwd_p_ds :203, _flash_gqa_bwd_dq_kernel :231,
//       _flash_gqa_bwd_dkv_kernel :259)
//   K11 cpd_tpu/ops/attention.py:116 _flash_attention (the stock Pallas
//       kernel, via cpd_tpu/compat.py:79): the same function at rep = 1
// launched by ops/flash_gqa.py (K9, K10) and ops/flash_mha.py (K11) for
// every fp32 CUDA call.  bf16 stays elsewhere: K11 on flash_mha_tc.cu,
// K9/K10 on flash_gqa.cu's templates, whose fp32 arm is now the yardstick
// these kernels are timed against.
//
// What they compute: flash_gqa.cu's fp32 contract, unchanged.  Logits,
// the online softmax, l and m in fp32; s is scaled after the product; a
// masked p is zeroed by the mask; out = acc / max(l, 1e-30) and lse = m +
// log(max(l, 1e-30)), so a fully masked row gives 0; pad keys past Tk are
// masked by position and T need not be a multiple of 64; Tq != Tk either
// way (the causal diagonal at query i = key i); causal key tiles wholly
// above the diagonal are skipped.  Backward: p = exp(s scale - lse), dp =
// do v^T, ds = p (dp - delta) scale, dq = ds k, dk = sum_rep ds^T q, dv =
// sum_rep p^T do.  delta = sum_d do*out is one torch op outside
// (flash_gqa._delta), as in JAX.
//
// The arithmetic: 3xTF32, the split CUTLASS's OpMultiplyAddFastF32 makes
// (SDPA's fp32 mem-efficient kernel runs it).  Each fp32 operand x is hi
// = rna_tf32(x), lo = rna_tf32(x - hi), the rounding cvt.rna.tf32.f32
// makes, done in integer instructions (`split`), and a b is taken as
// lo*hi' + hi*lo' + hi*hi' on mma.sync.m16n8k8 TF32 tiles into fp32
// accumulators, the two small products first so that they are not lost
// against the large one.  A product of two TF32 values is exact in fp32;
// the dropped lo*lo' is below 2^-22 relative (one TF32 product alone
// misses the 1e-5 tolerance ~80x).  The tensor cores' fp32 accumulation
// truncates: a sum walked over many tiles is kept in fp32 registers and
// each tile's partial sum joins it in one rounded fma (`gemm_reg_b`);
// kept in the mma accumulator, K10's dk at the LM's shape drifts past its
// 1e-4 tolerance.
//
// What bounds them.  fp32-accurate products run at a third of the TF32
// tensor-core rate, 495 / 3 = 165 TFLOP/s on an H100 SXM: the forward
// does 2 products of (Tq, D) x (D, Tk) per head, the backward 5, half of
// them under the causal mask.  At (4, 1024, 8, 64) causal that is 4.30 /
// 10.75 GFLOP, 0.0261 / 0.0651 ms (at fp32's 67 TFLOP/s on the CUDA cores
// 0.0642 / 0.1604); the bytes (each input read once, each output written
// once, 21 / 42 MB) take 0.006 / 0.013 ms.  mma.sync does not reach the
// 495 TFLOP/s that wgmma does, and the split backward recomputes s and dp
// in both kernels, 7 products where 5 would do.  What holds these kernels
// further below is the count of instructions: the splits take over half
// of the loops' instructions (4 per operand value, each B value serving
// one 16-row m-tile).
//
// Design.  A CTA of 4 warps owns 64 rows, 16 per warp: query rows in the
// forward and dq kernels, keys in the dk/dv kernel; three CTAs share an
// SM at D <= 64 (forward, dq; dk/dv two, with its 64 + 64 accumulators).
// The CTA's own operands (q in the forward; q, do in dq; k, v in dk/dv)
// are [64][D] fp32 tiles; the operands it walks (k, v; q, do with their
// lse/delta rows) come in 32-row tiles, double-buffered: cp.async.cg
// 16-byte copies (zero-filled past the rows) of the next tile are in
// flight while this one multiplies, one barrier per step.  Tiles have a
// row stride of D + 8 words with columns swapped by 8 in every other group
// of 4 rows (`tile_at`), so that both fragment shapes meet 32 banks once:
// rows g at columns 2t, 2t + 1 (64-bit loads), and rows 2t, 2t + 1 at
// column g.  Each operand is split where it is read; splitting the walked
// tiles once per CTA into (hi, lo) tiles, or the CTA's own operands once
// per CTA, measured slower: the split tiles double the shared-memory
// traffic and cost the third CTA.  The three mma of a product run as
// three passes over all its n-tiles, and s and dp are taken side by side
// (`gemm_abt` with M = 2), so that no mma waits on the one before it.
// The order of a sum is free, which the fragments use twice.  In s = q
// k^T (and dp, s^T, dp^T) A's column t is taken as element 2t and t + 4
// as 2t + 1, so that a lane's two A (and B) elements are one 64-bit load.
// And P stays in registers: the m16n8 C fragment holds columns 2t, 2t+1
// where the m16n8k8 A fragment reads t, t + 4, so with the same reading
// p (and ds) are already the A fragments of p v (and ds k), whose B
// fragment is read at rows 2t and 2t + 1.  The dk/dv kernel computes s^T
// = k q^T and dp^T = v do^T (rows = its keys), so p^T and ds^T land as
// the A fragments of p^T do and ds^T q.  It runs one CTA per query head:
// at rep = 4 one per kv head summing its rep heads in registers made 128
// CTAs for 132 SMs, so at rep > 1 each head's share goes to a (B, Tk, H,
// D) scratch and `rep_sum_kernel` adds the rep shares in order.  No
// atomics: two launches give the same bits.  The dq and dk/dv kernels
// run side by side, dk/dv on a second stream forked from the caller's and
// joined back to it by events: SMs holding CTAs of both kinds retire
// more of the backward than either kernel alone keeps busy.  Exponentials
// are the hardware's exp2 (ex2.approx.ftz) of log2-scaled logits.
// Causal key tiles above the diagonal are skipped, only tiles on the
// diagonal or an edge are masked, and query blocks run longest first.
// Shared memory (forward, dq, dk/dv): 54 / 72 / 72.5 KB at D = 64, 102
// / 136 / 136.5 KB at D = 128.
//
// Next, not here: wgmma (it takes TF32 only K-major from shared memory,
// so the split operands would be staged there), TMA tile loads and warp
// specialisation, as for flash_mha_tc.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;               // rows of a CTA
constexpr int kStep = 32;               // rows of a tile a loop walks
constexpr int kThreads = 128;           // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;       // the JAX package's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int row_stride(int d) { return d + 8; }
__host__ __device__ constexpr int tile_floats(int d, int rows = kRows) {
  return rows * row_stride(d);
}
// the CTA's own tiles, then two buffers of each walked tile
constexpr int fwd_smem(int d) {
  return (tile_floats(d) + 4 * tile_floats(d, kStep)) * 4;
}
constexpr int dq_smem(int d) {
  return (2 * tile_floats(d) + 4 * tile_floats(d, kStep)) * 4;
}
constexpr int dkv_smem(int d) {
  return (2 * tile_floats(d) + 4 * tile_floats(d, kStep) + 2 * 2 * kStep) *
         4;
}
// CTAs an SM holds at D <= 64: registers (at most 168 a thread) and
// shared memory allow 3 for the forward and dq, 2 for dk/dv with its 64 +
// 64 accumulators
__host__ __device__ constexpr int min_ctas(int d, int at_64) {
  return d > 64 ? 1 : at_64;
}
static_assert(fwd_smem(128) <= 232448, "forward tiles exceed 227 KB");
static_assert(dq_smem(128) <= 232448, "dq tiles exceed 227 KB");
static_assert(dkv_smem(128) <= 232448, "dk/dv tiles exceed 227 KB");

// query columns of one chunk of a dk/dv walked tile: at D = 128 the
// chunk's s and dp beside the 64 + 64 accumulators, a product's partial
// sum and the split B fragments fit the register file in 16
template <int D>
constexpr int kDkvChunk = D > 64 ? 16 : kStep;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; `bytes` 0 zero-fills
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes));
}
// one word global -> shared, asynchronous; `bytes` 0 writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = hi + lo, each rounded to TF32 to nearest with ties away from zero:
// cvt.rna.tf32.f32's rounding in integer instructions (its SASS adds an
// Inf/NaN test, ~5 instructions where these take 2).  Half a TF32 ulp
// added to the bit pattern carries into the kept 19 bits exactly where
// rna rounds up; hi is masked for the subtraction that makes x - hi
// exact, and lo needs no mask, as the mma reads the top 19 bits of a
// TF32 operand only.  Inf stays Inf; a NaN whose payload carries into
// the sign (top 11 mantissa bits all set) becomes -0, no other input
// differs from cvt.rna.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c (16 x 8, fp32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col)
__device__ __forceinline__ void mma(float* c, const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an A fragment split into its TF32 parts: element e at row g + 8 (e & 1),
// column t + 4 (e >> 1) of the 16 x 8 tile (g = lane / 4, t = lane % 4)
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ int lane_g() { return (threadIdx.x % 32) / 4; }
__device__ __forceinline__ int lane_t() { return threadIdx.x % 4; }

// the word of element (r, c) in a tile of row stride L = D + 8 (8 words
// mod 32), columns swapped by 8 in every other group of 4 rows: a
// half-warp's 64-bit loads of rows g, columns 2t and 2t + 1, and a warp's
// 32-bit loads of rows 2t (or 2t + 1), column g, each meet 32 banks once
__device__ __forceinline__ int tile_at(int r, int c, int stride) {
  return r * stride + (c ^ ((r & 4) << 1));
}

// A from rows [r0, r0 + 16) x columns [c0, c0 + 8) of a tile, in the
// order `gemm_abt` sums them: A's column t is column 2t and t + 4 is
// 2t + 1, so a lane's two columns are one 64-bit load
template <int D>
__device__ __forceinline__ FragA load_a(const float* tile, int r0, int c0) {
  constexpr int L = row_stride(D);
  const int r = r0 + lane_g(), c = c0 + 2 * lane_t();
  const float2 x = *reinterpret_cast<const float2*>(tile + tile_at(r, c, L));
  const float2 y =
      *reinterpret_cast<const float2*>(tile + tile_at(r + 8, c, L));
  FragA a;
  split(x.x, a.hi[0], a.lo[0]);
  split(y.x, a.hi[1], a.lo[1]);
  split(x.y, a.hi[2], a.lo[2]);
  split(y.y, a.hi[3], a.lo[3]);
  return a;
}

// A from the C fragment c of an earlier product (rows g, g + 8; columns
// 2t, 2t + 1 of its 8): A's column t is column 2t, t + 4 is 2t + 1, so
// the B fragment that meets it reads rows 2t and 2t + 1 (`gemm_reg_b`)
__device__ __forceinline__ FragA reg_a(const float (&c)[4]) {
  FragA a;
  split(c[0], a.hi[0], a.lo[0]);
  split(c[2], a.hi[1], a.lo[1]);
  split(c[1], a.hi[2], a.lo[2]);
  split(c[3], a.hi[3], a.lo[3]);
  return a;
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.0f;
}

// acc[m][n] += a[m] b[m][n] for M products of N n-tiles each in 3xTF32:
// lo*hi', then hi*lo', then hi*hi', each a pass over all M N tiles, so
// that an mma never waits on the one before it
template <int M, int N>
__device__ __forceinline__ void mma3(float (*(&acc)[M])[4],
                                     const FragA (&a)[M],
                                     const uint32_t (&bh)[M][N][2],
                                     const uint32_t (&bl)[M][N][2]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
      mma(acc[m][n], a[m].lo, bh[m][n][0], bh[m][n][1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
      mma(acc[m][n], a[m].hi, bl[m][n][0], bl[m][n][1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
      mma(acc[m][n], a[m].hi, bh[m][n][0], bh[m][n][1]);
}

// M products side by side: acc[m] (16 x 8N) += A (rows [a_row, a_row +
// 16) of tile at[m], all D columns) times the transpose of rows [n0, n0 +
// 8N) of tile bt[m]: s = q k^T and dp = do v^T, or their transposes in
// the dk/dv kernel
template <int D, int N, int M>
__device__ __forceinline__ void gemm_abt(float (*(&acc)[M])[4],
                                         const float* (&at)[M], int a_row,
                                         const float* (&bt)[M], int n0) {
  constexpr int L = row_stride(D);
#pragma unroll(D > 64 ? 4 : D / 8)
  for (int ks = 0; ks < D / 8; ++ks) {
    FragA a[M];
    uint32_t bh[M][N][2], bl[M][N][2];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      a[m] = load_a<D>(at[m], a_row, ks * 8);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        // B's row t is column 2t, t + 4 is 2t + 1, as A's columns
        const float2 x = *reinterpret_cast<const float2*>(
            bt[m] + tile_at(n0 + n * 8 + lane_g(), ks * 8 + 2 * lane_t(), L));
        split(x.x, bh[m][n][0], bl[m][n][0]);
        split(x.y, bh[m][n][1], bl[m][n][1]);
      }
    }
    mma3<M, N>(acc, a, bh, bl);
  }
}

// M products side by side: acc[m] (16 x D) = acc[m] * alpha (per row: g,
// g + 8) + A (16 x 8K: the C fragments c[m] of an earlier product, as
// `reg_a` reads them) times rows [k0, k0 + 8K) of tile bt[m] as it lies
// ([k][D]): p v, ds k, p^T do and ds^T q.  The 8K-deep sum runs in a
// zeroed fragment, G n-tiles at a time, and joins acc in one fp32 fma
// that rounds to nearest: the tensor cores' accumulation truncates, and
// over a long walk of tiles a sum kept in the mma accumulator drifts
// toward zero.
template <int D, int K, int M, int G>
__device__ __forceinline__ void gemm_reg_b(float (*(&acc)[M])[4],
                                           const float (*(&c)[M])[4],
                                           const float* (&bt)[M], int k0,
                                           const float (&alpha)[2]) {
  constexpr int L = row_stride(D);
  const int r = k0 + 2 * lane_t();
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += G) {
    float part[M][G][4];
    float (*pp[M])[4];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      zero(part[m]);
      pp[m] = part[m];
    }
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      FragA a[M];
      uint32_t bh[M][G][2], bl[M][G][2];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        a[m] = reg_a(c[m][kk]);
#pragma unroll
        for (int n = 0; n < G; ++n) {
          const int col = (n0 + n) * 8 + lane_g();
          split(bt[m][tile_at(r + kk * 8, col, L)], bh[m][n][0],
                bl[m][n][0]);
          split(bt[m][tile_at(r + kk * 8 + 1, col, L)], bh[m][n][1],
                bl[m][n][1]);
        }
      }
      mma3<M, G>(pp, a, bh, bl);
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < G; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[m][n0 + n][e] =
              fmaf(acc[m][n0 + n][e], alpha[e >> 1], part[m][n][e]);
  }
}

// rows [r0, r0 + R) of one head of a (B, T, heads, D) fp32 tensor
// (`src` at the head's row 0, `stride` elements between rows) into a
// [R][D + 8] tile (`tile_at`), by cp.async; rows at or past `t_len`
// zero-filled
template <int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int r0,
                                          int t_len) {
  constexpr int kChunks = D / 4;
  static_assert(R * kChunks % kThreads == 0, "tile split");
#pragma unroll
  for (int it = 0; it < R * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < t_len;
    cp_async16(dst + tile_at(r, c * 4, row_stride(D)),
               src + (ok ? r0 + r : 0) * stride + c * 4, ok ? 16 : 0);
  }
}

// 2^x by the hardware's exp2 (ex2.approx.ftz, within 2 ulp); a result
// below 2^-126 flushes to 0, far below what the fp32 sums it joins keep
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the C fragment element e (0..3) of n-tile n: row offset (e >> 1) * 8
// from the quad's row, column n * 8 + 2t + (e & 1)
__device__ __forceinline__ int frag_col(int n, int e) {
  return n * 8 + 2 * lane_t() + (e & 1);
}

__device__ __forceinline__ bool valid_at(int qpos, int kpos, int tq, int tk,
                                         int causal) {
  return qpos < tq && kpos < tk && (!causal || qpos >= kpos);
}

// (B, T, heads, D) tensor, head -> the head's row 0
__device__ __forceinline__ const float* head(const float* x, int b, int t,
                                             int heads, int hh, int d) {
  return x + (static_cast<long long>(b) * t * heads + hh) * d;
}

// forward: grid (ceil(Tq/64), B*H); the key tiles innermost
template <int D>
__global__ void __launch_bounds__(kThreads, min_ctas(D, 3))
    f32tc_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int tq, int tk, int h, int hkv,
                     int causal, float scale) {
  constexpr int kT = tile_floats(D, kStep);
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = sq + tile_floats(D);      // [2] key tiles
  float* sv = sk + 2 * kT;              // [2] value tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 4;           // and row + 8
  const int b = blockIdx.y / h, hh = blockIdx.y % h, kvh = hh / (h / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const long long ks = static_cast<long long>(hkv) * D;
  const float* kh = head(k, b, tk, hkv, kvh, D);
  const float* vh = head(v, b, tk, hkv, kvh, D);
  const int n_k = (tk + kStep - 1) / kStep;
  const int n_j = causal ? min(n_k, (q0 + kRows - 1) / kStep + 1) : n_k;
  load_tile<D, kRows>(sq, head(q, b, tq, h, hh, D),
                      static_cast<long long>(h) * D, q0, tq);
  if (n_j > 0) {
    load_tile<D, kStep>(sk, kh, ks, 0, tk);
    load_tile<D, kStep>(sv, vh, ks, 0, tk);
  }
  cp_async_commit();
  // logits and the running max in log2 units: p = 2^(s scale log2 e - m)
  const float scale2 = scale * kLog2e;
  float acc[D / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  zero(acc);
  for (int j = 0; j < n_j; ++j) {
    cp_async_wait_all();
    __syncthreads();              // tile j landed; tile j - 1 is read
    if (j + 1 < n_j) {
      const int nb = ((j + 1) & 1) * kT;
      load_tile<D, kStep>(sk + nb, kh, ks, (j + 1) * kStep, tk);
      load_tile<D, kStep>(sv + nb, vh, ks, (j + 1) * kStep, tk);
      cp_async_commit();
    }
    const float* kt = sk + (j & 1) * kT;
    const float* vt = sv + (j & 1) * kT;
    const int k0 = j * kStep;
    const bool edge = (causal && k0 + kStep - 1 > q0) || k0 + kStep > tk ||
                      q0 + kRows > tq;
    constexpr int N = kStep / 8;
    float s[N][4];
    zero(s);
    {
      float (*acc_s[1])[4] = {s};
      const float* a_q[1] = {sq};
      const float* b_k[1] = {kt};
      gemm_abt<D, N, 1>(acc_s, a_q, warp * 16, b_k, 0);
    }
    auto masked = [&](int n, int e) {
      return edge && !valid_at(q0 + row + (e >> 1) * 8, k0 + frag_col(n, e),
                               tq, tk, causal);
    };
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = masked(n, e) ? kNegInf : s[n][e] * scale2;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = exp2_approx(m[i] - mx[i]);
      m[i] = mx[i];
    }
    // p against the running max, zeroed where masked; l sums this
    // thread's share, the quad's shares are summed at the end
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = masked(n, e) ? 0.0f : exp2_approx(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        ps[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ps[i];
    float (*acc_o[1])[4] = {acc};
    const float (*a_p[1])[4] = {s};
    const float* b_v[1] = {vt};
    gemm_reg_b<D, N, 1, 4>(acc_o, a_p, b_v, 0, alpha);
  }
  cp_async_wait_all();            // n_j = 0 leaves the query tile pending
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float den = fmaxf(quad_sum(l[i]), 1e-30f);
    const int qpos = q0 + row + i * 8;
    if (qpos >= tq) continue;
    float* o = out + ((static_cast<long long>(b) * tq + qpos) * h + hh) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(o + frag_col(n, 0)) =
          make_float2(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
    if (lane % 4 == 0)
      lse[(static_cast<long long>(b) * h + hh) * tq + qpos] =
          m[i] * kLn2 + logf(den);
  }
}

// p and ds of one C fragment element: p = exp(s scale - lse) =
// 2^(s scale2 - lse2) with scale2 = scale log2 e, lse2 = lse log2 e, zero
// where masked; ds = p (dp - delta) scale
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse2,
                                     float delta_r, bool masked,
                                     float scale2, float scale) {
  const float p = masked ? 0.0f : exp2_approx(fmaf(s, scale2, -lse2));
  dp = p * (dp - delta_r) * scale;
  s = p;
}

// backward, dq: grid (ceil(Tq/64), B*H); the key tiles innermost
template <int D>
__global__ void __launch_bounds__(kThreads, min_ctas(D, 3))
    f32tc_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int tq, int tk, int h, int hkv, int causal, float scale) {
  constexpr int kT = tile_floats(D, kStep), kN = kStep / 8;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sdo = sq + tile_floats(D);
  float* sk = sdo + tile_floats(D);     // [2]
  float* sv = sk + 2 * kT;              // [2]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 4;
  const int b = blockIdx.y / h, hh = blockIdx.y % h, kvh = hh / (h / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const long long qs = static_cast<long long>(h) * D;
  const long long ks = static_cast<long long>(hkv) * D;
  const float* kh = head(k, b, tk, hkv, kvh, D);
  const float* vh = head(v, b, tk, hkv, kvh, D);
  const int n_k = (tk + kStep - 1) / kStep;
  const int n_j = causal ? min(n_k, (q0 + kRows - 1) / kStep + 1) : n_k;
  load_tile<D, kRows>(sq, head(q, b, tq, h, hh, D), qs, q0, tq);
  load_tile<D, kRows>(sdo, head(dout, b, tq, h, hh, D), qs, q0, tq);
  if (n_j > 0) {
    load_tile<D, kStep>(sk, kh, ks, 0, tk);
    load_tile<D, kStep>(sv, vh, ks, 0, tk);
  }
  cp_async_commit();
  float rl[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + row + i * 8;
    const long long at = (static_cast<long long>(b) * h + hh) * tq + qpos;
    rl[i] = qpos < tq ? lse[at] * kLog2e : 0.0f;
    rd[i] = qpos < tq ? delta[at] : 0.0f;
  }
  float acc[D / 8][4];
  zero(acc);
  const float one[2] = {1.0f, 1.0f};    // gemm_reg_b's fold, no rescale
  const float scale2 = scale * kLog2e;
  for (int j = 0; j < n_j; ++j) {
    cp_async_wait_all();
    __syncthreads();              // tile j landed; tile j - 1 is read
    if (j + 1 < n_j) {
      const int nb = ((j + 1) & 1) * kT;
      load_tile<D, kStep>(sk + nb, kh, ks, (j + 1) * kStep, tk);
      load_tile<D, kStep>(sv + nb, vh, ks, (j + 1) * kStep, tk);
      cp_async_commit();
    }
    const float* kt = sk + (j & 1) * kT;
    const float* vt = sv + (j & 1) * kT;
    const int k0 = j * kStep;
    const bool edge = (causal && k0 + kStep - 1 > q0) || k0 + kStep > tk ||
                      q0 + kRows > tq;
    float s[kN][4], dp[kN][4];
    zero(s);
    zero(dp);
    {
      float (*acc_sd[2])[4] = {s, dp};
      const float* a_qd[2] = {sq, sdo};
      const float* b_kv[2] = {kt, vt};
      gemm_abt<D, kN, 2>(acc_sd, a_qd, warp * 16, b_kv, 0);
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p_ds(s[n][e], dp[n][e], rl[e >> 1], rd[e >> 1],
             edge && !valid_at(q0 + row + (e >> 1) * 8, k0 + frag_col(n, e),
                               tq, tk, causal),
             scale2, scale);
    float (*acc_q[1])[4] = {acc};
    const float (*a_ds[1])[4] = {dp};
    const float* b_k[1] = {kt};
    gemm_reg_b<D, kN, 1, 4>(acc_q, a_ds, b_k, 0, one);
  }
  cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + row + i * 8;
    if (qpos >= tq) continue;
    float* o = dq + ((static_cast<long long>(b) * tq + qpos) * h + hh) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(o + frag_col(n, 0)) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// backward, dk/dv: grid (ceil(Tk/64), B*H), one query head's share of
// its kv head's gradients; the query tiles innermost, each taken in
// chunks of kDkvChunk<D> queries.  dk, dv are (B, Tk, out_heads, D) and
// this head's rows go to head `hh / (h / out_heads)`: the gradients
// themselves at rep = 1 (out_heads = H = H_kv), per-query-head partials
// (out_heads = H) that `rep_sum_kernel` adds up at rep > 1
template <int D>
__global__ void __launch_bounds__(kThreads, min_ctas(D, 2))
    f32tc_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int tq, int tk, int h, int hkv,
                     int out_heads, int causal, float scale) {
  constexpr int kT = tile_floats(D, kStep), kC = kDkvChunk<D>;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = sk + tile_floats(D);
  float* sq = sv + tile_floats(D);      // [2]
  float* sdo = sq + 2 * kT;             // [2]
  float* rows = sdo + 2 * kT;           // [2][lse kStep | delta kStep]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 4;           // key row, and row + 8
  const int b = blockIdx.y / h, hh = blockIdx.y % h, kvh = hh / (h / hkv);
  const int k0 = blockIdx.x * kRows;
  const long long qs = static_cast<long long>(h) * D;
  const long long ks = static_cast<long long>(hkv) * D;
  const int n_q = (tq + kStep - 1) / kStep;
  // causal: query tiles wholly above this key block see none of it
  const int i0 = causal ? min(k0 / kStep, n_q) : 0;
  const int total = n_q - i0;
  // step `it` of the walk: query tile i0 + it
  auto load_q = [&](int it, int buf) {
    const int qb = (i0 + it) * kStep;
    load_tile<D, kStep>(sq + buf * kT, head(q, b, tq, h, hh, D), qs, qb,
                        tq);
    load_tile<D, kStep>(sdo + buf * kT, head(dout, b, tq, h, hh, D), qs,
                        qb, tq);
    if (threadIdx.x < 2 * kStep) {
      const int r = threadIdx.x % kStep;
      const bool ok = qb + r < tq;
      const float* src = (threadIdx.x < kStep ? lse : delta) +
                         (static_cast<long long>(b) * h + hh) * tq +
                         (ok ? qb + r : 0);
      cp_async4(rows + buf * 2 * kStep + threadIdx.x, src, ok ? 4 : 0);
    }
  };
  if (total > 0) {
    load_tile<D, kRows>(sk, head(k, b, tk, hkv, kvh, D), ks, k0, tk);
    load_tile<D, kRows>(sv, head(v, b, tk, hkv, kvh, D), ks, k0, tk);
    load_q(0, 0);
  }
  cp_async_commit();
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  const float one[2] = {1.0f, 1.0f};
  const float scale2 = scale * kLog2e;
  for (int it = 0; it < total; ++it) {
    cp_async_wait_all();
    __syncthreads();              // step it landed; step it - 1 is read
    if (it + 1 < total) {
      load_q(it + 1, (it + 1) & 1);
      cp_async_commit();
    }
    const int buf = it & 1;
    const float* qt = sq + buf * kT;
    const float* dot = sdo + buf * kT;
    const float* rl = rows + buf * 2 * kStep;
    const float* rd = rl + kStep;
    const int q0 = (i0 + it) * kStep;
    const bool edge = (causal && q0 < k0 + kRows - 1) || k0 + kRows > tk ||
                      q0 + kStep > tq;
    // the chunks in turn: unrolled, their loads interleave and the
    // accumulators with them spill
#pragma unroll 1
    for (int c0 = 0; c0 < kStep; c0 += kC) {
      // s^T = k q^T and dp^T = v do^T: rows = keys, columns = queries
      float s[kC / 8][4], dp[kC / 8][4];
      zero(s);
      zero(dp);
      {
        float (*acc_sd[2])[4] = {s, dp};
        const float* a_kv[2] = {sk, sv};
        const float* b_qd[2] = {qt, dot};
        gemm_abt<D, kC / 8, 2>(acc_sd, a_kv, warp * 16, b_qd, c0);
      }
#pragma unroll
      for (int n = 0; n < kC / 8; ++n) {
        const int col = c0 + frag_col(n, 0);
        const float2 l2 = *reinterpret_cast<const float2*>(rl + col);
        const float2 d2 = *reinterpret_cast<const float2*>(rd + col);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p_ds(s[n][e], dp[n][e], (e & 1 ? l2.y : l2.x) * kLog2e,
               e & 1 ? d2.y : d2.x,
               edge && !valid_at(q0 + col + (e & 1),
                                 k0 + row + (e >> 1) * 8, tq, tk, causal),
               scale2, scale);
      }
      float (*acc_vk[2])[4] = {dv_acc, dk_acc};
      const float (*a_pds[2])[4] = {s, dp};
      const float* b_dq[2] = {dot, qt};
      gemm_reg_b<D, kC / 8, 2, (D > 64 ? 2 : 4)>(acc_vk, a_pds, b_dq, c0,
                                                 one);
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = k0 + row + i * 8;
    if (kpos >= tk) continue;
    const long long at = ((static_cast<long long>(b) * tk + kpos) *
                              out_heads + hh / (h / out_heads)) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dk + at + frag_col(n, 0)) =
          make_float2(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dv + at + frag_col(n, 0)) =
          make_float2(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// dk, dv (B, Tk, H_kv, D) = the sums over r = 0 .. rep - 1, in that
// order, of the partials (B, Tk, H, D) at head kvh * rep + r: one float4
// of one row a thread; `rows` = B * Tk * H_kv
__global__ void rep_sum_kernel(const float4* __restrict__ dk_part,
                               const float4* __restrict__ dv_part,
                               float4* __restrict__ dk,
                               float4* __restrict__ dv, long long rows,
                               int rep, int d4) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= rows * d4) return;
  const long long src = (i / d4) * rep * d4 + i % d4;
  float4 a = dk_part[src], c = dv_part[src];
  for (int r = 1; r < rep; ++r) {
    const float4 x = dk_part[src + r * d4], y = dv_part[src + r * d4];
    a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
    c.x += y.x, c.y += y.y, c.z += y.z, c.w += y.w;
  }
  dk[i] = a;
  dv[i] = c;
}

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

template <int D>
int fwd(const float* q, const float* k, const float* v, float* out,
        float* lse, Shape n, cudaStream_t s) {
  const cudaError_t e = allow_smem(f32tc_fwd_kernel<D>, fwd_smem(D));
  if (e != cudaSuccess) return int(e);
  f32tc_fwd_kernel<D><<<dim3((n.tq + kRows - 1) / kRows, n.b * n.h),
                        kThreads, fwd_smem(D), s>>>(
      q, k, v, out, lse, n.tq, n.tk, n.h, n.hkv, n.causal, n.scale);
  return int(cudaGetLastError());
}

// the second stream of a device on which the dk/dv kernel runs beside dq,
// with the events that fork it from and join it back to the caller's
// stream; made at the device's first backward and kept for the process
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};
cudaError_t side_stream(Side*& out) {
  static Side sides[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  Side& sd = sides[dev];
  if (!sd.stream) {
    e = cudaStreamCreateWithFlags(&sd.stream, cudaStreamNonBlocking);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming);
    if (e != cudaSuccess) return e;
  }
  out = &sd;
  return cudaSuccess;
}

template <int D>
int bwd(const float* q, const float* k, const float* v, const float* dout,
        const float* lse, const float* delta, float* dq, float* dk,
        float* dv, float* dk_part, float* dv_part, Shape n,
        cudaStream_t s) {
  cudaError_t e = allow_smem(f32tc_dq_kernel<D>, dq_smem(D));
  if (e == cudaSuccess) e = allow_smem(f32tc_dkv_kernel<D>, dkv_smem(D));
  Side* sd = nullptr;
  if (e == cudaSuccess) e = side_stream(sd);
  if (e == cudaSuccess) e = cudaEventRecord(sd->fork, s);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(sd->stream, sd->fork, 0);
  if (e != cudaSuccess) return int(e);
  const bool grouped = n.h > n.hkv;
  f32tc_dkv_kernel<D><<<dim3((n.tk + kRows - 1) / kRows, n.b * n.h),
                        kThreads, dkv_smem(D), sd->stream>>>(
      q, k, v, dout, lse, delta, grouped ? dk_part : dk,
      grouped ? dv_part : dv, n.tq, n.tk, n.h, n.hkv, grouped ? n.h : n.hkv,
      n.causal, n.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  f32tc_dq_kernel<D><<<dim3((n.tq + kRows - 1) / kRows, n.b * n.h),
                       kThreads, dq_smem(D), s>>>(
      q, k, v, dout, lse, delta, dq, n.tq, n.tk, n.h, n.hkv, n.causal,
      n.scale);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaEventRecord(sd->join, sd->stream);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(s, sd->join, 0);
  if (e != cudaSuccess || !grouped) return int(e);
  const long long rows = static_cast<long long>(n.b) * n.tk * n.hkv;
  const int threads = 256;
  rep_sum_kernel<<<static_cast<unsigned>((rows * (D / 4) + threads - 1) /
                                         threads),
                   threads, 0, s>>>(
      reinterpret_cast<const float4*>(dk_part),
      reinterpret_cast<const float4*>(dv_part),
      reinterpret_cast<float4*>(dk), reinterpret_cast<float4*>(dv), rows,
      n.h / n.hkv, D / 4);
  return int(cudaGetLastError());
}

// what the kernels take: head_dim 32, 64 or 128, H_kv | H, nonempty
bool valid(Shape n, int d) {
  return (d == 32 || d == 64 || d == 128) && n.b > 0 && n.hkv > 0 &&
         n.h >= n.hkv && n.h % n.hkv == 0 && n.tq > 0 && n.tk > 0;
}

}  // namespace

// forward: out (B, Tq, H, D) and lse (B, H, Tq) from fp32 q (B, Tq, H, D)
// and k, v (B, Tk, H_kv, D), all contiguous and 16-byte aligned; head_dim
// 32, 64 or 128.  Returns the cudaError of the launch
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_f32tc_fwd_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int b, int tq, int tk, int h, int hkv,
                                      int d, int causal, float scale,
                                      void* stream) {
  const Shape n{b, tq, tk, h, hkv, causal, scale};
  if (!valid(n, d)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  if (d == 32) return fwd<32>(qf, kf, vf, of, lf, n, s);
  if (d == 64) return fwd<64>(qf, kf, vf, of, lf, n, s);
  return fwd<128>(qf, kf, vf, of, lf, n, s);
}

// backward: dq (B, Tq, H, D), dk and dv (B, Tk, H_kv, D) from the
// forward's inputs, the output gradient dout, lse and delta (B, H, Tq),
// all fp32.  At H > H_kv, dk_part and dv_part are (B, Tk, H, D) scratch
// for the per-query-head partials (unused, and may be null, at H = H_kv).
extern "C" int flash_f32tc_bwd_launch(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv,
                                      void* dk_part, void* dv_part, int b,
                                      int tq, int tk, int h, int hkv, int d,
                                      int causal, float scale,
                                      void* stream) {
  const Shape n{b, tq, tk, h, hkv, causal, scale};
  if (!valid(n, d) || (h > hkv && (!dk_part || !dv_part)))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in[6] = {static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v),
                        static_cast<const float*>(dout),
                        static_cast<const float*>(lse),
                        static_cast<const float*>(delta)};
  float* out[5] = {static_cast<float*>(dq), static_cast<float*>(dk),
                   static_cast<float*>(dv), static_cast<float*>(dk_part),
                   static_cast<float*>(dv_part)};
  auto run = [&](auto launch) {
    return launch(in[0], in[1], in[2], in[3], in[4], in[5], out[0], out[1],
                  out[2], out[3], out[4], n, s);
  };
  if (d == 32) return run(bwd<32>);
  if (d == 64) return run(bwd<64>);
  return run(bwd<128>);
}

// dynamic shared memory of one CTA: kernel 0 forward, 1 dq, 2 dk/dv
extern "C" int flash_f32tc_smem_bytes(int kernel, int d) {
  return kernel == 0 ? fwd_smem(d) : kernel == 1 ? dq_smem(d) : dkv_smem(d);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
