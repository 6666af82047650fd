// Flash attention in bf16 on the tensor cores: the forward with its
// per-row log-sum-exp, and the backward as a dq kernel and a dk/dv
// kernel, for bf16 q (B, Tq, H, D) and unexpanded k, v (B, Tk, H_kv, D),
// head_dim 32, 64 or 128; kv head g serves query heads g*rep .. g*rep +
// rep - 1 for any rep = H / H_kv >= 1.  Every product is an mma.sync
// bf16 tile with fp32 accumulators.
//
// Replaces, in bf16, three TPU kernels:
//   K9  cpd_tpu/ops/flash_gqa.py _flash_gqa_fwd_call (:151; body
//       _flash_gqa_kernel :64), the forward at rep = 4 on the GQA LM
//   K10 cpd_tpu/ops/flash_gqa.py _flash_gqa_bwd_call (:298; bodies
//       _bwd_p_ds :203, _flash_gqa_bwd_dq_kernel :231,
//       _flash_gqa_bwd_dkv_kernel :259)
//   K11 cpd_tpu/ops/attention.py:116 _flash_attention, the stock Pallas
//       TPU kernel jax.experimental.pallas.ops.tpu.flash_attention (its
//       forward :388-477 and its own backward, dkv :796-938, dq
//       :1146-1261): the same function at rep = 1
// launched by ops/flash_gqa.py (K9, K10) and ops/flash_mha.py (K11) for
// every bf16 CUDA call.  fp32 runs on flash_f32_tc.cu's 3xTF32 kernels;
// flash_gqa.cu's CUDA-core templates, which K9/K10's bf16 calls ran
// before, are the yardstick these kernels are timed against.
//
// What they compute: the GQA contract of flash_gqa.cu and flash_f32_tc.cu
// with the JAX kernels' bf16 roundings, as the plain versions
// flash_gqa_fwd_ref / flash_gqa_bwd_ref encode them.
//   forward   s = q k^T accumulated in fp32 from the bf16 operands, then
//             s *= scale in fp32 (q is not pre-scaled in bf16: 1/sqrt(128)
//             is not a power of two); a masked p is zeroed by the mask
//             (causal: key > query, the diagonal at query i = key i; pad
//             keys past Tk); an online softmax over 64-key blocks in fp32
//             (running max m, l sums the fp32 p); p rounded to bf16 as
//             the A operand of p v; out = acc / max(l, 1e-30) rounded to
//             bf16 once; lse = m + log(max(l, 1e-30)), (B, H, Tq) fp32,
//             so a fully masked row gives 0.
//   backward  p = exp(s scale - lse), dp = do v^T in fp32,
//             ds = (dp - delta) p scale in fp32 from the unrounded p; p
//             and ds rounded to bf16 as the operands of dv = p^T do,
//             dk = ds^T q and dq = ds k; dk and dv summed over the rep
//             query heads of a kv head in fp32; each output rounded once
//             at its store.  delta = sum_d do*out is one torch op outside
//             (flash_gqa._delta), as in JAX.
// Tq and Tk are any lengths >= 1 (Tq != Tk either way); tile rows past
// them are zero-filled at load and skipped at store.  K11's callers keep
// the stock kernel's contract (Tk a multiple of 128, Tq >= 128, no fully
// masked row), where the stock kernel's additive mask gives the same p.
//
// What bounds them.  bf16 tensor-core operations, 989 TFLOP/s dense on an
// H100 SXM: the forward does 2 products of (Tq, D) x (D, Tk) per query
// head, the backward 5, half of them under the causal mask.  At (B, T,
// H, D) = (4, 1024, 8, 64) causal that is 4.3 / 10.8 GFLOP, 0.0043 /
// 0.0109 ms; the bytes (each input read once, each output written once)
// take 0.0050 / 0.0101 ms at 3.35 TB/s at H_kv = 8, less at H_kv = 2.  The
// split backward recomputes s and dp in both kernels, 7 products where 5
// would do.
//
// Design.  A CTA of 4 warps owns 64 rows of one query head, 16 per warp:
// query rows in the forward and dq kernels, keys in the dk/dv kernel.
// Products are mma.sync.m16n8k16 bf16 tiles fed by ldmatrix.x4 from
// shared memory (the .trans form where the operand lies [k][n]: v in p v,
// k in ds k, do and q in p^T do and ds^T q).  Tiles are [64][D] bf16 with
// XOR-swizzled 16-byte chunks, so that the 8 rows one ldmatrix reads hit
// 8 distinct bank groups.  The tiles a loop walks (k/v in the forward and
// dq, q/do and their lse/delta rows in dk/dv) are double-buffered:
// cp.async 16-byte copies (4-byte ones for the lse/delta rows; zero-filled
// past the rows) of the next tile are in flight while this one multiplies,
// one barrier per step.  Probabilities never touch shared memory: the
// fp32 C fragment of s (or of s^T) is exp'd in registers, rounded to bf16
// and is already the A fragment of the next product.  The dk/dv kernel
// gets that by computing s^T = k q^T and dp^T = v do^T (rows = its keys),
// so p^T and ds^T land as the A operands of p^T do and ds^T q; it takes
// the 64 queries of a tile in two halves of 32, which keeps its fp32 dk
// and dv (up to 64 + 64 registers a thread at D = 128) and s^T, dp^T
// within the register file.  The row max and sum of the online softmax
// reduce over the 4 lanes of a quad with __shfl_xor_sync; exponentials
// are exp2f(x log2 e), the hardware's exp2.  Causal key blocks wholly
// above the diagonal are skipped; only tiles on the diagonal or at a
// ragged edge test the mask.
//
// The query heads of one kv head are neighbours in the grid (head the
// fastest index, then batch, then the row block, longest causal blocks
// first), so the rep CTAs reading the same K/V tiles run together and
// all but the first read them from L2.  The dk/dv kernel runs one CTA per
// query head: at rep = 4 one CTA per kv head summing its rep heads in
// registers would give (B, H_kv, Tk/64) = 128 CTAs for 132 SMs at the
// GQA LM's shape, each with 4x the work.  So at rep > 1 each head's fp32
// share goes to a (B, Tk, H, D) scratch and `rep_sum_kernel` adds the rep
// shares in order and rounds to bf16 once (the JAX kernel's (rep, bq)
// contraction also accumulates in fp32 and stores once); at rep = 1 the
// kernel stores bf16 itself.  The dq and dk/dv kernels run side by side,
// dk/dv on a second stream forked from the caller's and joined back to it
// by events: SMs holding CTAs of both kinds retire more of the backward
// than either kernel alone keeps busy (measured faster than one stream at
// rep 1 and 4).  No atomics: two launches on the same inputs give
// bitwise-equal outputs.  Shared memory: 5 / 6 / 6 tiles (forward,
// dq, dk/dv), 40 / 48 / 49 KB at D = 64, 80 / 96 / 97 KB at D = 128.
//
// Next, not here: wgmma (a warpgroup's asynchronous 64-row products, the
// only way to the card's full bf16 rate, which mma.sync cannot reach)
// with TMA tile loads into the 128-byte swizzle wgmma reads, then warp
// specialisation (a producer warp keeping TMA loads in flight, consumer
// warpgroups overlapping one tile's softmax with the next tile's
// products), as FlashAttention-3 does.  wgmma comes first
// because it lifts the products' ceiling that mma.sync sets; TMA and the
// producer warp pay only once the products are that fast.  At rep > 1 a
// CTA could hold the rep heads' rows of one kv head and read each K/V
// tile once into shared memory; today L2 serves the repeats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;               // rows of a CTA and of a tile
constexpr int kThreads = 128;           // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;       // the JAX package's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int tile_bytes(int d) { return kRows * d * 2; }
constexpr int fwd_smem(int d) { return 5 * tile_bytes(d); }
constexpr int dq_smem(int d) { return 6 * tile_bytes(d); }
constexpr int dkv_smem(int d) { return 6 * tile_bytes(d) + 2 * 2 * kRows * 4; }
static_assert(fwd_smem(128) <= 232448, "forward tiles exceed 227 KB");
static_assert(dq_smem(128) <= 232448, "dq tiles exceed 227 KB");
static_assert(dkv_smem(128) <= 232448, "dk/dv tiles exceed 227 KB");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; `bytes` 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(bytes));
}
// 4 bytes global -> shared, asynchronous; `bytes` 0 zero-fills
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 rounded to bf16 (RTNE), the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte offset of (row r, 16-byte chunk c) in a swizzled [rows][W] bf16
// tile: the chunk index XORed with the row's, so that chunk c of 8
// consecutive rows falls in 8 distinct 16-byte bank groups (two 64-byte
// rows share a 128-byte line at W = 32)
template <int W>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kChunks = W / 8;
  const int x = kChunks >= 8 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
  return static_cast<uint32_t>((r * kChunks + x) * 16);
}

// ldmatrix.x4 row addresses.  `a_addr`: the A fragment of rows
// [r0, r0 + 16) x columns [c0, c0 + 16) of a row-major tile, and equally
// (.trans) the B fragments of two n-tiles [c0, c0 + 16) at k rows
// [r0, r0 + 16) of a tile that lies [k][n].  `bt_addr`: the B fragments
// of two n-tiles [r0, r0 + 16) at k columns [c0, c0 + 16) of a tile that
// lies [n][k] (a product with its transpose).  Either way registers
// 0, 1 feed the first n-tile and 2, 3 the second.
template <int W>
__device__ __forceinline__ uint32_t a_addr(uint32_t tile, int r0, int c0) {
  const int lane = threadIdx.x % 32;
  return tile + swz<W>(r0 + (lane & 15), c0 / 8 + (lane >> 4));
}
template <int W>
__device__ __forceinline__ uint32_t bt_addr(uint32_t tile, int r0, int c0) {
  const int lane = threadIdx.x % 32;
  return tile + swz<W>(r0 + ((lane >> 4) << 3) + (lane & 7),
                       c0 / 8 + ((lane >> 3) & 1));
}

// rows [r0, r0 + 64) of one head of a (B, T, heads, D) bf16 tensor
// (`src` at the head's row 0, `stride` elements between rows) into a
// swizzled [64][D] tile, by cp.async; rows at or past `t_len` zero-filled
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long stride, int r0,
                                          int t_len) {
  constexpr int kChunks = D / 8;
  static_assert(kRows * kChunks % kThreads == 0, "tile split");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < t_len;
    cp_async16(dst + swz<D>(r, c),
               src + (ok ? r0 + r : 0) * stride + c * 8, ok ? 16 : 0);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.0f;
}

// acc (16 x 8N) += A (this warp's 16 rows of tile `at`, all D columns)
// times the transpose of rows [n0, n0 + 8N) of tile `bt`: s = q k^T,
// dp = do v^T, and their transposes in the dk/dv kernel
template <int D, int N>
__device__ __forceinline__ void gemm_abt(float (&acc)[N][4], uint32_t at,
                                         int a_row, uint32_t bt, int n0) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_addr<D>(at, a_row, ks * 16));
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, bt_addr<D>(bt, n0 + np * 16, ks * 16));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += A (16 x 16K, bf16 fragments in registers) times rows
// [k0, k0 + 16K) of tile `bt` as it lies ([k][D]): p v, ds k, p^T do,
// ds^T q
template <int D, int K>
__device__ __forceinline__ void gemm_reg_b(float (&acc)[D / 8][4],
                                           const uint32_t (&a)[K][4],
                                           uint32_t bt, int k0) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, a_addr<D>(bt, k0 + kk * 16, dp * 16));
      mma(acc[2 * dp], a[kk], b[0], b[1]);
      mma(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
}

// e^x as 2^(x log2 e): the hardware exp2 and a multiply, within a few fp32
// ulps of expf (far inside the bf16 rounding of p that follows)
__device__ __forceinline__ float exp_f32(float x) {
  return exp2f(x * kLog2e);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the C fragment element e (0..3) of n-tile t: row offset (e >> 1) * 8
// from the quad's row, column t * 8 + (lane % 4) * 2 + (e & 1)
__device__ __forceinline__ int frag_col(int t, int e) {
  return t * 8 + (threadIdx.x % 4) * 2 + (e & 1);
}

// (bf16 (B, T, heads, D) tensor, head) -> the head's row 0
__device__ __forceinline__ const bf16* head(const bf16* x, int b, int t,
                                            int heads, int hh, int d) {
  return x + (static_cast<long long>(b) * t * heads + hh) * d;
}

// forward: grid (H, B, ceil(Tq/64)), the longest causal row blocks first
template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, int tq, int tk, int h, int hkv,
               int causal, float scale) {
  constexpr int kT = tile_bytes(D);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_u32(smem), sk = sq + kT, sv = sk + 2 * kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 4;           // and row + 8
  const int hh = blockIdx.x, b = blockIdx.y, kvh = hh / (h / hkv);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const long long ks = static_cast<long long>(hkv) * D;
  const bf16* kh = head(k, b, tk, hkv, kvh, D);
  const bf16* vh = head(v, b, tk, hkv, kvh, D);
  const int n_k = (tk + kRows - 1) / kRows;
  const int n_j = causal ? min(n_k, (q0 + kRows - 1) / kRows + 1) : n_k;
  load_tile<D>(sq, head(q, b, tq, h, hh, D), static_cast<long long>(h) * D,
               q0, tq);
  load_tile<D>(sk, kh, ks, 0, tk);
  load_tile<D>(sv, vh, ks, 0, tk);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[D / 16][4];                          // q, loaded once
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qf[kk], a_addr<D>(sq, warp * 16, kk * 16));
  float acc[D / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  zero(acc);
  for (int j = 0; j < n_j; ++j) {
    if (j > 0) {
      cp_async_wait_all();
      __syncthreads();            // tile j landed; tile j - 1 is read
    }
    if (j + 1 < n_j) {
      const uint32_t nb = ((j + 1) & 1) * kT;
      load_tile<D>(sk + nb, kh, ks, (j + 1) * kRows, tk);
      load_tile<D>(sv + nb, vh, ks, (j + 1) * kRows, tk);
      cp_async_commit();
    }
    const uint32_t kt = sk + (j & 1) * kT, vt = sv + (j & 1) * kT;
    const int k0 = j * kRows;
    float s[8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, bt_addr<D>(kt, np * 16, kk * 16));
        mma(s[2 * np], qf[kk], bk[0], bk[1]);
        mma(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    // only a tile on the diagonal or past Tk tests the mask
    const bool edge = (causal && k0 + kRows - 1 > q0) || k0 + kRows > tk;
    auto masked = [&](int t, int e) {
      const int kp = k0 + frag_col(t, e);
      return edge &&
             (kp >= tk || (causal && kp > q0 + row + (e >> 1) * 8));
    };
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = masked(t, e) ? kNegInf : s[t][e] * scale;
        s[t][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = exp_f32(m[i] - mx[i]);
      m[i] = mx[i];
    }
    // p against the running max, zeroed where masked: l sums it in fp32,
    // p v takes it in bf16
    uint32_t pf[4][4];
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = masked(t, e) ? 0.0f : exp_f32(s[t][e] - m[e >> 1]);
      ps[0] += p[0] + p[1];
      ps[1] += p[2] + p[3];
      pf[t / 2][(t & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[t / 2][(t & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ps[i];
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] *= alpha[e >> 1];
    gemm_reg_b<D, 4>(acc, pf, vt, 0);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float den = fmaxf(quad_sum(l[i]), 1e-30f);
    const int qpos = q0 + row + i * 8;
    if (qpos >= tq) continue;
    bf16* o = out + ((static_cast<long long>(b) * tq + qpos) * h + hh) * D;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(o + frag_col(t, 0)) =
          __floats2bfloat162_rn(acc[t][2 * i] / den, acc[t][2 * i + 1] / den);
    if (lane % 4 == 0)
      lse[(static_cast<long long>(b) * h + hh) * tq + qpos] =
          m[i] + logf(den);
  }
}

// p and ds of one C fragment element: p = exp(s scale - lse), zero where
// masked; ds = (dp - delta) p scale from the unrounded p
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse_r,
                                     float delta_r, bool masked,
                                     float scale) {
  const float p = masked ? 0.0f : exp_f32(s * scale - lse_r);
  dp = (dp - delta_r) * p * scale;
  s = p;
}

// backward, dq: grid (H, B, ceil(Tq/64)); the key blocks innermost
template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int tq, int tk, int h, int hkv,
              int causal, float scale) {
  constexpr int kT = tile_bytes(D);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_u32(smem), sdo = sq + kT, sk = sdo + kT,
                 sv = sk + 2 * kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 4;
  const int hh = blockIdx.x, b = blockIdx.y, kvh = hh / (h / hkv);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const long long qs = static_cast<long long>(h) * D;
  const long long ks = static_cast<long long>(hkv) * D;
  const bf16* kh = head(k, b, tk, hkv, kvh, D);
  const bf16* vh = head(v, b, tk, hkv, kvh, D);
  const int n_k = (tk + kRows - 1) / kRows;
  const int n_j = causal ? min(n_k, (q0 + kRows - 1) / kRows + 1) : n_k;
  load_tile<D>(sq, head(q, b, tq, h, hh, D), qs, q0, tq);
  load_tile<D>(sdo, head(dout, b, tq, h, hh, D), qs, q0, tq);
  load_tile<D>(sk, kh, ks, 0, tk);
  load_tile<D>(sv, vh, ks, 0, tk);
  cp_async_commit();
  // rows past Tq: q and do are zero there, so are lse and delta, and the
  // rows are not stored
  float rl[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + row + i * 8;
    const long long at = (static_cast<long long>(b) * h + hh) * tq + qpos;
    rl[i] = qpos < tq ? lse[at] : 0.0f;
    rd[i] = qpos < tq ? delta[at] : 0.0f;
  }
  float acc[D / 8][4];
  zero(acc);
  for (int j = 0; j < n_j; ++j) {
    cp_async_wait_all();
    __syncthreads();              // tile j landed; tile j - 1 is read
    if (j + 1 < n_j) {
      const uint32_t nb = ((j + 1) & 1) * kT;
      load_tile<D>(sk + nb, kh, ks, (j + 1) * kRows, tk);
      load_tile<D>(sv + nb, vh, ks, (j + 1) * kRows, tk);
      cp_async_commit();
    }
    const uint32_t kt = sk + (j & 1) * kT, vt = sv + (j & 1) * kT;
    const int k0 = j * kRows;
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    gemm_abt<D, 8>(s, sq, warp * 16, kt, 0);
    gemm_abt<D, 8>(dp, sdo, warp * 16, vt, 0);
    const bool edge = (causal && k0 + kRows - 1 > q0) || k0 + kRows > tk;
    uint32_t dsf[4][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + frag_col(t, e);
        p_ds(s[t][e], dp[t][e], rl[e >> 1], rd[e >> 1],
             edge && (kp >= tk ||
                      (causal && kp > q0 + row + (e >> 1) * 8)),
             scale);
      }
      dsf[t / 2][(t & 1) * 2] = pack_bf16(dp[t][0], dp[t][1]);
      dsf[t / 2][(t & 1) * 2 + 1] = pack_bf16(dp[t][2], dp[t][3]);
    }
    gemm_reg_b<D, 4>(acc, dsf, kt, 0);
  }
  cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + row + i * 8;
    if (qpos >= tq) continue;
    bf16* o = dq + ((static_cast<long long>(b) * tq + qpos) * h + hh) * D;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(o + frag_col(t, 0)) =
          __floats2bfloat162_rn(acc[t][2 * i], acc[t][2 * i + 1]);
  }
}

// backward, dk/dv: grid (H, B, ceil(Tk/64)), one query head's share of
// its kv head's gradients; the query blocks innermost, each taken in two
// chunks of kQc = 32 queries.  At rep = 1 (`dk_part` null) the share is
// the gradient and is stored in bf16 to dk, dv (B, Tk, H_kv, D); at rep >
// 1 it is stored in fp32 to dk_part, dv_part (B, Tk, H, D), which
// `rep_sum_kernel` adds up
template <int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, float* __restrict__ dk_part,
               float* __restrict__ dv_part, int tq, int tk, int h, int hkv,
               int causal, float scale) {
  constexpr int kT = tile_bytes(D);
  constexpr int kQc = 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sk = smem_u32(smem), sv = sk + kT, sq = sv + kT,
                 sdo = sq + 2 * kT;
  // [2][lse 64 | delta 64] fp32 rows of the query tiles
  const float* rows = reinterpret_cast<const float*>(smem + 6 * kT);
  const uint32_t srows = sk + 6 * kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 4;            // key row, and row + 8
  const int hh = blockIdx.x, b = blockIdx.y, kvh = hh / (h / hkv);
  const int k0 = blockIdx.z * kRows;
  const long long qs = static_cast<long long>(h) * D;
  const long long ks = static_cast<long long>(hkv) * D;
  const long long roff = (static_cast<long long>(b) * h + hh) * tq;
  const bf16* qh = head(q, b, tq, h, hh, D);
  const bf16* doh = head(dout, b, tq, h, hh, D);
  const int n_q = (tq + kRows - 1) / kRows;
  // causal: query blocks wholly above this key block see none of it
  const int i0 = causal ? k0 / kRows : 0;
  auto load_q = [&](int i, uint32_t buf) {
    load_tile<D>(sq + buf * kT, qh, qs, i * kRows, tq);
    load_tile<D>(sdo + buf * kT, doh, qs, i * kRows, tq);
    // one lse (threads 0-63) or delta (64-127) value a thread, zero past Tq
    const int qpos = i * kRows + threadIdx.x % kRows;
    const bool ok = qpos < tq;
    cp_async4(srows + buf * 512 + threadIdx.x * 4,
              (threadIdx.x < kRows ? lse : delta) + roff + (ok ? qpos : 0),
              ok ? 4 : 0);
  };
  load_tile<D>(sk, head(k, b, tk, hkv, kvh, D), ks, k0, tk);
  load_tile<D>(sv, head(v, b, tk, hkv, kvh, D), ks, k0, tk);
  if (i0 < n_q) load_q(i0, 0);
  cp_async_commit();
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int i = i0; i < n_q; ++i) {
    cp_async_wait_all();
    __syncthreads();              // tile i landed; tile i - 1 is read
    if (i + 1 < n_q) {
      load_q(i + 1, (i + 1 - i0) & 1);
      cp_async_commit();
    }
    const uint32_t buf = (i - i0) & 1;
    const uint32_t qt = sq + buf * kT, dot = sdo + buf * kT;
    const float* rl = rows + buf * 128;
    const float* rd = rl + 64;
    const int q0 = i * kRows;
    // keys past Tk are not stored, so only the diagonal and queries past
    // Tq are masked
    const bool edge = (causal && q0 < k0 + kRows - 1) || q0 + kRows > tq;
    // two chunks in turn at D = 128: unrolled, their loads interleave and
    // the fp32 dk, dv with them spill
#pragma unroll(D > 64 ? 1 : kRows / kQc)
    for (int c0 = 0; c0 < kRows; c0 += kQc) {
      // s^T = k q^T and dp^T = v do^T: rows = keys, columns = queries
      float s[kQc / 8][4], dp[kQc / 8][4];
      zero(s);
      zero(dp);
      gemm_abt<D, kQc / 8>(s, sk, warp * 16, qt, c0);
      gemm_abt<D, kQc / 8>(dp, sv, warp * 16, dot, c0);
      uint32_t pf[kQc / 16][4], dsf[kQc / 16][4];
#pragma unroll
      for (int t = 0; t < kQc / 8; ++t) {
        const int col = c0 + frag_col(t, 0);
        const float2 l2 = *reinterpret_cast<const float2*>(rl + col);
        const float2 d2 = *reinterpret_cast<const float2*>(rd + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = q0 + col + (e & 1);
          p_ds(s[t][e], dp[t][e], e & 1 ? l2.y : l2.x, e & 1 ? d2.y : d2.x,
               edge && (qp >= tq ||
                        (causal && k0 + row + (e >> 1) * 8 > qp)),
               scale);
        }
        pf[t / 2][(t & 1) * 2] = pack_bf16(s[t][0], s[t][1]);
        pf[t / 2][(t & 1) * 2 + 1] = pack_bf16(s[t][2], s[t][3]);
        dsf[t / 2][(t & 1) * 2] = pack_bf16(dp[t][0], dp[t][1]);
        dsf[t / 2][(t & 1) * 2 + 1] = pack_bf16(dp[t][2], dp[t][3]);
      }
      gemm_reg_b<D, kQc / 16>(dv_acc, pf, dot, c0);
      gemm_reg_b<D, kQc / 16>(dk_acc, dsf, qt, c0);
    }
  }
  cp_async_wait_all();            // a causal key block past Tq loads k, v only
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = k0 + row + i * 8;
    if (kpos >= tk) continue;
    const long long r = static_cast<long long>(b) * tk + kpos;
    if (dk_part) {
      const long long at = (r * h + hh) * D;
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        *reinterpret_cast<float2*>(dk_part + at + frag_col(t, 0)) =
            make_float2(dk_acc[t][2 * i], dk_acc[t][2 * i + 1]);
        *reinterpret_cast<float2*>(dv_part + at + frag_col(t, 0)) =
            make_float2(dv_acc[t][2 * i], dv_acc[t][2 * i + 1]);
      }
    } else {
      const long long at = (r * hkv + kvh) * D;
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + frag_col(t, 0)) =
            __floats2bfloat162_rn(dk_acc[t][2 * i], dk_acc[t][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + frag_col(t, 0)) =
            __floats2bfloat162_rn(dv_acc[t][2 * i], dv_acc[t][2 * i + 1]);
      }
    }
  }
}

// dk, dv (B, Tk, H_kv, D) bf16 = the fp32 sums over r = 0 .. rep - 1, in
// that order, of the shares (B, Tk, H, D) at head kvh * rep + r, rounded
// once: four elements of one row a thread; `rows` = B * Tk * H_kv
__global__ void rep_sum_kernel(const float4* __restrict__ dk_part,
                               const float4* __restrict__ dv_part,
                               uint2* __restrict__ dk, uint2* __restrict__ dv,
                               long long rows, int rep, int d4) {
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
  dk[i] = make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
  dv[i] = make_uint2(pack_bf16(c.x, c.y), pack_bf16(c.z, c.w));
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

// (H, B, row blocks of t): the head fastest, so that the rep query heads
// of a kv head run side by side
dim3 grid_of(Shape n, int t) {
  return dim3(n.h, n.b, (t + kRows - 1) / kRows);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse,
        Shape n, cudaStream_t s) {
  const cudaError_t e = allow_smem(fwd_kernel<D>, fwd_smem(D));
  if (e != cudaSuccess) return int(e);
  fwd_kernel<D><<<grid_of(n, n.tq), kThreads, fwd_smem(D), s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, n.tq, n.tk,
      n.h, n.hkv, n.causal, n.scale);
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
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
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

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  float *dk_part, *dv_part;
};

template <int D>
int bwd(const BwdArgs& a, Shape n, cudaStream_t s) {
  cudaError_t e = allow_smem(dq_kernel<D>, dq_smem(D));
  if (e == cudaSuccess) e = allow_smem(dkv_kernel<D>, dkv_smem(D));
  Side* sd = nullptr;
  if (e == cudaSuccess) e = side_stream(sd);
  if (e == cudaSuccess) e = cudaEventRecord(sd->fork, s);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(sd->stream, sd->fork, 0);
  if (e != cudaSuccess) return int(e);
  const bool grouped = n.h > n.hkv;
  dkv_kernel<D><<<grid_of(n, n.tk), kThreads, dkv_smem(D), sd->stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv,
      grouped ? a.dk_part : nullptr, grouped ? a.dv_part : nullptr, n.tq,
      n.tk, n.h, n.hkv, n.causal, n.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  dq_kernel<D><<<grid_of(n, n.tq), kThreads, dq_smem(D), s>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, n.tq, n.tk, n.h, n.hkv,
      n.causal, n.scale);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaEventRecord(sd->join, sd->stream);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(s, sd->join, 0);
  if (e != cudaSuccess || !grouped) return int(e);
  const long long rows = static_cast<long long>(n.b) * n.tk * n.hkv;
  const int threads = 256;
  rep_sum_kernel<<<static_cast<unsigned>((rows * (D / 4) + threads - 1) /
                                         threads),
                   threads, 0, s>>>(
      reinterpret_cast<const float4*>(a.dk_part),
      reinterpret_cast<const float4*>(a.dv_part),
      reinterpret_cast<uint2*>(a.dk), reinterpret_cast<uint2*>(a.dv), rows,
      n.h / n.hkv, D / 4);
  return int(cudaGetLastError());
}

// what the kernels take: head_dim 32, 64 or 128, H_kv | H, nonempty, and
// the grid's limits (B and the row blocks at most 65535)
bool valid(Shape n, int d) {
  return (d == 32 || d == 64 || d == 128) && n.b > 0 && n.b <= 65535 &&
         n.hkv > 0 && n.h >= n.hkv && n.h % n.hkv == 0 && n.tq > 0 &&
         n.tk > 0 && (n.tq + kRows - 1) / kRows <= 65535 &&
         (n.tk + kRows - 1) / kRows <= 65535;
}

}  // namespace

// forward: out (B, Tq, H, D) bf16 and lse (B, H, Tq) fp32 from bf16 q
// (B, Tq, H, D) and k, v (B, Tk, H_kv, D), all contiguous and 16-byte
// aligned; head_dim 32, 64 or 128.  Returns the cudaError of the launch
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_tc_fwd_launch(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int b, int tq, int tk, int h, int hkv,
                                   int d, int causal, float scale,
                                   void* stream) {
  const Shape n{b, tq, tk, h, hkv, causal, scale};
  if (!valid(n, d)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (d == 32) return fwd<32>(q, k, v, out, l, n, s);
  if (d == 64) return fwd<64>(q, k, v, out, l, n, s);
  return fwd<128>(q, k, v, out, l, n, s);
}

// backward: dq (B, Tq, H, D), dk and dv (B, Tk, H_kv, D) bf16 from the
// forward's inputs, the output gradient dout, lse and delta (B, H, Tq)
// fp32.  At H > H_kv, dk_part and dv_part are (B, Tk, H, D) fp32 scratch
// for the per-query-head shares (unused, and may be null, at H = H_kv).
extern "C" int flash_tc_bwd_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv,
                                   void* dk_part, void* dv_part, int b,
                                   int tq, int tk, int h, int hkv, int d,
                                   int causal, float scale, void* stream) {
  const Shape n{b, tq, tk, h, hkv, causal, scale};
  if (!valid(n, d) || (h > hkv && (!dk_part || !dv_part)))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a{static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v),
                  static_cast<const bf16*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<bf16*>(dq),
                  static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv),
                  static_cast<float*>(dk_part),
                  static_cast<float*>(dv_part)};
  if (d == 32) return bwd<32>(a, n, s);
  if (d == 64) return bwd<64>(a, n, s);
  return bwd<128>(a, n, s);
}

// dynamic shared memory of one CTA: kernel 0 forward, 1 dq, 2 dk/dv
extern "C" int flash_tc_smem_bytes(int kernel, int d) {
  return kernel == 0 ? fwd_smem(d) : kernel == 1 ? dq_smem(d) : dkv_smem(d);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
