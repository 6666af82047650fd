// Fused paged-KV decode attention over bit-packed eXmY pages (K12).
//
// Replaces the TPU kernel cpd_tpu/ops/serve_attn.py:47
// `fused_gather_attention` (Pallas body `_fused_kernel`, :90).  One call
// per layer and decode step computes both of its outputs:
//   * attn (S, 1, H, D) fp32: for each slot, the page rows named by
//     page_rows[s] (ids clamped into the pool) are gathered, decoded from
//     their eXmY code words (per-tensor, or blocked with a shift sidecar
//     per row), zeroed past last_pos[s], masked causally (key_pos <=
//     q_pos, fill -1e30) and reduced with an fp32 softmax, scale
//     1/sqrt(D), GQA rep = H / H_kv;
//   * dig (S, max_pages) int64 holding uint32: the Fletcher-65521 digest
//     of EVERY gathered page over all its bytes as read, trash padding and
//     pages past the query included (cpd_tpu/parallel/integrity.py
//     wire_digest; the weight of byte i is i % 65521 + 1).
//
// What bounds it.  Bytes: the distinct gathered pages, read once.  At the
// serving slice (S = 8, 32 pages of 4096 bytes per slot, GQA 8:2, D = 64,
// e4m3) that is ~1 MB, 0.3 us at 3.35 TB/s; the attention's ~0.5 MFLOP
// are nothing beside it.  In practice a call is bound by launch latency
// and by the longest dependent chain inside one CTA.
//
// The design that was replaced (kept below as `serial_kernel`, the
// yardstick; nothing on the serving path launches it): one CTA per
// (slot, kv head), 16 CTAs on 132 SMs at the slice, each walking its
// slot's pages in order with keys one at a time per warp (a shuffle sum
// and two expf on a serial (m, l) chain per key), and S * max_pages more
// CTAs that read every page a second time for the digests.
//
// Design: split-K over pages, one read of each page.
//   * split_kernel: one CTA per (slot, page, part of the page): a page
//     whole where its staging fits `kUnitBudget` bytes of shared memory,
//     else its positions cut into equal parts.  256 CTAs at the slice,
//     each covering ALL kv heads of its page.  The CTA copies its part's
//     K and V bytes into shared memory once, with 16-byte loads where the
//     range is 16-byte aligned, and folds the Fletcher sums of the bytes
//     as they pass through registers (the weight from the byte's offset
//     in the page; one modulo per 16 bytes, none per byte).  A part with
//     no key at or before the query position (q_pos >= 0) only digests.
//     The others decode their live keys per kv head into fp32 tiles (a
//     256-entry table built at block start by `unpack_code` for one-byte
//     code words, the arithmetic `unpack_code` for wider ones, the raw
//     bits at (8,23); the blocked sidecar's `unscale_flush` after either;
//     __fmul_rn, so bitwise the plain version's values; zero past
//     last_pos by a select), and for each query head compute a partial
//     softmax (m, l, acc[D]) over the part's keys with keys spread over
//     the threads: one thread per (head, key) logit, a warp per head's
//     max and sum, one thread per (head, d) output.  Partials go to an
//     fp32 scratch (S, H, parts, D + 2) and the digest sums to a uint32
//     scratch (S, max_pages, parts of a page, 2).
//   * combine_kernel: one CTA per (slot, query head) merges the partials
//     of the slot's live parts: the largest m, then each part's weight
//     exp(m_u - m) staged in shared memory, acc summed over the parts IN
//     PART ORDER by the thread that owns its element, l by a fixed
//     reduction tree, then acc / l; further CTAs sum each page's digest
//     parts and write the int64 digests.  The fixed orders, and no float
//     atomics anywhere, make the kernel bitwise repeatable from launch to
//     launch.  Parts past the query are never read, so no part's empty
//     (m, l) = (-inf, 0) can turn exp(-inf - (-inf)) into NaN.  With
//     q_pos < 0 every key is masked: every logit is -1e30, every part is
//     live and contributes l = its key count, which gives the plain
//     version's uniform weights over all t_cap keys.
// The attention sums run in another order than the plain version's, so
// `attn` agrees with it to fp32 round-off, not bitwise; the digests are
// integer sums and bitwise.  The kernels allocate nothing: the wrapper
// allocates the outputs and both scratch tensors.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t kDigestMod = 65521;
constexpr float kNegInf = -1e30f;      // the mask fill of the plain version
constexpr int kThreads = 256;          // split_kernel's CTA
constexpr int kCombineThreads = 128;   // combine_kernel's CTA
constexpr int kCombineChunk = 1024;    // parts whose weights it stages
constexpr int kMaxChunks = 8;          // serial_kernel: head_dim <= 32 x 8

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// exact 2^e for e in [-126, 127], by bit assembly
__device__ __forceinline__ float pow2i(int e) {
  return __int_as_float((e + 127) << 23);
}

// numerics.unpack_code: code word -> the fp32 the cast produced
__device__ float unpack_code(uint32_t code, int eb, int mb) {
  if (eb == 8 && mb == 23) return __uint_as_float(code);
  const int bias = (1 << (eb - 1)) - 1;
  const int ones = (1 << eb) - 1;
  const bool neg = ((code >> (eb + mb)) & 1u) != 0;
  const int ef = int((code >> mb) & uint32_t(ones));
  const int mf = int(code & ((1u << mb) - 1u));
  const bool special = ef == ones;
  const bool sub = ef == 0;
  int mant = sub ? mf : (mf | (1 << mb));
  int e = (sub ? 1 : ef) - bias - mb;
  if (special && mf == 1) {  // the carry value 2^(e_max + 1)
    mant = 1;
    e = ones - bias;
  }
  const int a = clampi(e, -126, 127);
  const int b = clampi(e - a, -126, 127);
  float mag = __fmul_rn(__fmul_rn(float(mant), pow2i(a)), pow2i(b));
  if (special && mf == 0) mag = __int_as_float(0x7f800000);
  const float val = neg ? -mag : mag;
  return (special && mf >= 2) ? __int_as_float(0x7fc00000) : val;
}

// numerics._flush_low: zero exponent field -> +0.0
__device__ __forceinline__ float flush_low(float x) {
  return ((__float_as_uint(x) >> 23) & 0xFFu) == 0 ? 0.0f : x;
}

// numerics._unscale_flush: q * 2^k, would-be subnormals flushed to +0.0
__device__ float unscale_flush(float q, int k) {
  int e = 0;
  frexpf(q, &e);
  const bool flush = isfinite(q) && q != 0.0f && (e + k <= -126);
  const int a = clampi(k, -126, 127);
  const float scaled =
      __fmul_rn(__fmul_rn(q, pow2i(a)), pow2i(clampi(k - a, -126, 126)));
  return flush_low(flush ? 0.0f : scaled);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ---------------------------------------------------------------------
// The split-K kernel and its combine.

// lanes that share one logit's dot product in split_kernel
constexpr int kDotLanes = 4;

struct SplitParams {
  const uint8_t* pool;       // (n_pages, 2, page, row_bytes)
  const float* q;            // (S, H, D)
  const int* page_rows;      // (S, MP)
  const int* positions;      // (S,)
  const int* last_pos;       // (S,)
  float* part;               // (S, H, MP * n_split, D + 2): m, l, acc[D]
  uint32_t* dpart;           // (S, MP, n_split, 2): s1, s2 mod 65521
  float* out;                // (S, H, D)
  long long* dig;            // (S, MP)
  int S, MP, n_pages, page, hkv, rep, D;
  int row_bytes;             // bytes of one K or V row of one position
  int wb;                    // bytes per code word
  int exp_bits, man_bits;
  int block;                 // blocked codec block size; 0 = per-tensor
  int unit;                  // positions of a part (a page's last: fewer)
  int n_split;               // parts of a page
  int heads;                 // query heads of one pass (<= rep)
  int q_rows;                // query rows staged: H (all, once) or heads
  float scale;               // 1/sqrt(D) in fp32
};

// shared memory of one split_kernel CTA, in bytes: the decode table, the
// part's K and V bytes, one kv head's decoded K and V tiles [unit][D + 1],
// the staged query rows and one pass's logits [heads][unit]
__host__ __device__ inline size_t raw_bytes(int unit, int row_bytes) {
  return (size_t(2) * unit * row_bytes + 15) / 16 * 16;
}
__host__ __device__ inline size_t split_smem(int unit, int row_bytes, int D,
                                             int heads, int q_rows) {
  return 256 * sizeof(float) + raw_bytes(unit, row_bytes) +
         sizeof(float) * (size_t(2) * unit * (D + 1) + size_t(q_rows) * D +
                          size_t(heads) * unit);
}

// the Fletcher terms of the 16 bytes of `v`, the first at page offset
// `off`: s1 += w, s2 += w * (offset % 65521 + 1)
__device__ __forceinline__ void fold16(const uint4 v, uint32_t off,
                                       uint32_t& s1,
                                       unsigned long long& s2) {
  const uint32_t b = off < kDigestMod ? off : off % kDigestMod;
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  uint32_t a1 = 0, a2 = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t w = (words[k >> 2] >> (8 * (k & 3))) & 0xFFu;
    const uint32_t wt = b + k + 1;          // <= 65536
    a1 += w;
    a2 += w * (wt > kDigestMod ? wt - kDigestMod : wt);   // < 2^24
  }
  s1 += a1;
  s2 += a2;
}

// the `len` bytes at offset `off` of the page at `page`: copied to `dst`
// and folded into (s1, s2); 16-byte loads where source, destination and
// length allow, else one byte a thread
__device__ void stage(const uint8_t* page, uint32_t off, int len,
                      uint8_t* dst, uint32_t& s1, unsigned long long& s2) {
  const uint8_t* src = page + off;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
        uintptr_t(len)) & 15u) == 0) {
    for (int c = threadIdx.x * 16; c < len; c += kThreads * 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + c));
      *reinterpret_cast<uint4*>(dst + c) = v;
      fold16(v, off + c, s1, s2);
    }
  } else {
    for (int c = threadIdx.x; c < len; c += kThreads) {
      const uint32_t w = src[c];
      const uint32_t i = off + c;
      dst[c] = uint8_t(w);
      s1 += w;
      s2 += w * ((i < kDigestMod ? i : i % kDigestMod) + 1u);
    }
  }
}

// element e (= kv_head * D + d) of one K or V row staged in shared memory
__device__ __forceinline__ float decode_at(const uint8_t* row, int e,
                                           const SplitParams& p,
                                           const float* lut) {
  float v;
  if (p.wb == 1) {
    v = lut[row[e]];
  } else {
    const uint8_t* w = row + size_t(e) * p.wb;
    uint32_t code = 0;
    for (int b = 0; b < p.wb; ++b) code |= uint32_t(w[b]) << (8 * b);
    v = unpack_code(code, p.exp_bits, p.man_bits);
  }
  if (p.block > 0)
    v = unscale_flush(
        v, int(row[size_t(p.hkv) * p.D * p.wb + e / p.block]) - 128);
  return v;
}

// the query position's last key: q_pos < 0 masks every key, and then all
// t_cap keys weigh alike
__device__ __forceinline__ int last_key(int qpos, int t_cap) {
  return qpos >= 0 ? min(qpos, t_cap - 1) : t_cap - 1;
}

// one CTA per (slot, page, part of the page)
__global__ void __launch_bounds__(kThreads) split_kernel(SplitParams p) {
  extern __shared__ __align__(16) unsigned char staged[];
  __shared__ unsigned long long red[2][kThreads / 32];
  const int H = p.hkv * p.rep, D = p.D, ld = D + 1;
  float* lut = reinterpret_cast<float*>(staged);
  uint8_t* kraw = staged + 256 * sizeof(float);
  const size_t rb = p.row_bytes;
  uint8_t* vraw = kraw + p.unit * rb;
  float* kdec = reinterpret_cast<float*>(kraw + raw_bytes(p.unit, p.row_bytes));
  float* vdec = kdec + p.unit * ld;
  float* qs = vdec + p.unit * ld;
  float* lg = qs + p.q_rows * D;

  const int parts = p.MP * p.n_split;    // parts of a slot
  const int s = blockIdx.x / parts, u = blockIdx.x % parts;
  const int pg = u / p.n_split, j0 = (u % p.n_split) * p.unit;
  const int np = min(p.unit, p.page - j0);
  const int t0 = pg * p.page + j0;
  const int qpos = p.positions[s], last = p.last_pos[s];
  const int nk = clampi(last_key(qpos, p.MP * p.page) - t0 + 1, 0, np);
  const int pid = clampi(p.page_rows[s * p.MP + pg], 0, p.n_pages - 1);
  const size_t plane = size_t(p.page) * rb;
  const uint8_t* page = p.pool + 2 * plane * pid;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (nk > 0) {
    if (p.wb == 1)
      for (int c = tid; c < 256; c += kThreads)
        lut[c] = unpack_code(uint32_t(c), p.exp_bits, p.man_bits);
    if (p.q_rows == H)
      for (int i = tid; i < H * D; i += kThreads)
        qs[i] = p.q[size_t(s) * H * D + i];
  }
  // the part's bytes, read once: staged for the decode and digested
  uint32_t s1 = 0;
  unsigned long long s2 = 0;
  const int len = np * p.row_bytes;
  const uint32_t off = uint32_t(j0) * p.row_bytes;
  stage(page, off, len, kraw, s1, s2);
  stage(page, uint32_t(plane) + off, len, vraw, s1, s2);
  unsigned long long a = warp_sum(static_cast<unsigned long long>(s1));
  unsigned long long b = warp_sum(s2);
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();     // the staged bytes, the table and q are in place
  if (tid == 0) {
    a = b = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
    uint32_t* dp = p.dpart + 2 * (size_t(s * p.MP + pg) * p.n_split +
                                  u % p.n_split);
    dp[0] = uint32_t(a % kDigestMod);
    dp[1] = uint32_t(b % kDigestMod);
  }
  if (nk == 0) return;    // past the query: digest only

  // head h's partial of this part at part_h + h * stride
  float* part_h = p.part + (size_t(s) * H * parts + u) * (D + 2);
  const size_t stride = size_t(parts) * (D + 2);
  for (int g = 0; g < p.hkv; ++g) {
    // kv head g's live K and V rows, zero past the newest live position
    for (int i = tid; i < 2 * nk * D; i += kThreads) {
      const bool v_plane = i >= nk * D;
      const int r = v_plane ? i - nk * D : i;
      const int j = r / D, d = r % D;
      const float x =
          t0 + j <= last
              ? decode_at((v_plane ? vraw : kraw) + j * rb, g * D + d, p, lut)
              : 0.0f;
      (v_plane ? vdec : kdec)[j * ld + d] = x;
    }
    for (int r0 = 0; r0 < p.rep; r0 += p.heads) {
      const int nr = min(p.heads, p.rep - r0), h0 = g * p.rep + r0;
      if (p.q_rows != H)
        for (int i = tid; i < nr * D; i += kThreads)
          qs[i] = p.q[(size_t(s) * H + h0) * D + i];
      const float* qp = qs + (p.q_rows == H ? h0 : 0) * D;
      __syncthreads();   // tiles and query rows in place
      // logits: kDotLanes lanes per (head, key), every warp a whole
      // number of groups, the same trip count on every thread
      const int n_dot = nr * nk * kDotLanes;
      for (int i0 = 0; i0 < n_dot; i0 += kThreads) {
        const int i = i0 + tid, pair = i / kDotLanes, sub = i % kDotLanes;
        const int r = pair / nk, j = pair % nk;
        float dot = 0.0f;
        if (i < n_dot && qpos >= 0)
          for (int d = sub; d < D; d += kDotLanes)
            dot = fmaf(qp[r * D + d], kdec[j * ld + d], dot);
        for (int o = kDotLanes / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (i < n_dot && sub == 0)
          lg[r * p.unit + j] = qpos >= 0 ? dot * p.scale : kNegInf;
      }
      __syncthreads();
      // the part's softmax of each head: a warp a head
      for (int r = warp; r < nr; r += kThreads / 32) {
        float* lr = lg + r * p.unit;
        float m = -INFINITY;
        for (int j = lane; j < nk; j += 32) m = fmaxf(m, lr[j]);
        m = warp_max(m);
        float l = 0.0f;
        for (int j = lane; j < nk; j += 32) {
          const float e = expf(lr[j] - m);
          lr[j] = e;
          l += e;
        }
        l = warp_sum(l);
        if (lane == 0) {
          part_h[(h0 + r) * stride] = m;
          part_h[(h0 + r) * stride + 1] = l;
        }
      }
      __syncthreads();
      for (int i = tid; i < nr * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const float* pr = lg + r * p.unit;
        float acc = 0.0f;
        for (int j = 0; j < nk; ++j) acc = fmaf(pr[j], vdec[j * ld + d], acc);
        part_h[(h0 + r) * stride + 2 + d] = acc;
      }
      __syncthreads();   // before the next pass overwrites its inputs
    }
  }
}

// `x` reduced over the CTA by `op` in a fixed order (lanes by a shuffle
// tree, then warps in order), the same value on every thread
template <class Op>
__device__ float block_reduce(float x, float* red, Op op) {
  for (int o = 16; o > 0; o >>= 1)
    x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < kCombineThreads / 32; ++w) x = op(x, red[w]);
  __syncthreads();   // red is free again
  return x;
}

// CTAs [0, S*H): one per (slot, query head), merging the partials of the
// slot's live parts in part order; then one thread per (slot, page)
// summing the page's digest parts
__global__ void __launch_bounds__(kCombineThreads)
    combine_kernel(SplitParams p) {
  __shared__ float wsm[kCombineChunk];   // the weights of a chunk of parts
  __shared__ float red[kCombineThreads / 32];
  const int H = p.hkv * p.rep, D = p.D, parts = p.MP * p.n_split;
  const int n_attn = p.S * H, tid = threadIdx.x;
  if (int(blockIdx.x) >= n_attn) {
    const int i = (blockIdx.x - n_attn) * kCombineThreads + tid;
    if (i >= p.S * p.MP) return;
    const uint32_t* dp = p.dpart + size_t(i) * p.n_split * 2;
    unsigned long long a = 0, b = 0;
    for (int k = 0; k < p.n_split; ++k) {
      a += dp[2 * k];
      b += dp[2 * k + 1];
    }
    p.dig[i] = static_cast<long long>(((b % kDigestMod) << 16) |
                                      (a % kDigestMod));
    return;
  }
  const int s = blockIdx.x / H, h = blockIdx.x % H;
  const int kend = last_key(p.positions[s], p.MP * p.page);
  // the parts at or before the last key: a prefix in part order
  const int live = (kend / p.page) * p.n_split + (kend % p.page) / p.unit + 1;
  const float* pt = p.part + (size_t(s) * H + h) * parts * (D + 2);
  float* out = p.out + (size_t(s) * H + h) * D;
  float m = -INFINITY;
  for (int u = tid; u < live; u += kCombineThreads)
    m = fmaxf(m, pt[size_t(u) * (D + 2)]);
  m = block_reduce(m, red, [](float a, float b) { return fmaxf(a, b); });
  // l: this thread's share of sum_u exp(m_u - m) l_u; out holds the
  // unnormalised sums over the chunks so far, each element one thread's
  float l = 0.0f;
  for (int c0 = 0; c0 < live; c0 += kCombineChunk) {
    const int nc = min(kCombineChunk, live - c0);
    for (int u = tid; u < nc; u += kCombineThreads) {
      const float* x = pt + size_t(c0 + u) * (D + 2);
      const float w = expf(x[0] - m);
      wsm[u] = w;
      l += w * x[1];
    }
    __syncthreads();
    for (int d = tid; d < D; d += kCombineThreads) {
      const float* x = pt + size_t(c0) * (D + 2) + 2 + d;
      float acc = c0 == 0 ? 0.0f : out[d];
#pragma unroll 8
      for (int u = 0; u < nc; ++u)
        acc = fmaf(wsm[u], x[size_t(u) * (D + 2)], acc);
      out[d] = acc;
    }
    __syncthreads();   // the chunk's weights are consumed
  }
  l = block_reduce(l, red, [](float a, float b) { return a + b; });
  for (int d = tid; d < D; d += kCombineThreads) out[d] = out[d] / l;
}

// ---------------------------------------------------------------------
// The serial kernel, K12's yardstick: one CTA per (slot, kv head) walking
// the slot's pages in order, and one per gathered page for its digest.

// the serial kernel's arguments
struct SerialParams {
  const uint8_t* pool;       // (n_pages, 2, page, row_bytes)
  const float* q;            // (S, H, D)
  const int* page_rows;      // (S, MP)
  const int* positions;      // (S,)
  const int* last_pos;       // (S,)
  float* out;                // (S, H, D)
  uint32_t* dig;             // (S, MP)
  int S, MP, n_pages, page, hkv, rep, D;
  int row_bytes;             // bytes of one K or V row of one position
  int wb;                    // bytes per code word
  int exp_bits, man_bits;
  int block;                 // blocked codec block size; 0 = per-tensor
};

// element `e` (= kv_head * D + d) of one stored K or V row
__device__ float serial_decode_elem(const uint8_t* row, int e,
                                    const SerialParams& p) {
  const uint8_t* w = row + size_t(e) * p.wb;
  uint32_t code = 0;
  for (int b = 0; b < p.wb; ++b) code |= uint32_t(w[b]) << (8 * b);
  float v = unpack_code(code, p.exp_bits, p.man_bits);
  if (p.block > 0) {
    const int n = p.hkv * p.D;
    v = unscale_flush(v, int(row[size_t(n) * p.wb + e / p.block]) - 128);
  }
  return v;
}

__device__ void serial_digest_page(const SerialParams& p, int idx) {
  __shared__ unsigned long long red[2][32];
  const int s = idx / p.MP;
  const int pid = clampi(p.page_rows[s * p.MP + idx % p.MP], 0, p.n_pages - 1);
  const uint32_t page_bytes = 2u * uint32_t(p.page) * uint32_t(p.row_bytes);
  const uint8_t* base = p.pool + size_t(pid) * page_bytes;
  unsigned long long s1 = 0, s2 = 0;
  for (uint32_t i = threadIdx.x; i < page_bytes; i += blockDim.x) {
    const uint32_t w = base[i];
    s1 += w;
    s2 += (unsigned long long)(w * (i % kDigestMod + 1u));  // < 2^24
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / 32;
    s1 = lane < nw ? red[0][lane] : 0ull;
    s2 = lane < nw ? red[1][lane] : 0ull;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0)
      p.dig[idx] = uint32_t((s2 % kDigestMod) << 16) | uint32_t(s1 % kDigestMod);
  }
}

__device__ void serial_attend(const SerialParams& p, float* smem) {
  const int s = blockIdx.x / p.hkv, g = blockIdx.x % p.hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = p.hkv * p.rep, D = p.D;
  const int qpos = p.positions[s], last = p.last_pos[s];
  const int tcap = p.MP * p.page;
  // keys past qpos are masked to -1e30 and weigh exactly 0 next to any
  // unmasked key; only when every key is masked (qpos < 0) do they count
  const int kend = qpos >= 0 ? min(qpos, tcap - 1) : tcap - 1;
  const float scale = 1.0f / sqrtf(float(D));
  const size_t page_bytes = size_t(2) * p.page * p.row_bytes;
  float* ks = smem;
  float* vs = smem + p.page * D;
  const bool has_q = warp < p.rep;
  const int head = g * p.rep + warp;

  float qr[kMaxChunks], acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int d = lane + 32 * c;
    qr[c] = (has_q && d < D) ? p.q[(size_t(s) * H + head) * D + d] : 0.0f;
    acc[c] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  const int n_walk = kend / p.page + 1;
  for (int pg = 0; pg < n_walk; ++pg) {
    const int pid = clampi(p.page_rows[s * p.MP + pg], 0, p.n_pages - 1);
    const uint8_t* base = p.pool + size_t(pid) * page_bytes;
    __syncthreads();  // the previous page's tiles are consumed
    for (int i = threadIdx.x; i < 2 * p.page * D; i += blockDim.x) {
      const int plane = i / (p.page * D);
      const int j = (i / D) % p.page;
      const int d = i % D;
      float val = 0.0f;  // zero K/V past the newest live position
      if (pg * p.page + j <= last) {
        const uint8_t* row = base + size_t(plane * p.page + j) * p.row_bytes;
        val = serial_decode_elem(row, g * D + d, p);
      }
      (plane ? vs : ks)[j * D + d] = val;
    }
    __syncthreads();
    if (!has_q) continue;
    const int jn = min(p.page, kend - pg * p.page + 1);
    for (int j = 0; j < jn; ++j) {
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < D) part += qr[c] * ks[j * D + d];
      }
      part = warp_sum(part);
      const float logit = (pg * p.page + j <= qpos) ? part * scale : kNegInf;
      const float m_new = fmaxf(m, logit);
      const float corr = expf(m - m_new);
      const float w = expf(logit - m_new);
      l = l * corr + w;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc[c] = acc[c] * corr + w * vs[j * D + d];
      }
      m = m_new;
    }
  }
  if (!has_q) return;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int d = lane + 32 * c;
    if (d < D) p.out[(size_t(s) * H + head) * D + d] = acc[c] / l;
  }
}

__global__ void serial_kernel(SerialParams p) {
  extern __shared__ float smem[];  // K tile then V tile: 2 x page x D fp32
  const int n_attn = p.S * p.hkv;
  if (int(blockIdx.x) < n_attn)
    serial_attend(p, smem);
  else
    serial_digest_page(p, blockIdx.x - n_attn);
}

}  // namespace

// K12: attn (S, H, D) fp32 and dig (S, MP) int64 from one layer's pool
// (n_pages, 2, page, row_bytes) uint8, q (S, H, D) fp32, page_rows (S, MP)
// and positions, last_pos (S,) int32, all contiguous.  part (S, H,
// MP * n_split, D + 2) fp32 and dpart (S, MP, n_split, 2) uint32 are
// scratch, n_split = ceil(page / unit).  `unit` positions of a page per
// CTA, `heads` query heads per pass, `q_rows` query rows staged (H or
// heads); the CTA's shared memory must fit 227 KB.  Returns the cudaError
// of the launches (cudaErrorInvalidValue for arguments it does not take).
extern "C" int serve_attn_launch(
    const void* pool, const void* q, const void* page_rows,
    const void* positions, const void* last_pos, void* out, void* dig,
    void* part, void* dpart, int S, int MP, int n_pages, int page, int hkv,
    int rep, int D, int row_bytes, int wb, int exp_bits, int man_bits,
    int block, int unit, int heads, int q_rows, float scale, void* stream) {
  const int H = hkv * rep;
  if (S < 1 || MP < 1 || n_pages < 1 || hkv < 1 || rep < 1 || D < 1 ||
      unit < 1 || unit > page || heads < 1 || heads > rep ||
      (q_rows != H && q_rows != heads))
    return int(cudaErrorInvalidValue);
  const size_t smem = split_smem(unit, row_bytes, D, heads, q_rows);
  if (smem + sizeof(unsigned long long) * 2 * (kThreads / 32) > 232448)
    return int(cudaErrorInvalidValue);
  SplitParams p;
  p.pool = static_cast<const uint8_t*>(pool);
  p.q = static_cast<const float*>(q);
  p.page_rows = static_cast<const int*>(page_rows);
  p.positions = static_cast<const int*>(positions);
  p.last_pos = static_cast<const int*>(last_pos);
  p.part = static_cast<float*>(part);
  p.dpart = static_cast<uint32_t*>(dpart);
  p.out = static_cast<float*>(out);
  p.dig = static_cast<long long*>(dig);
  p.S = S;
  p.MP = MP;
  p.n_pages = n_pages;
  p.page = page;
  p.hkv = hkv;
  p.rep = rep;
  p.D = D;
  p.row_bytes = row_bytes;
  p.wb = wb;
  p.exp_bits = exp_bits;
  p.man_bits = man_bits;
  p.block = block;
  p.unit = unit;
  p.n_split = (page + unit - 1) / unit;
  p.heads = heads;
  p.q_rows = q_rows;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  split_kernel<<<S * MP * p.n_split, kThreads, smem, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const int digest_ctas = (S * MP + kCombineThreads - 1) / kCombineThreads;
  combine_kernel<<<S * H + digest_ctas, kCombineThreads, 0, st>>>(p);
  return int(cudaGetLastError());
}

// The serial kernel (K12's yardstick, on no path): the same function with
// uint32 digests, for head_dim <= 256, rep <= 16 and 2 * page * D * 4
// bytes of shared memory within 48 KB.
extern "C" int serve_attn_serial_launch(
    const void* pool, const void* q, const void* page_rows,
    const void* positions, const void* last_pos, void* out, void* dig, int S,
    int MP, int n_pages, int page, int hkv, int rep, int D, int row_bytes,
    int wb, int exp_bits, int man_bits, int block, void* stream) {
  SerialParams p;
  p.pool = static_cast<const uint8_t*>(pool);
  p.q = static_cast<const float*>(q);
  p.page_rows = static_cast<const int*>(page_rows);
  p.positions = static_cast<const int*>(positions);
  p.last_pos = static_cast<const int*>(last_pos);
  p.out = static_cast<float*>(out);
  p.dig = static_cast<uint32_t*>(dig);
  p.S = S;
  p.MP = MP;
  p.n_pages = n_pages;
  p.page = page;
  p.hkv = hkv;
  p.rep = rep;
  p.D = D;
  p.row_bytes = row_bytes;
  p.wb = wb;
  p.exp_bits = exp_bits;
  p.man_bits = man_bits;
  p.block = block;
  const int threads = 32 * (rep > 4 ? rep : 4);
  const int blocks = S * hkv + S * MP;
  const size_t smem = size_t(2) * page * D * sizeof(float);
  serial_kernel<<<blocks, threads, smem,
                  static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

extern "C" const char* serve_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
