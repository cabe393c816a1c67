// Blocked online-softmax attention (FlashAttention-2 style) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` /
// `flash_attention_pallas` (repro/kernels/flash_attention.py).  For queries
// q (B, Tq, H, D) and keys/values k, v (B, Tk, KVH, D), given as strided
// views with a contiguous last axis (the head views of the layer's
// projections, so nothing is copied), query head h reading KV head
// h / (H / KVH) (grouped-query attention by index, no repeated heads):
//
//   s[i, j] = (q[i] * scale) . k[j]             fp32
//   key j kept iff j < Tk, and j <= qpos(i) when causal, and
//                  j > qpos(i) - window with a window,
//   qpos(i) = i + Tk - Tq                       (queries end-aligned)
//   out[i]  = sum_j softmax_j(s[i, :]) v[j]      in q's dtype (fp32 or bf16),
//
// with the fp32 running max, sum and output of the online softmax; a query
// with no kept key gives 0 (the TPU kernel's flush, l > 0 ? acc / l : 0).
// Written out (B, Tq, H, D), contiguous, so the caller's merge of the heads
// is free.
//
// What bounds it on the H100: operations.  Per (batch, head) it does
// 4 Tq Tk D flops (QK^T and PV) on 2 (Tq + 2 Tk) D bytes of bf16; at
// hubert's (8, 16, 1000, 80) that is 41 GFLOP against 82 MB: 0.041 ms on the
// 989 TFLOP/s bf16 tensor cores, 0.025 ms for the bytes.
//
// Two kernels, picked by the wrapper: bf16 inputs whose rows start on 16
// bytes run `flash_attention_tc_kernel` on the bf16 tensor cores; fp32 (the
// reference computes in fp32, and TF32 would lose precision) and unaligned
// bf16 views run `flash_attention_kernel` on the CUDA cores.
//
// Tensor cores (bf16): the FlashAttention-2 layout.  A block of 4 warps owns
// (batch*head, a 128-query tile); each warp owns 32 query rows (two m16
// tiles), so every K and V fragment it reads from shared memory feeds two
// mmas, and re-reads its Q fragments from shared memory at each k-step
// (the registers hold the two tiles' scores and outputs: 255 a thread at
// D = 80 by ptxas, 28 bytes spilled, 2 blocks an SM; with 16 rows a warp
// each K or V fragment fed half as many mmas for the same shared-memory
// reads).
//   * Products: `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` for
//     QK^T (D / 16 k-steps, 8 n8 tiles of a 64-key tile) and PV (4 k16 steps
//     over the keys, D / 8 n8 tiles; hubert's D = 80 is 5 k-steps and 10
//     n-tiles).  K fragments come from `ldmatrix` on the [key][d] tile, V
//     fragments from `ldmatrix.trans` on the same layout, so neither is
//     transposed in memory.
//   * Loads: the Q tile and double-buffered K/V tiles through 16-byte
//     `cp.async` copies (zero-filled past Tq and Tk, so a padded key's V is
//     0 and never NaN); the next tile's copies fly while this one
//     multiplies, one barrier a tile.  Rows are padded to 2 D + 16 bytes, an
//     odd number of 16-byte chunks, so every ldmatrix phase reads 8 distinct
//     bank groups.
//   * Scale: applied to the fp32 scores after QK^T (q enters unscaled); the
//     reference scales q in fp32 first, so the two differ in fp32 rounding
//     order only.
//   * P keeps fp32 precision in the second product: the softmax runs on the
//     fp32 scores in registers (C fragments are PV's A fragments), and each
//     probability p is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi)
//     (the difference is exact in fp32); PV runs as two mmas into one fp32
//     accumulator, which represents p to about 2^-16 relative where one bf16
//     P would round it by up to 2^-8 (enough to miss the 2e-5 gate on
//     outputs near 0).  That is 1.5x the flops of a plain bf16 FA2.
//   * Softmax in base 2: p = 2^(s log2e - m log2e), one FMA and one ex2 a
//     score (FlashAttention-2's form); a masked score is -inf and gives 0.
//   * Masks: key tiles wholly outside the causal/window range are skipped;
//     a tile that straddles the mask or Tk masks element by element.  The
//     row sum stays per thread and is reduced across the quad at the end.
//
// CUDA cores (fp32, and bf16 views that are not 16-byte aligned): the TPU
// kernel's grid (B*H, Tq/bq, Tk/bk) walks the key axis sequentially with the
// softmax state in VMEM.  Here one block of 256 threads owns (batch*head, a
// 64-query tile) and loops over 64-key tiles inside the block (tiles wholly
// outside the causal or window range are skipped).  The query tile is
// staged once in shared memory as fp32 (scaled), each key tile transposed
// (d-major) and each value tile as they are converted to fp32.  Thread (ty,
// tx) of a 16 x 16 grid owns query rows ty + 16 i (i < 4): it computes the
// scores of columns tx + 16 j (j < 4) from shared memory, reduces the rows'
// max and sum over its 16 lanes with shuffles, writes its probabilities to
// shared memory and accumulates output columns tx + 16 j (j < D / 16) in
// registers.  Pitches keep every shared-memory access free of bank
// conflicts.  It runs at the 67 TFLOP/s fp32 CUDA-core peak at best (0.61
// ms at hubert's shape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // queries per block
constexpr int BK = 64;                 // keys per tile
constexpr int THREADS = 256;
constexpr int TX = 16;                 // lanes across a row
constexpr int RPT = BQ / (THREADS / TX);  // 4 query rows a thread: ty + 16 i
constexpr int CPT = BK / TX;           // 4 score columns a thread: tx + 16 j
constexpr int KP = BK + 1;             // transposed key tile pitch (conflict-free stores)
constexpr int PP = BK + 16;            // probability tile pitch (two rows a warp, 16 banks apart)

struct Strides {
  long long q[3], k[3], v[3];          // (batch, time, head) strides in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + D * KP + BK * D + BQ * PP);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H, int KVH, int Tq,
                       int Tk, Strides st, float scale, int causal, int window) {
  constexpr int DPT = D / TX;          // output columns a thread
  constexpr int QP = D + 1;            // query tile pitch
  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][QP]  q * scale
  float* kt = qs + BQ * QP;            // [D][KP]   k transposed
  float* vs = kt + D * KP;             // [BK][D]
  float* ps = vs + BK * D;             // [BQ][PP]  probabilities

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.y * BQ;
  const int shift = Tk - Tq;

  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + kvh * st.k[2];
  const T* vb = v + b * st.v[0] + kvh * st.v[2];

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int t = q0 + r;
    qs[r * QP + d] = t < Tq ? __fmul_rn(to_f32(qb[t * st.q[1] + d]), scale) : 0.0f;
  }

  // the keys any live query of this tile may keep
  const int q_first = q0 + shift;
  const int q_last = min(q0 + BQ, Tq) - 1 + shift;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) / BK * BK : 0;

  float m[RPT], l[RPT], o[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -1e30f;  // below every kept score: exp(m - m_new) stays finite
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) o[i][j] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's reads are done (and the query tile staged)
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const int t = k0 + c;
      const bool in = t < Tk;
      kt[d * KP + c] = in ? to_f32(kb[t * st.k[1] + d]) : 0.0f;
      vs[c * D + d] = in ? to_f32(vb[t * st.v[1] + d]) : 0.0f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = kt[d * KP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + 16 * i + shift;
      bool keep[CPT];
      float mt = -1e30f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        keep[j] = kpos < Tk && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
        if (keep[j]) mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off /= 2)  // the row's 16 lanes
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mn);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = keep[j] ? expf(s[i][j] - mn) : 0.0f;
        ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off /= 2)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DPT; ++j) o[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    const float inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
    T* orow = out + ((static_cast<long long>(b) * Tq + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) store(orow + tx + 16 * j, o[i][j] * inv);
  }
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel.

namespace tcf {
constexpr int BQ = 128;       // queries per block: 32 a warp, two m16 tiles
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr float LOG2E = 1.4426950408889634f;
template <int D>
constexpr int PITCH = 2 * D + 16;  // bytes per staged row: an odd number of 16-byte chunks
template <int D>
constexpr int SMEM = PITCH<D> * (BQ + 4 * BKV);  // the Q tile and two (K, V) tiles
}  // namespace tcf

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when `in` is false.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Two probabilities (one A-fragment register) as bf16 pairs: p_hi = bf16(p)
// and p_lo = bf16(p - p_hi).
__device__ __forceinline__ void split_bf16(float p0, float p1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

template <int D>
__global__ void __launch_bounds__(tcf::THREADS)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                          int H, int KVH, int Tq, int Tk, Strides st, float scale, int causal,
                          int window) {
  constexpr int P = tcf::PITCH<D>;
  constexpr int DC = D / 8;   // 16-byte chunks a row
  constexpr int KS = D / 16;  // k16 steps of QK^T
  constexpr int NT = D / 8;   // n8 tiles of PV
  constexpr int BQ = tcf::BQ, BKV = tcf::BKV, NTHR = tcf::THREADS;
  constexpr float L2E = tcf::LOG2E;
  extern __shared__ __align__(16) uint8_t sm[];
  uint8_t* qs = sm;                   // [BQ][P]
  uint8_t* kvs = sm + BQ * P;         // buffer b: K at kvs + 2 b BKV P, V after it

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.y * BQ;
  const int shift = Tk - Tq;

  const __nv_bfloat16* qb = q + b * st.q[0] + h * st.q[2];
  const __nv_bfloat16* kb = k + b * st.k[0] + kvh * st.k[2];
  const __nv_bfloat16* vb = v + b * st.v[0] + kvh * st.v[2];

  for (int e = tid; e < BQ * DC; e += NTHR) {
    const int r = e / DC, c = e % DC;
    const int t = q0 + r;
    cp_async16(smem_u32(qs + r * P + 16 * c), t < Tq ? qb + t * st.q[1] + 8 * c : qb, t < Tq);
  }
  cp_async_commit();

  // the keys any live query of this tile may keep
  const int q_first = q0 + shift;
  const int q_last = min(q0 + BQ, Tq) - 1 + shift;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) / BKV * BKV : 0;

  auto load_kv = [&](int buf, int k0) {
    uint8_t* ks = kvs + 2 * buf * BKV * P;
    uint8_t* vs = ks + BKV * P;
    for (int e = tid; e < BKV * DC; e += NTHR) {
      const int r = e / DC, c = e % DC;
      const int t = k0 + r;
      const bool in = t < Tk;
      cp_async16(smem_u32(ks + r * P + 16 * c), in ? kb + t * st.k[1] + 8 * c : kb, in);
      cp_async16(smem_u32(vs + r * P + 16 * c), in ? vb + t * st.v[1] + 8 * c : vb, in);
    }
  };
  if (k_begin < k_end) load_kv(0, k_begin);
  cp_async_commit();

  // m16 tile mt of the warp holds rows warp * 32 + 16 mt + {g, g + 8}: the
  // running max (m) and this thread's share of the row sum (l) of each
  int qpos[2][2];
  float m[2][2], l[2][2], o[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qpos[mt][i] = q0 + warp * 32 + 16 * mt + g + 8 * i + shift;
      m[mt][i] = -1e30f;  // below every kept score: exp(m - m_new) stays finite
      l[mt][i] = 0.0f;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[mt][t][r] = 0.0f;
  }

  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BKV, buf ^= 1) {
    cp_async_wait<0>();  // this tile's copies (and the Q tile's) have landed
    __syncthreads();     // everyone's have; everyone is done with the other buffer
    if (k0 + BKV < k_end) load_kv(buf ^ 1, k0 + BKV);
    cp_async_commit();
    const uint8_t* ks = kvs + 2 * buf * BKV * P;
    const uint8_t* vs = ks + BKV * P;

    // S = Q K^T: n8 tile t covers keys 8t .. 8t + 7; c0, c1 row g keys 2qd,
    // 2qd + 1, c2, c3 row g + 8
    float sc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[mt][t][r] = 0.0f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      // A: rows (lane & 7) + 8 (matrix & 1) of each m16 tile, chunk 2 s + (matrix >> 1)
      unsigned qa[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = warp * 32 + 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldsm_x4(smem_u32(qs + row * P + 16 * (2 * s + (lane >> 4))), qa[mt]);
      }
#pragma unroll
      for (int tp = 0; tp < 4; ++tp) {
        // matrices: keys 16 tp + {0..7, 0..7, 8..15, 8..15} x chunks {2s, 2s+1, 2s, 2s+1}
        const int key = 16 * tp + (lane & 7) + 8 * (lane >> 4);
        unsigned r[4];
        ldsm_x4(smem_u32(ks + key * P + 16 * (2 * s + ((lane >> 3) & 1))), r);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(sc[mt][2 * tp], qa[mt], r[0], r[1]);
          mma_bf16(sc[mt][2 * tp + 1], qa[mt], r[2], r[3]);
        }
      }
    }

    // masks: only a tile that straddles Tk, the causal edge or the window
    const bool edge = k0 + BKV > Tk || (causal && k0 + BKV - 1 > q_first) ||
                      (window > 0 && k0 <= q_last - window);
    float mnl[2][2];  // the new running max, times log2(e)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float mt_[2] = {-1e30f, -1e30f};
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float x = __fmul_rn(sc[mt][t][r], scale);
          if (edge) {
            const int kpos = k0 + 8 * t + 2 * qd + (r & 1);
            const int qp = qpos[mt][r >> 1];
            const bool keep = kpos < Tk && (!causal || kpos <= qp) &&
                              (window <= 0 || kpos > qp - window);
            if (!keep) x = -INFINITY;
          }
          sc[mt][t][r] = x;
          mt_[r >> 1] = fmaxf(mt_[r >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mt_[i] = fmaxf(mt_[i], __shfl_xor_sync(0xffffffffu, mt_[i], 1));  // the row's quad
        mt_[i] = fmaxf(mt_[i], __shfl_xor_sync(0xffffffffu, mt_[i], 2));
        const float mn = fmaxf(m[mt][i], mt_[i]);
        alpha[i] = exp2f(__fmul_rn(m[mt][i] - mn, L2E));
        m[mt][i] = mn;
        mnl[mt][i] = mn * L2E;
        l[mt][i] *= alpha[i];
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        o[mt][t][0] *= alpha[0];
        o[mt][t][1] *= alpha[0];
        o[mt][t][2] *= alpha[1];
        o[mt][t][3] *= alpha[1];
      }
    }

    // O += P V, one k16 step (keys 16 tp .. 16 tp + 15: score tiles 2 tp and
    // 2 tp + 1) at a time, P split into bf16 hi + lo; p = 2^(s log2e - m log2e)
    // (a masked -inf score gives 0)
#pragma unroll
    for (int tp = 0; tp < 4; ++tp) {
      unsigned ph[2][4], pl[2][4];  // A: (g, keys 2qd..), (g+8, ..), (g, 8+2qd..), (g+8, 8+2qd..)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float p[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            p[u][r] = exp2f(fmaf(sc[mt][2 * tp + u][r], L2E, -mnl[mt][r >> 1]));
            l[mt][r >> 1] += p[u][r];
          }
        split_bf16(p[0][0], p[0][1], ph[mt][0], pl[mt][0]);
        split_bf16(p[0][2], p[0][3], ph[mt][1], pl[mt][1]);
        split_bf16(p[1][0], p[1][1], ph[mt][2], pl[mt][2]);
        split_bf16(p[1][2], p[1][3], ph[mt][3], pl[mt][3]);
      }
#pragma unroll
      for (int w = 0; w < NT / 2; ++w) {
        // matrices: keys 16 tp + {0..7, 8..15, 0..7, 8..15} x chunks {2w, 2w, 2w+1, 2w+1}
        const int key = 16 * tp + (lane & 7) + 8 * ((lane >> 3) & 1);
        unsigned r[4];
        ldsm_x4_t(smem_u32(vs + key * P + 16 * (2 * w + (lane >> 4))), r);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(o[mt][2 * w], ph[mt], r[0], r[1]);
          mma_bf16(o[mt][2 * w], pl[mt], r[0], r[1]);
          mma_bf16(o[mt][2 * w + 1], ph[mt], r[2], r[3]);
          mma_bf16(o[mt][2 * w + 1], pl[mt], r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int t = q0 + warp * 32 + 16 * mt + g + 8 * i;
      if (t >= Tq) continue;
      const float inv = li > 0.0f ? 1.0f / li : 0.0f;
      __nv_bfloat16* orow = out + ((static_cast<long long>(b) * Tq + t) * H + h) * D;
#pragma unroll
      for (int u = 0; u < NT; ++u)
        *reinterpret_cast<unsigned*>(orow + 8 * u + 2 * qd) =
            pack_bf16(o[mt][u][2 * i] * inv, o[mt][u][2 * i + 1] * inv);
    }
}

template <typename T, int D, bool kTc>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KVH,
           int Tq, int Tk, const Strides& st, float scale, int causal, int window,
           cudaStream_t stream) {
  static bool sized = false;  // shared memory above 48 KB must be asked for once
  if constexpr (kTc) {
    constexpr int smem = tcf::SMEM<D>;
    if (!sized) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_attention_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      sized = true;
    }
    const dim3 grid(B * H, (Tq + tcf::BQ - 1) / tcf::BQ);
    flash_attention_tc_kernel<D><<<grid, tcf::THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, KVH, Tq, Tk,
        st, scale, causal, window);
  } else {
    constexpr size_t smem = smem_bytes<D>();
    if (!sized) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      sized = true;
    }
    const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
    flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), H, KVH, Tq, Tk, st, scale, causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTc>
int launch_d(int D, const void* q, const void* k, const void* v, void* out, int B, int H,
             int KVH, int Tq, int Tk, const Strides& st, float scale, int causal, int window,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16, kTc>(q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, stream);
    case 32: return launch<T, 32, kTc>(q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, stream);
    case 64: return launch<T, 64, kTc>(q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, stream);
    case 80: return launch<T, 80, kTc>(q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, stream);
    case 128: return launch<T, 128, kTc>(q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`; returns a cudaError (0 on success).  Validated by the
// Python wrapper: q (B, Tq, H, D), k and v (B, Tk, KVH, D) strided with a
// contiguous last axis (`strides`: q's, k's and v's batch, time and head
// strides in elements), one dtype (`bf16` 1: bfloat16, 0: fp32), H a
// multiple of KVH, D in {16, 32, 64, 80, 128}; out (B, Tq, H, D) contiguous
// in that dtype.  `window` <= 0 means none.  `tc` (bf16 only; every pointer
// and stride a multiple of 16 bytes) runs the tensor-core kernel.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int KVH, int Tq, int Tk, int D,
                                      const long long* strides, float scale, int causal,
                                      int window, int bf16, int tc, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && tc)
    return launch_d<__nv_bfloat16, true>(D, q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, s);
  if (bf16)
    return launch_d<__nv_bfloat16, false>(D, q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, s);
  return launch_d<float, false>(D, q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, s);
}
