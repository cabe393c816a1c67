// RWKV-6 (Finch) recurrence for Hopper (sm_90a): a step kernel for decode
// and short chunks, and a chunked kernel on the bf16 tensor cores for
// prefill.
//
// Replaces the Pallas TPU kernel `rwkv6_scan_kernel` / `rwkv6_scan_pallas`
// (repro/kernels/rwkv6_scan.py).  For r, k, w (B, H, T, Dk), v (B, H, T, Dv),
// the bonus u (H, Dk) and the state S (B, H, Dk, Dv), per step t in fp32:
//
//   y_t[v] = sum_k r_t[k] * (S[k, v] + u[k] * k_t[k] * v_t[v])
//   S[k, v] = w_t[k] * S[k, v] + k_t[k] * v_t[v]
//
// with w_t floored at `w_min` (the chunked form's clamp of the log-decay at
// -8; -inf for the sequential and decode forms).  Returns y in fp32 or bf16
// (the decode step keeps fp32, the sequential and chunked forms r's dtype)
// and the final state S_T, which may be written over S_0 in place.
//
// What bounds it on the H100: at decode (B=8, H=64, T=1) the call moves
// each head's 16 KB state in and out, 2 x 8 x 64 x 16 KB = 16.8 MB, ~5 us
// at 3.35 TB/s.  At prefill the bytes are r, k, v, y (bf16) and w (fp32),
// 12 B an element: 0.061 ms at T=4096, B=1, H=64; the recurrence's products
// (~2 Dk Dv flops a token for each of the output and the state) are far
// below the tensor cores' peak, so the bound is the bytes, and a kernel
// that walks the tokens one at a time is latency-bound long before it.
//
// The step kernel (`rwkv6_scan_kernel`, decode and T < the wrapper's
// threshold): the TPU's sequential chunk axis becomes a loop inside one
// block of 256 threads per (b, h).  Thread t owns state column t % 64 and
// the 16 rows 16 (t / 64) .. +15 of it, in registers for all T steps.  Each
// step's r, k, w (Dk values) and v (Dv values) are staged in shared memory,
// one value a thread, loaded one step ahead into a register so the next
// step's global load overlaps this step's arithmetic.  Each thread folds
// its 16 rows into a partial y and updates its 16 state values; the four
// partials of a column are summed through shared memory and written by the
// first Dv threads.
//
// The chunked kernel (`chunk::rwkv6_chunk_kernel`): Finch's matrix form
// (arXiv:2404.05892, appendix D), the "MXU-friendly upgrade path" the
// Pallas kernel names, taken 16 tokens (the m16 of mma.sync) at a time.
// Per sub-chunk and channel d, with lw = log2(max(max(w, w_min), 1e-30))
// (the reference's clamp of w before the log: w = 0 gives a decay of
// 1e-30, not a NaN), the inclusive cumsum c and the exclusive one c- (the
// running sum before each term, not c - lw, which loses a tiny decay to
// cancellation), each kept as an fp32 hi + lo pair (Knuth's two-sum a
// step) so a difference of two cumsums after a w = 0 term (-99.7) keeps
// fp32's precision (plain fp32 sums lost ~7 bits there, 14x the error):
//
//   y_i  = (r_i * 2^c-_i) S                                   (inter)
//        + sum_{j<i} [sum_d r_i k_j 2^(c-_i - c_j)] v_j       (intra)
//        + (r_i . (u * k_i)) v_i                              (bonus)
//   S   <- diag(2^c_L) S + (k * 2^(c_L - c))^T v              (state)
//
// Every exponent is <= 0 for decays in [0, 1] (the cumsums only fall), so
// no factor overflows, whatever the decay: the pair scores are summed
// channel by channel (120 pairs x 64 channels a sub-chunk, one ex2 each)
// rather than factored as (r 2^c-)(k 2^-c)^T, which needs 2^+|c|.  The
// three products run on the bf16 tensor cores
// (`mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32`), the computed operand
// (r 2^c-, the scores, k 2^(c_L - c)) in bf16 hi + mid + lo and the other
// (the state, v) in hi + lo, five products (all above 2^-24 of the whole):
// within ~5e-6 of the largest |y| and ~1e-6 of the largest |S| where one
// bf16 product misses the card's 1e-5 gate by 200x and three (hi + lo
// each) reach 1.2e-5 with fp32 inputs.  v's lo is zero when v is bf16, and
// its products are skipped.  The state lives in registers, transposed
// (rows v, columns d), as the accumulator fragments of the state product,
// which are also the A fragments of the next sub-chunk's inter product.
//
// Block: 256 threads, one (b, h) and one segment of T; warp w owns state
// rows v in [16 (w % 4), +16) and columns d in [32 (w / 4), +32), and sums
// the inter product over its columns (the two halves' y added on the way
// out).  Each sub-chunk's raw r, k, v, w tiles land by 16-byte cp.async
// (zero-filled past T and the widths; element loads when a row is not
// 16-byte aligned), three sub-chunks in flight: a block barrier waits for
// every global load a thread has outstanding, and a cp.async is not one
// (plain prefetched loads left 40% of the time waiting there).  A skewed
// pipeline with two barriers a sub-chunk s: phase X makes s's operands (r
// 2^c-, k 2^(c_L - c) transposed, the pair scores, in shared memory with
// row pitches that keep the fragment loads free of bank conflicts) and
// stages s + 1 (its log2-decays' cumsums, by a two-sum scan over a
// half-warp, and v^T in hi / lo); phase Y runs s's products.  y goes
// through shared memory so each token row is written contiguously.  S_0
// lands by cp.async with the first tiles.
//
// What the time is (on an H100): one block fills an SM's issue slots, so
// a sub-chunk costs its instructions, ~1,800 a warp: the pair scores (~30%:
// six shared loads, three adds, an ex2, a multiply and an fma a pair and
// channel), the cumsums (log2f and the scan, ~30%), the products (~20%).
// The code was 20K SASS instructions with runtime-width copy loops (~15%
// of the time), 6K now.
//
// Parallelism over T: B*H = 64 blocks leave half the card idle at B=1, and
// a head's sub-chunks are sequential.  So T is cut into up to 8 segments of
// whole sub-chunks, one thread-block cluster a head, as many as keep a
// block an SM (two for rwkv6-7b at B=1; the wrapper's `chunk_split`).  Pass
// 1: every segment but the last scans its tokens from a zero state, keeping
// only the state (no scores, no y), and leaves that local state and its
// decay product 2^sum(lw) in shared memory.  After a cluster barrier each
// block combines the earlier segments' leavings in order through
// distributed shared memory (S = decay_m * S + S_m from S_0), and after a
// second barrier (which also ends every read of S_0, so the last segment
// may then write S_T over it) pass 2 scans the segment from that state with
// the outputs.  Inputs are read with their own (b, h, t) strides (the
// feature axis contiguous), so the caller's head views of (B, T, D)
// projections need no copy, and y is written with its own strides.  Dk, Dv
// <= 64 (padded to 64 with zeros and unit decays).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAXD = 64;                // Dk, Dv <= 64
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / MAXD;  // 4 row groups
constexpr int RPT = MAXD / GROUPS;      // 16 state rows a thread

// (b, h, t) element strides of r, k, v, w and y; the feature axis is contiguous.
struct Strides {
  long long r[3], k[3], v[3], w[3], y[3];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TO>
__device__ __forceinline__ TO from_f(float x) {
  if constexpr (std::is_same<TO, float>::value) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

__device__ __forceinline__ long long at(const long long* s, int b, int h, int t) {
  return b * s[0] + h * s[1] + t * s[2];
}

// TI is the dtype of r, k, v (float or bf16); TO that of y.  w, u and the
// state are fp32.
template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
rwkv6_scan_kernel(const TI* __restrict__ r, const TI* __restrict__ k, const TI* __restrict__ v,
                  const float* __restrict__ w, const float* __restrict__ u, const float* s0,
                  float* sT, TO* __restrict__ y, int H, int T, int Dk, int Dv, Strides st,
                  float w_min) {
  __shared__ float sh[4][MAXD];        // the step's r, k, w, v
  __shared__ float yp[GROUPS][MAXD];   // the row groups' partial y

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int col = tid % MAXD;
  const int grp = tid / MAXD;

  float S[RPT];
  float ur[RPT];
  const size_t base = static_cast<size_t>(bh) * Dk * Dv;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = grp * RPT + i;
    const bool ok = row < Dk && col < Dv;
    S[i] = ok && s0 != nullptr ? s0[base + static_cast<size_t>(row) * Dv + col] : 0.0f;
    ur[i] = row < Dk ? u[h * Dk + row] : 0.0f;
  }

  // staging role: group 0 loads r, 1 k, 2 w, 3 v, element `col` of the step
  // (zero past the feature width, so padded rows and columns stay zero)
  const int len = grp == 3 ? Dv : Dk;
  auto load = [&](int t) -> float {
    if (col >= len) return 0.0f;
    switch (grp) {
      case 0: return to_f(r[at(st.r, b, h, t) + col]);
      case 1: return to_f(k[at(st.k, b, h, t) + col]);
      case 2: return fmaxf(w[at(st.w, b, h, t) + col], w_min);
      default: return to_f(v[at(st.v, b, h, t) + col]);
    }
  };

  float nxt = T > 0 ? load(0) : 0.0f;
  for (int t = 0; t < T; ++t) {
    sh[grp][col] = nxt;
    __syncthreads();
    if (t + 1 < T) nxt = load(t + 1);  // the next step's load flies meanwhile
    const float vv = sh[3][col];
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = grp * RPT + i;
      const float kv = sh[1][row] * vv;
      acc += sh[0][row] * (S[i] + ur[i] * kv);
      S[i] = sh[2][row] * S[i] + kv;
    }
    yp[grp][col] = acc;
    __syncthreads();
    if (tid < Dv) {
      const float yv = (yp[0][tid] + yp[1][tid]) + (yp[2][tid] + yp[3][tid]);
      y[at(st.y, b, h, t) + tid] = from_f<TO>(yv);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = grp * RPT + i;
    if (row < Dk && col < Dv) sT[base + static_cast<size_t>(row) * Dv + col] = S[i];
  }
}

template <typename TI, typename TO>
void launch(const void* r, const void* k, const void* v, const void* w, const void* u,
            const void* s0, void* sT, void* y, int B, int H, int T, int Dk, int Dv,
            const Strides& st, float w_min, cudaStream_t s) {
  rwkv6_scan_kernel<TI, TO><<<B * H, THREADS, 0, s>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k), static_cast<const TI*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(sT), static_cast<TO*>(y), H, T, Dk,
      Dv, st, w_min);
}


namespace chunk {

namespace cg = cooperative_groups;

constexpr int L = 16;            // tokens a sub-chunk: the m16 of mma.sync
constexpr int D = 64;            // head width, padded (Dk, Dv <= 64)
constexpr int THREADS = 256;     // warp w: state rows 16 (w % 4) .., columns 32 (w / 4) ..
constexpr int MAX_SEGMENTS = 8;  // a head's segments are one thread-block cluster
constexpr int FP = D + 4;        // fp32 row pitch (floats): rows 4 banks apart
constexpr int BP = D + 8;        // bf16 pitch of the token-major tiles: 36 words
constexpr int TP = L + 8;        // bf16 pitch of the 16-token-deep tiles: 12 words
constexpr int PAIRS = L * (L - 1) / 2;  // strictly lower (i, j): two threads each
constexpr float kMinW = 1e-30f;  // w is clamped here before the log
constexpr unsigned FULL = 0xffffffffu;

template <typename TI>
struct Tiles {
  static constexpr int RP = D + 16 / static_cast<int>(sizeof(TI));  // raw pitch: 16-byte rows
  static constexpr int RAW = 3;  // sub-chunk s + 2 lands while s + 1 is staged and s is used
  // raw r, k, v, w (cp.async, zero past the sub-chunk and the widths)
  __align__(16) TI rr[RAW][L][RP];
  __align__(16) TI kr[RAW][L][RP];
  __align__(16) TI vr[RAW][L][RP];
  __align__(16) float wr[RAW][L][FP];
  // staged, by sub-chunk parity: the inclusive log2-cumsum of the decays in
  // the sub-chunk as hi + lo (two-sum), the sub-chunk's decay 2^c_L a
  // channel, and v^T in bf16 hi / lo (A of the intra and state products:
  // m = v, k = token)
  __align__(16) float chi[2][L][FP];
  __align__(16) float clo[2][L][FP];
  float decay[2][D];
  __align__(16) __nv_bfloat16 vh[2][D][TP];
  __align__(16) __nv_bfloat16 vl[2][D][TP];
  // the products' other operands, in bf16 hi / mid / lo
  __align__(16) __nv_bfloat16 rq[3][L][BP];  // r 2^c-: B of the inter product (n = token, k = d)
  __align__(16) __nv_bfloat16 kd[3][D][TP];  // (k 2^(c_L - c))^T: B of the state (n = d, k = token)
  __align__(16) __nv_bfloat16 sc[3][L][TP];  // pair scores: B of the intra product (n = i, k = j)
  __align__(16) float y[2][L][FP];           // y, partial over each half of the state's columns

  // S_0 (fp32, as stored) lands over rq .. y before the first sub-chunk's
  // operands are made
  __device__ float* s0() { return reinterpret_cast<float*>(&rq[0][0][0]); }
  static constexpr int S0_ROOM = sizeof(rq) + sizeof(kd) + sizeof(sc) + sizeof(y);
};
static_assert(Tiles<float>::S0_ROOM >= 4 * D * D && Tiles<__nv_bfloat16>::S0_ROOM >= 4 * D * D,
              "S_0 fits over the operand tiles");

// What a segment leaves for the cluster's combine, over the tiles (unused
// between the two cluster barriers): its local state, fragment by fragment
// ([register][thread]: each thread's reads are contiguous across the
// block), and its decay product a channel.
struct Part {
  float s[16][THREADS];
  float decay[D];
};

template <typename TI>
union Smem {
  Tiles<TI> t;
  Part p;
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  float* sT;
  void* y;
  Strides st;
  int H, T, Dk, Dv, seg_len;
  bool a16;  // every row 16-byte aligned: cp.asyncs, else element loads
  float w_min;
};

__device__ __forceinline__ unsigned bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const unsigned*>(&h);
}

// x0, x1 as bf16 hi + lo: hi = bf16(x), lo = bf16(x - hi), the difference
// exact in fp32.
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// x0, x1 as bf16 hi + mid + lo: three 8-bit slices of fp32's 24-bit mantissa.
__device__ __forceinline__ void split3(float x0, float x1, unsigned& hi, unsigned& mid,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m)));
}

// 4 fp32 values as bf16 hi, mid and lo row pieces (8 bytes each) at p,
// p + stride and p + 2 stride.
__device__ __forceinline__ void store_split4x3(const float (&x)[4], __nv_bfloat16* p,
                                               int stride) {
  uint2 h, m, l;
  split3(x[0], x[1], h.x, m.x, l.x);
  split3(x[2], x[3], h.y, m.y, l.y);
  *reinterpret_cast<uint2*>(p) = h;
  *reinterpret_cast<uint2*>(p + stride) = m;
  *reinterpret_cast<uint2*>(p + 2 * stride) = l;
}

// x as bf16 hi, mid and lo at p, p + stride and p + 2 stride.
__device__ __forceinline__ void store3(float x, __nv_bfloat16* p, int stride) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(h);
  const __nv_bfloat16 m = __float2bfloat16_rn(r);
  p[0] = h;
  p[stride] = m;
  p[2 * stride] = __float2bfloat16_rn(r - __bfloat162float(m));
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += (a_hi + a_lo) (b_hi + b_mid + b_lo), the five products above 2^-24
// of the whole (a_lo b_lo is left out, and a_lo's whole row when a_lo is
// zero: `two` false).
__device__ __forceinline__ void mma5(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], const unsigned (&b)[3][2],
                                     bool two) {
  mma(d, ah, b[0][0], b[0][1]);
  mma(d, ah, b[1][0], b[1][1]);
  mma(d, ah, b[2][0], b[2][1]);
  if (two) {
    mma(d, al, b[0][0], b[0][1]);
    mma(d, al, b[1][0], b[1][1]);
  }
}

// B fragments of the three terms of a [term][n][k] bf16 tile: rows n, k from k0.
__device__ __forceinline__ void ld_b3(const __nv_bfloat16* t, int term_stride, int pitch, int n,
                                      int k0, unsigned (&b)[3][2]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat16* p = t + i * term_stride + n * pitch + k0;
    b[i][0] = ld32(p);
    b[i][1] = ld32(p + 8);
  }
}

// 16 bytes global -> shared, asynchronously; zeros (and no read) when `in`
// is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// 2^x (ex2.approx.ftz: within 2^-22 relative; results below 2^-126, far
// under any term they scale, flush to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The L rows t0 .. t0 + L - 1 of one head of a tensor of X (`base`: the
// head's first row; rows `row` bytes apart, `width` bytes wide) into the
// smem tile `dst` (D columns, rows `pitch` bytes apart), zeros past the
// width and from row `hi` on.  With 16-byte-aligned rows: 16-byte
// cp.asyncs over the padded row, which no barrier waits for; else element
// loads.
template <typename X>
__device__ __forceinline__ void copy_tile(char* dst, int pitch, const char* base, long long row,
                                          int width, int t0, int hi, bool a16) {
  constexpr int esize = static_cast<int>(sizeof(X));
  if (a16) {
    constexpr int per_row = D * esize / 16;
#pragma unroll 1
    for (int u = threadIdx.x; u < L * per_row; u += THREADS) {
      const int i = u / per_row, c = (u % per_row) * 16;
      const bool in = t0 + i < hi && c < width;
      cp_async16(dst + i * pitch + c, in ? base + (t0 + i) * row + c : base, in);
    }
    return;
  }
#pragma unroll 1
  for (int u = threadIdx.x; u < L * D; u += THREADS) {
    const int i = u / D, c = (u % D) * esize;
    const bool in = t0 + i < hi && c < width;
    *reinterpret_cast<X*>(dst + i * pitch + c) =
        in ? *reinterpret_cast<const X*>(base + (t0 + i) * row + c) : X(0.0f);
  }
}

// 4 consecutive values of a row as fp32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// One pass over tokens [lo, hi) of head (b, h) from the state S, or from the
// head's (Dk, Dv) state at `s0_async` when that is given (copied with the
// first sub-chunk's tiles, so no barrier waits on its loads) (fragments:
// S[j][e] holds row v = 16 (warp % 4) + g + 8 (e / 2) and column d = 8 (4
// (warp / 4) + j) + 2 q + e % 2, where g = lane / 4, q = lane % 4).  OUT:
// also the outputs (else the state alone, and `ctot`, the cumsums of the
// pass's log2-decays, by the threads that hold a sub-chunk's last token).
//
// A skewed pipeline, two block barriers a sub-chunk s: phase X makes s's
// operands from its staged cumsums and raw r, k, and stages s + 1 (its
// cumsums and v^T) beside them; phase Y runs s's products.  The raw tiles
// of s + 2 land meanwhile.
template <bool OUT, typename TI, typename TO>
__device__ __forceinline__ void scan(const Args& a, Tiles<TI>& sm, const float* u_s, int b,
                                     int h, int lo, int hi, float (&S)[4][4], float (&ctot)[4],
                                     const float* s0_async) {
  constexpr bool kV16 = std::is_same<TI, __nv_bfloat16>::value;  // v's lo is zero
  constexpr int RP = Tiles<TI>::RP, RAW = Tiles<TI>::RAW;
  const TI* rp = static_cast<const TI*>(a.r);
  const TI* kp = static_cast<const TI*>(a.k);
  const TI* vp = static_cast<const TI*>(a.v);
  TO* yp = static_cast<TO*>(a.y);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int vb = warp & 3, dh = warp >> 2;  // the warp's state rows and columns
  const int vr = 16 * vb + g;
  // the strictly lower pair this thread scores, half the channels
  int pi = 1, pj = tid >> 1;
  while (pj >= pi) {
    pj -= pi;
    ++pi;
  }
  const int nsub = (hi - lo + L - 1) / L;

  // the head's rows (bytes), and the copies' size
  constexpr int isz = static_cast<int>(sizeof(TI));
  const char* r0 = reinterpret_cast<const char*>(rp + at(a.st.r, b, h, 0));
  const char* k0 = reinterpret_cast<const char*>(kp + at(a.st.k, b, h, 0));
  const char* v0 = reinterpret_cast<const char*>(vp + at(a.st.v, b, h, 0));
  const char* w0 = reinterpret_cast<const char*>(a.w + at(a.st.w, b, h, 0));
  const bool a16 = a.a16;
  auto issue = [&](int s) {
    const int t0 = lo + s * L, buf = s % RAW;
    if (OUT)
      copy_tile<TI>(reinterpret_cast<char*>(&sm.rr[buf][0][0]), RP * isz, r0, a.st.r[2] * isz,
                    a.Dk * isz, t0, hi, a16);
    copy_tile<TI>(reinterpret_cast<char*>(&sm.kr[buf][0][0]), RP * isz, k0, a.st.k[2] * isz,
                  a.Dk * isz, t0, hi, a16);
    copy_tile<TI>(reinterpret_cast<char*>(&sm.vr[buf][0][0]), RP * isz, v0, a.st.v[2] * isz,
                  a.Dv * isz, t0, hi, a16);
    copy_tile<float>(reinterpret_cast<char*>(&sm.wr[buf][0][0]), FP * 4, w0, a.st.w[2] * 4,
                     a.Dk * 4, t0, hi, a16);
    cp_async_commit();
  };

  // stage sub-chunk s: the log2-decays' cumsums (token tid % 16 on the lanes
  // of a half-warp, channels 4 (tid / 16) ..: an inclusive scan over the
  // half-warp, hi + lo by two-sum at each step) and v^T in hi / lo
  auto stage = [&](int s) {
    const int buf = s % RAW, par = s & 1, n = min(L, hi - (lo + s * L));
    {
      const int tok = tid & 15, c0 = (tid >> 4) * 4;
      const float4 w4 = *reinterpret_cast<const float4*>(&sm.wr[buf][tok][c0]);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
      float ch[4], cl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // past the sub-chunk or the width: a unit decay (log 0)
        const float x = tok < n && c0 + e < a.Dk ? wv[e] : 1.0f;
        ch[e] = log2f(fmaxf(fmaxf(x, a.w_min), kMinW));
        cl[e] = 0.0f;
      }
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float oh = __shfl_up_sync(FULL, ch[e], off, L);
          const float ol = __shfl_up_sync(FULL, cl[e], off, L);
          if (tok >= off) {
            const float sum = oh + ch[e], bb = sum - oh;
            cl[e] += ol + ((oh - (sum - bb)) + (ch[e] - bb));
            ch[e] = sum;
          }
        }
      }
      *reinterpret_cast<float4*>(&sm.chi[par][tok][c0]) = make_float4(ch[0], ch[1], ch[2], ch[3]);
      *reinterpret_cast<float4*>(&sm.clo[par][tok][c0]) = make_float4(cl[0], cl[1], cl[2], cl[3]);
      if (tok == L - 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sm.decay[par][c0 + e] = ex2(ch[e] + cl[e]);
          ctot[e] += ch[e] + cl[e];
        }
      }
    }
    {  // v^T: channel tid / 4, tokens 4 (tid % 4) ..
      const int col = tid >> 2, t4 = (tid & 3) * 4;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = to_f(sm.vr[buf][t4 + e][col]);
      uint2 hv, lv;
      split2(x[0], x[1], hv.x, lv.x);
      split2(x[2], x[3], hv.y, lv.y);
      *reinterpret_cast<uint2*>(&sm.vh[par][col][t4]) = hv;
      *reinterpret_cast<uint2*>(&sm.vl[par][col][t4]) = lv;
    }
  };

  // sub-chunk s's y (the two column halves' partials summed)
  auto store_y = [&](int s) {
    const int t0 = lo + s * L, tok = tid >> 4, c0 = (tid & 15) * 4;
    if (t0 + tok >= hi) return;
    TO* row = yp + at(a.st.y, b, h, t0 + tok);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e < a.Dv) row[c0 + e] = from_f<TO>(sm.y[0][tok][c0 + e] + sm.y[1][tok][c0 + e]);
  };

  if (s0_async != nullptr)
    for (int i = tid; i < a.Dk * a.Dv; i += THREADS) cp_async4(sm.s0() + i, s0_async + i);
  issue(0);
  if (nsub > 1) {
    issue(1);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  if (s0_async != nullptr) {  // read before the first operands overwrite it
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 8 * (4 * dh + j) + 2 * q + (e & 1), v = vr + 8 * (e >> 1);
        S[j][e] = d < a.Dk && v < a.Dv ? sm.s0()[d * a.Dv + v] : 0.0f;
      }
  }
  stage(0);
#pragma unroll 1
  for (int s = 0; s < nsub; ++s) {
    const int buf = s % RAW, par = s & 1;
    cp_async_wait<0>();  // s + 1's raw tiles
    __syncthreads();
    if (s + 2 < nsub) issue(s + 2);
    if (OUT && s > 0) store_y(s - 1);

    // phase X: s's operands (exponents as differences of hi and lo parts: a
    // w = 0 term of -99.7 earlier in the sub-chunk costs no precision)
    const float(*chi)[FP] = sm.chi[par];
    const float(*clo)[FP] = sm.clo[par];
    {  // (k 2^(c_L - c))^T: channel tid % 64, tokens 4 (tid / 64) ..
      const int col = tid & 63, t4 = (tid >> 6) * 4;
      const float lh = chi[L - 1][col], ll = clo[L - 1][col];
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = to_f(sm.kr[buf][t4 + e][col]) *
               ex2((lh - chi[t4 + e][col]) + (ll - clo[t4 + e][col]));
      store_split4x3(x, &sm.kd[0][col][t4], D * TP);
    }
    if (OUT) {
      if (s == 0) {  // the scores' upper triangle stays zero (S_0 lay there)
        for (int i = tid; i < 3 * L * L; i += THREADS) {
          const int r = (i >> 4) & (L - 1), c = i & (L - 1);
          if (c > r) sm.sc[i / (L * L)][r][c] = __float2bfloat16_rn(0.0f);
        }
      }
      {  // r 2^c-: token tid / 16, channels 4 (tid % 16) .. (c- is c one token back)
        const int tok = tid >> 4, c0 = (tid & 15) * 4;
        const float4 r4 = load4(&sm.rr[buf][tok][c0]);
        float x[4] = {r4.x, r4.y, r4.z, r4.w};
        if (tok > 0) {
          const float4 h4 = *reinterpret_cast<const float4*>(&chi[tok - 1][c0]);
          const float4 l4 = *reinterpret_cast<const float4*>(&clo[tok - 1][c0]);
          x[0] *= ex2(h4.x + l4.x);
          x[1] *= ex2(h4.y + l4.y);
          x[2] *= ex2(h4.z + l4.z);
          x[3] *= ex2(h4.w + l4.w);
        }
        store_split4x3(x, &sm.rq[0][tok][c0], L * BP);
      }
      // the pair scores sum_d r_i k_j 2^(c-_i - c_j), every exponent <= 0:
      // threads 2p, 2p + 1 take pair p's two channel halves (the second
      // half rotated by 16 channels: the halves' rows then fall in other
      // banks); threads 240 .. 255 the bonus diagonal r_i . (u * k_i)
      float part = 0.0f;
      if (tid < 2 * PAIRS) {
        const int d0 = (tid & 1) * (D / 2), rot = (tid & 1) * 16;
        const TI* ri = sm.rr[buf][pi];
        const TI* kj = sm.kr[buf][pj];
        const float* hi_i = chi[pi - 1];  // c-_i = c_(i-1)
        const float* lo_i = clo[pi - 1];
        const float* hi_j = chi[pj];
        const float* lo_j = clo[pj];
        float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
        for (int dd = 0; dd < D / 2; dd += 4) {
          const int d = d0 + ((dd + rot) & (D / 2 - 1));
          const float4 r4 = load4(ri + d);
          const float4 k4 = load4(kj + d);
          const float4 a4 = *reinterpret_cast<const float4*>(hi_i + d);
          const float4 b4 = *reinterpret_cast<const float4*>(hi_j + d);
          const float4 c4 = *reinterpret_cast<const float4*>(lo_i + d);
          const float4 e4 = *reinterpret_cast<const float4*>(lo_j + d);
          acc0 = fmaf(r4.x * k4.x, ex2((a4.x - b4.x) + (c4.x - e4.x)), acc0);
          acc1 = fmaf(r4.y * k4.y, ex2((a4.y - b4.y) + (c4.y - e4.y)), acc1);
          acc0 = fmaf(r4.z * k4.z, ex2((a4.z - b4.z) + (c4.z - e4.z)), acc0);
          acc1 = fmaf(r4.w * k4.w, ex2((a4.w - b4.w) + (c4.w - e4.w)), acc1);
        }
        part = acc0 + acc1;
      } else {
        const int i = tid - 2 * PAIRS;
        float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 r4 = load4(&sm.rr[buf][i][d]);
          const float4 k4 = load4(&sm.kr[buf][i][d]);
          const float4 u4 = *reinterpret_cast<const float4*>(u_s + d);
          acc0 = fmaf(r4.x * u4.x, k4.x, acc0);
          acc1 = fmaf(r4.y * u4.y, k4.y, acc1);
          acc0 = fmaf(r4.z * u4.z, k4.z, acc0);
          acc1 = fmaf(r4.w * u4.w, k4.w, acc1);
        }
        part = acc0 + acc1;
      }
      const float other = __shfl_xor_sync(FULL, part, 1);
      if (tid >= 2 * PAIRS)
        store3(part, &sm.sc[0][tid - 2 * PAIRS][tid - 2 * PAIRS], L * TP);
      else if ((tid & 1) == 0)
        store3(part + other, &sm.sc[0][pi][pj], L * TP);
    }
    if (s + 1 < nsub) stage(s + 1);
    __syncthreads();

    // phase Y: the products, the warp's 16 state rows and half of its columns
    unsigned vah[4], val[4] = {0u, 0u, 0u, 0u};
    vah[0] = ld32(&sm.vh[par][vr][2 * q]);
    vah[1] = ld32(&sm.vh[par][vr + 8][2 * q]);
    vah[2] = ld32(&sm.vh[par][vr][2 * q + 8]);
    vah[3] = ld32(&sm.vh[par][vr + 8][2 * q + 8]);
    if (!kV16) {
      val[0] = ld32(&sm.vl[par][vr][2 * q]);
      val[1] = ld32(&sm.vl[par][vr + 8][2 * q]);
      val[2] = ld32(&sm.vl[par][vr][2 * q + 8]);
      val[3] = ld32(&sm.vl[par][vr + 8][2 * q + 8]);
    }
    if (OUT) {
      float yc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      // inter: y^T (v x token) += S (v x d) (r 2^c-)^T over this half of d,
      // S's accumulator fragments as A
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        unsigned ah[4], al[4];
        split2(S[2 * kk][0], S[2 * kk][1], ah[0], al[0]);
        split2(S[2 * kk][2], S[2 * kk][3], ah[1], al[1]);
        split2(S[2 * kk + 1][0], S[2 * kk + 1][1], ah[2], al[2]);
        split2(S[2 * kk + 1][2], S[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          unsigned bf[3][2];
          ld_b3(&sm.rq[0][0][0], L * BP, BP, 8 * nt + g, 16 * (2 * dh + kk) + 2 * q, bf);
          mma5(yc[nt], ah, al, bf, true);
        }
      }
      {  // intra + bonus for this half's 8 tokens: y^T += v^T (v x j) scores^T (j x i)
        unsigned bf[3][2];
        ld_b3(&sm.sc[0][0][0], L * TP, TP, 8 * dh + g, 2 * q, bf);
        mma5(yc[dh], vah, val, bf, !kV16);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        sm.y[dh][8 * nt + 2 * q][vr] = yc[nt][0];
        sm.y[dh][8 * nt + 2 * q + 1][vr] = yc[nt][1];
        sm.y[dh][8 * nt + 2 * q][vr + 8] = yc[nt][2];
        sm.y[dh][8 * nt + 2 * q + 1][vr + 8] = yc[nt][3];
      }
    }
    // state: S^T = S^T diag(2^c_L) + v^T (v x token) (k 2^(c_L - c)) (token x d)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = 8 * (4 * dh + j) + 2 * q;
      const float d0 = sm.decay[par][d], d1 = sm.decay[par][d + 1];
      S[j][0] *= d0;
      S[j][1] *= d1;
      S[j][2] *= d0;
      S[j][3] *= d1;
      unsigned bf[3][2];
      ld_b3(&sm.kd[0][0][0], D * TP, TP, 8 * (4 * dh + j) + g, 2 * q, bf);
      mma5(S[j], vah, val, bf, !kV16);
    }
  }
  __syncthreads();
  if (OUT) store_y(nsub - 1);
}

// S's fragments from / to a (Dk, Dv) row-major state (zeros past the widths
// and where `src` is null).
__device__ __forceinline__ void load_state(const float* src, int Dk, int Dv, float (&S)[4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 8 * (4 * (warp >> 2) + j) + 2 * q + (e & 1);
      const int v = 16 * (warp & 3) + g + 8 * (e >> 1);
      S[j][e] = src != nullptr && d < Dk && v < Dv ? src[d * Dv + v] : 0.0f;
    }
}

__device__ __forceinline__ void store_state(float* dst, int Dk, int Dv, const float (&S)[4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 8 * (4 * (warp >> 2) + j) + 2 * q + (e & 1);
      const int v = 16 * (warp & 3) + g + 8 * (e >> 1);
      if (d < Dk && v < Dv) dst[d * Dv + v] = S[j][e];
    }
}

// Grid (B*H, segments); a head's segments are one cluster when there are
// several.  TI is the dtype of r, k, v; TO that of y.
template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS, 2) rwkv6_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<TI>& sm = *reinterpret_cast<Smem<TI>*>(smem_raw);
  __shared__ __align__(16) float u_s[D];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int nseg = gridDim.y, seg = blockIdx.y;
  const int lo = seg * a.seg_len, hi = min(lo + a.seg_len, a.T);
  const size_t base = static_cast<size_t>(bh) * a.Dk * a.Dv;
  const float* s0 = a.s0 != nullptr ? a.s0 + base : nullptr;
  if (tid < D) u_s[tid] = tid < a.Dk ? a.u[h * a.Dk + tid] : 0.0f;
  float S[4][4];
  float ctot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (nseg > 1) {
    // pass 1: this segment's own state from zero, and its decay product
    if (seg < nseg - 1) {
      load_state(nullptr, a.Dk, a.Dv, S);
      scan<false, TI, TO>(a, sm.t, u_s, b, h, lo, hi, S, ctot, nullptr);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sm.p.s[4 * j + e][tid] = S[j][e];
      if ((tid & 15) == L - 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sm.p.decay[(tid >> 4) * 4 + e] = ex2(ctot[e]);
      }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    // the state at this segment's start: the earlier segments in order
    load_state(s0, a.Dk, a.Dv, S);
    const int q = tid & 3, dh = tid >> 7;
    for (int m = 0; m < seg; ++m) {
      const Part* pm = cluster.map_shared_rank(&sm.p, m);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 8 * (4 * dh + j) + 2 * q;
        const float d0 = pm->decay[d], d1 = pm->decay[d + 1];
        S[j][0] = fmaf(d0, S[j][0], pm->s[4 * j][tid]);
        S[j][1] = fmaf(d1, S[j][1], pm->s[4 * j + 1][tid]);
        S[j][2] = fmaf(d0, S[j][2], pm->s[4 * j + 2][tid]);
        S[j][3] = fmaf(d1, S[j][3], pm->s[4 * j + 3][tid]);
      }
    }
    cluster.sync();  // every leaving read and every read of S_0 done
  } else {
    load_state(nullptr, a.Dk, a.Dv, S);  // zeros, or S_0 copied in by the pass
  }
  // pass 2: the outputs from the segment's start state
  scan<true, TI, TO>(a, sm.t, u_s, b, h, lo, hi, S, ctot, nseg > 1 ? nullptr : s0);
  if (seg == nseg - 1) store_state(a.sT + base, a.Dk, a.Dv, S);
}

template <typename TI, typename TO>
int launch(const Args& a, int BH, int segments, cudaStream_t s) {
  auto kernel = rwkv6_chunk_kernel<TI, TO>;
  constexpr int smem = static_cast<int>(sizeof(Smem<TI>));
  static bool sized = false;  // shared memory above 48 KB must be asked for
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH, segments, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = segments;  // a head's segments
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = segments > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace chunk

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Shapes,
// dtypes and pointers are validated by the Python wrapper.  `strides` holds
// 15 int64 values: the (b, h, t) element strides of r, k, v, w and y.  r, k,
// v are bf16 when `in_bf16`, else fp32; y is bf16 when `out_bf16`, else
// fp32; w, u, s0 and sT are fp32; `s0` may be null (a zero state) and may
// equal `sT` (the state updated in place).  Dk, Dv <= 64.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* w,
                                 const void* u, const void* s0, void* sT, void* y, int B,
                                 int H, int T, int Dk, int Dv, const long long* strides,
                                 float w_min, int in_bf16, int out_bf16, void* stream) {
  Strides st;
  for (int j = 0; j < 3; ++j) {
    st.r[j] = strides[j];
    st.k[j] = strides[3 + j];
    st.v[j] = strides[6 + j];
    st.w[j] = strides[9 + j];
    st.y[j] = strides[12 + j];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, s0, sT, y, B, H, T, Dk, Dv, st, w_min, s);
  } else if (in_bf16) {
    launch<__nv_bfloat16, float>(r, k, v, w, u, s0, sT, y, B, H, T, Dk, Dv, st, w_min, s);
  } else if (out_bf16) {
    launch<float, __nv_bfloat16>(r, k, v, w, u, s0, sT, y, B, H, T, Dk, Dv, st, w_min, s);
  } else {
    launch<float, float>(r, k, v, w, u, s0, sT, y, B, H, T, Dk, Dv, st, w_min, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The chunked kernel, same arguments as rwkv6_scan_launch plus the split of
// T: `segments` (1-8) runs of `seg_len` tokens (a multiple of 16; the last
// run may be shorter and none is empty), a head's runs one thread-block
// cluster; and `a16`: every row of r, k, v and w starts 16-byte aligned
// and is a multiple of 16 bytes wide (copied asynchronously; else loaded
// element by element).  Returns a cudaError_t (0 on success).
extern "C" int rwkv6_chunk_launch(const void* r, const void* k, const void* v, const void* w,
                                  const void* u, const void* s0, void* sT, void* y, int B,
                                  int H, int T, int Dk, int Dv, const long long* strides,
                                  float w_min, int in_bf16, int out_bf16, int segments,
                                  int seg_len, int a16, void* stream) {
  if (segments < 1 || segments > chunk::MAX_SEGMENTS || seg_len < 1 || seg_len % chunk::L ||
      static_cast<long long>(segments - 1) * seg_len >= T ||
      static_cast<long long>(segments) * seg_len < T || Dk > chunk::D || Dv > chunk::D)
    return static_cast<int>(cudaErrorInvalidValue);
  chunk::Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.sT = static_cast<float*>(sT);
  a.y = y;
  for (int j = 0; j < 3; ++j) {
    a.st.r[j] = strides[j];
    a.st.k[j] = strides[3 + j];
    a.st.v[j] = strides[6 + j];
    a.st.w[j] = strides[9 + j];
    a.st.y[j] = strides[12 + j];
  }
  a.H = H;
  a.T = T;
  a.Dk = Dk;
  a.Dv = Dv;
  a.seg_len = seg_len;
  a.a16 = a16 != 0;
  a.w_min = w_min;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (in_bf16 && out_bf16) return chunk::launch<__nv_bfloat16, __nv_bfloat16>(a, BH, segments, s);
  if (in_bf16) return chunk::launch<__nv_bfloat16, float>(a, BH, segments, s);
  if (out_bf16) return chunk::launch<float, __nv_bfloat16>(a, BH, segments, s);
  return chunk::launch<float, float>(a, BH, segments, s);
}
