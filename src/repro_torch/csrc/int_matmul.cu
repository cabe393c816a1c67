// int8 x int8 -> int32 matmul with P-bit accumulator emulation, the fused
// W8A8 epilogue, the quantizing prologue and the requantizing epilogue, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `int_matmul_kernel` / `int_matmul_pallas`
// (repro/kernels/int_matmul.py).  It computes, for x (M, K) int8 row-major
// and w (K, N) int8 row-major:
//
//   acc  = sum_k x[m, k] * w[k, n], folded into a carried accumulator once per
//          reference K-tile of `bk_ref` elements (the Pallas wrapper's
//          `min(512, round_up(K, 128))`), in tile order:
//            exact     carry + tile, int32 two's complement;
//            wrap      ... then wrapped to `acc_bits` (two's complement);
//            saturate  ... then clipped to the signed `acc_bits` range;
//          with `spill16` the carry is stored as int16 after every tile
//          (wraps exactly like `astype(int16)`; lossless when the A2Q bound
//          holds for acc_bits <= 16);
//   x    is either int8 codes, or (prologue, `aq` given) fp32 or bf16
//          activations quantized on the card: clip(rint(x / aq), lo, hi) -
//          shift, with `shift` 128 for unsigned 8-bit codes (symmetrized into
//          the int8 operand; the wrapper's offset adds 128 * colsum(w) back).
//          bf16 is widened to fp32 exactly first.  The division is IEEE
//          (__fdiv_rn, never a reciprocal) and rint rounds half to even, so
//          the codes equal the standalone act-quant's;
//   out  = (acc + offset[n]) * scale[n] (+ bias[n]) in fp32 when `scale` is
//          given (one rounded multiply, then one rounded add: __fmul_rn /
//          __fadd_rn keep nvcc from contracting them into an FMA, so the
//          scale-only output is bit-identical to the plain version), else
//          the raw int32 accumulator;
//   codes  (requant, `osc` given; the chained edges of --int-chain: rwkv6's
//          cm.wk -> relu^2 -> cm.wv and the non-gated MLP's w_in -> gelu ->
//          w_out) the flush's fp32 `out` cast to the layer's compute dtype
//          (__float2bfloat16_rn for bf16), the activation replayed: relu^2
//          there (the square of a bf16 value is exact in fp32 and is rounded
//          once back to bf16), or the tanh gelu in fp32, written out op by op
//          as the host computes it (x * (0.5 * (1 + tanhf(c * (x + 0.044715 *
//          x^3))))), each op rounded once with __fmul_rn/__fadd_rn so nvcc
//          contracts nothing into an FMA, then rounded once to bf16; back to
//          fp32, then clip(rint(y / osc[n]), lo, hi) - shift as int8: the next
//          linear's act-quant, dividing (__fdiv_rn) and rounding half to even,
//          so the codes equal the unchained path's wherever tanhf equals
//          PyTorch's tanh.
//
// Two kernels compute that one function; the wrapper picks by M (a constant,
// `TC_MIN_ROWS` in kernels/int_matmul.py):
//
// (1) M <= 16 (decode): `int_matmul_decode_kernel`.  What bounds it: M is the
// batch (1-16 rows), so each weight byte is used at most 16 times; the bound
// is the weight bytes over the 3.35 TB/s of HBM, and on small matrices
// (smollm's 576 x 192) the launch and the round trips to memory.  The design
// keeps 16-byte weight loads in flight on every SM:
//   * Split-K x column strips.  A block of 8 warps owns a 128-column strip
//     and one K split; the warps take turns at its 32-deep k steps (warp w
//     the steps w, w + 8, ...), each streaming its steps through its own
//     3-deep ring of `cp.async.cg` 16-byte copies, waited on with
//     `__syncwarp` only (no block barrier a step).  A copy instruction
//     reads four k rows of 128 contiguous bytes.  Two blocks fit an SM; the
//     wrapper picks the split count from N, K and the SM count alone (about
//     4 blocks an SM, at most 4 splits; never from a device value), and
//     every split starts on a reference K-tile boundary (`bk_ref`).
//   * Products on the int8 tensor cores: `mma.sync.m16n8k32`, x as the
//     16-row A operand (rows past M are zero), the N-major weight step
//     turned K-major on its way to the tensor cores by the tensor-core
//     kernel's `ldmatrix.trans` + `__byte_perm` trick and swizzle (below).
//     Taken over `__dp4a` after a `__byte_perm` register transpose because
//     the transpose's 8 permutes a 4 x 4 byte square plus M `__dp4a`s per
//     4 k-rows x 4 columns come to ~2-4 integer instructions a weight byte
//     at M = 8-16, on the edge of what an SM issues while it streams its
//     share of HBM; the mma path needs ~0.03.
//   * The prologue quantizes once a block: the block's x slice (at most 32
//     rows x a 1024-deep window, re-staged for longer slices) becomes int8
//     codes in shared memory, spread over all 256 threads while the first
//     weight steps fly; all eight warps read it.  Where x * (1 / aq) is not
//     within 2^-20 of a half-integer it rounds as the IEEE quotient does,
//     so only those few values take the IEEE division (`act_code_fast`).
//   * The warps' partial sums meet in shared memory (added with shared
//     atomics over the rings, once the last step is multiplied).
//   * Exact cross-split sum without a workspace: a strip's splits (at most
//     4; clusters of 8 measured slower) are launched as one thread-block
//     cluster.  After a cluster barrier the blocks share out the strip's
//     outputs and each adds every split's raw int32 sums through
//     distributed shared memory (integer addition is associative: the order
//     does not matter), then applies the one fold (sign extension to
//     min(acc_bits, 16) bits, see the carry below) and the epilogue; a
//     second barrier keeps every block's shared memory alive until it has
//     been read.  One launch a call, no global atomics, no ticket and no
//     state left between calls (a CUDA graph replays it as it is).  `saturate` is no homomorphism: it keeps one split a strip
//     and folds the block's sum at every reference K-tile.
//
// The wrapper's M < TC_MIN_ROWS sends it at most 16 rows; it takes up to 32
// (two m16 tiles) so that both kernels can be timed on either side of the
// edge.
//
// (2) M > 16 (prefill chunks, hubert's 8000-row encode): `int_matmul_tc_kernel`
// on the int8 tensor cores.  What bounds it: operations (2 M K N against the
// 1,979 TOP/s int8 peak) once M is in the thousands; bytes below ~300 rows.
//   * Products: `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` fed by
//     `ldmatrix`.  Chosen over `wgmma` because its fragment layouts are
//     fixed by the ISA and can be checked line by line without a compiler or
//     a card at hand, where wgmma's shared-memory descriptors (swizzle mode,
//     leading and stride offsets) show an error only as wrong numbers on the
//     card.  A block of 256 threads (8 warps, 2 x 4) owns a 128 x 128
//     output tile, each warp 64 x 32: 16 mmas a 32-deep k-step.
//   * Asynchronous copies: a 4-stage ring of 64-deep K-steps (x tile 128 x 64
//     and w tile 64 x 128, 16 KB a stage) filled by `cp.async.cg` 16-byte
//     copies (zero-filled past M, K and N by the copy's source size), one
//     barrier a step; the copies of step k + 3 fly while step k multiplies.
//     Rows that start on 8 bytes only (K or N a multiple of 8, not of 16:
//     hubert's 504-class head) take two 8-byte copies a chunk; other shapes
//     stage the same tiles through registers (same layout, slower).
//   * The weight tile is transposed on its way to the tensor cores, not in
//     memory: s8 mma wants B K-major (4 consecutive k of one column in a
//     register) and w is N-major.  The N-major tile is copied as it is; a
//     `ldmatrix.trans` over 16-bit pairs of it, whose eight row addresses
//     are the k rows {0,1,4,5,8,9,12,13} (+2 for the second matrix),
//     hands each thread 2 k x 2 n bytes per matrix, and two `__byte_perm`s
//     (selectors 0x6420 and 0x7531) turn two such words into the B
//     registers of columns 2g and 2g + 1.  So one mma computes the even
//     columns of a 16-column group and a second the odd ones, and in the
//     accumulators each thread holds 4 neighbouring columns of its rows.
//     Both tiles are XOR-swizzled by 16-byte chunk so that every ldmatrix
//     phase reads 8 distinct bank groups.
//   * The carry needs no per-tile fold on the main path.  For int8 operands
//     |x w| <= 2^14, so the int32 sum cannot overflow for K < 2^17 (18,432 *
//     2^14 < 2^31), and the tensor cores' int32 sum is the exact sum.
//     sign_extend to 16 (int16 carry) or to acc_bits (wrap) is reduction mod
//     2^n, which commutes with addition, so for `exact` (with or without the
//     int16 carry) and `wrap`, one sign extension to min(acc_bits, 16) bits
//     at the flush equals the reference's fold at every tile, bit for bit.
//     Only `saturate` is not a homomorphism: its template instance keeps a
//     partial (the mma accumulators) and a carry register set and folds at
//     every reference K-tile (`bk_ref` is a multiple of the 64-deep step).
//   * The prologue: with N / 128 column blocks every x tile would be
//     quantized N / 128 times (40 at hubert's mlp.w_in: 410 M IEEE divisions
//     and 1.6 GB of fp32 re-reads from L2 at M = 8000), so a separate pass
//     (`act_codes_kernel`, the same `act_code`) writes the int8 codes once
//     into a scratch buffer the wrapper allocates, and the product reads
//     them: the codes are the same, as the reference also quantizes inside
//     each grid block.
//   * The epilogue runs on the accumulator fragments: each thread reads
//     scale / bias / offset / osc once per column it owns, and writes its 4
//     neighbouring columns with one 16-byte (fp32, int32) or 4-byte (int8)
//     store where N is a multiple of 4; the arithmetic is the one
//     `epilogue` function both kernels call.
// The requant epilogue adds a handful of instructions a flushed output and
// writes a quarter of the fp32 output's bytes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Mode { kExact = 0, kWrap = 1, kSaturate = 2 };
enum Act { kActNone = 0, kActRelu2 = 1, kActGelu = 2 };

// jax.nn.gelu's tanh form in the host's op order, each op rounded once.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

__device__ __forceinline__ int add_wrap32(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int sign_extend(int v, int bits) {
  const int s = 32 - bits;
  return static_cast<int>(static_cast<unsigned>(v) << s) >> s;
}

// One reference K-tile folded into the carry: the Pallas body's
// `carried + tile`, the mode's wrap/clip, then the store into the carry dtype.
__device__ __forceinline__ int fold(int carry, int part, int mode, int acc_bits,
                                    int spill16) {
  int total = add_wrap32(carry, part);
  if (acc_bits < 32) {
    if (mode == kWrap) {
      total = sign_extend(total, acc_bits);
    } else if (mode == kSaturate) {
      const int hi = (1 << (acc_bits - 1)) - 1;
      total = min(max(total, -hi - 1), hi);
    }
  }
  return spill16 ? sign_extend(total, 16) : total;
}

// 16 bytes from `p`, zero past `valid` bytes; one 16-byte load when aligned.
__device__ __forceinline__ int4 load16(const int8_t* p, int valid) {
  if (valid >= 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    return __ldg(reinterpret_cast<const int4*>(p));
  }
  int v[4] = {0, 0, 0, 0};
  for (int j = 0; j < 16 && j < valid; ++j) {
    v[j >> 2] |= static_cast<int>(static_cast<uint8_t>(p[j])) << (8 * (j & 3));
  }
  return make_int4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The prologue's code of one fp32 activation: clip(rint(x / aq), lo, hi) -
// shift, dividing (never multiplying by a reciprocal) and rounding half to
// even, as the standalone act-quant computes it.
__device__ __forceinline__ int8_t act_code(float x, float aq, float lo, float hi, int shift) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, aq)), lo), hi)) -
                             shift);
}

// The requant epilogue's code of one flushed fp32 output `y`: the cast to
// the compute dtype, the activation replayed there, then the consumer's
// act-quant clip(rint(y / osc), lo, hi) - shift.
__device__ __forceinline__ int8_t requant_code(float y, float osc, float lo, float hi, int shift,
                                               int act, int cast_bf16) {
  if (cast_bf16) y = __bfloat162float(__float2bfloat16_rn(y));
  if (act == kActRelu2) {
    y = fmaxf(y, 0.0f);
    y = __fmul_rn(y, y);
    if (cast_bf16) y = __bfloat162float(__float2bfloat16_rn(y));
  } else if (act == kActGelu) {
    y = gelu_tanh(y);
    if (cast_bf16) y = __bfloat162float(__float2bfloat16_rn(y));
  }
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(y, osc)), lo), hi)) -
                             shift);
}

// The epilogue's operands and outputs (null where not given).
struct Epi {
  const float* scale;
  const float* bias;
  const int* offset;
  const float* osc;
  int r_lo, r_hi, r_shift, act, cast_bf16;
  float* out_f;
  int* out_i;
  int8_t* out_q;
};

// One output column's operands, read once per column.
struct Col {
  float sc, bi, os;
  int off;
};

__device__ __forceinline__ Col column(const Epi& e, int n) {
  Col c;
  c.sc = e.scale != nullptr ? e.scale[n] : 0.0f;
  c.bi = e.bias != nullptr ? e.bias[n] : 0.0f;
  c.off = e.offset != nullptr ? e.offset[n] : 0;
  c.os = e.osc != nullptr ? e.osc[n] : 1.0f;
  return c;
}

// One flushed accumulator through the epilogue: the raw int32, the fp32
// (acc + offset) * scale (+ bias), or its requant code.
__device__ __forceinline__ float scaled(const Epi& e, const Col& c, int acc) {
  float y = __fmul_rn(__int2float_rn(add_wrap32(acc, c.off)), c.sc);
  if (e.bias != nullptr) y = __fadd_rn(y, c.bi);
  return y;
}

__device__ __forceinline__ int8_t requant(const Epi& e, const Col& c, int acc) {
  return requant_code(scaled(e, c, acc), c.os, static_cast<float>(e.r_lo),
                      static_cast<float>(e.r_hi), e.r_shift, e.act, e.cast_bf16);
}

__device__ __forceinline__ void store_one(const Epi& e, const Col& c, size_t o, int acc) {
  if (e.scale == nullptr) {
    e.out_i[o] = acc;
  } else if (e.osc != nullptr) {
    e.out_q[o] = requant(e, c, acc);
  } else {
    e.out_f[o] = scaled(e, c, acc);
  }
}

// Four neighbouring flushed accumulators of one row (columns `o` .. `o` + 3,
// of which `left` are inside N) through the epilogue: one 16-byte (fp32,
// int32) or 4-byte (int8) store when `vec` (N a multiple of 4), else one
// store a column.
__device__ __forceinline__ void store4(const Epi& e, const Col (&cols)[4], size_t o,
                                       const int (&v)[4], bool vec, int left) {
  if (vec) {
    if (e.scale == nullptr) {
      *reinterpret_cast<int4*>(e.out_i + o) = make_int4(v[0], v[1], v[2], v[3]);
    } else if (e.osc != nullptr) {
      unsigned u = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        u |= static_cast<unsigned>(static_cast<uint8_t>(requant(e, cols[c], v[c]))) << (8 * c);
      *reinterpret_cast<unsigned*>(e.out_q + o) = u;
    } else {
      *reinterpret_cast<float4*>(e.out_f + o) =
          make_float4(scaled(e, cols[0], v[0]), scaled(e, cols[1], v[1]),
                      scaled(e, cols[2], v[2]), scaled(e, cols[3], v[3]));
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < left) store_one(e, cols[c], o + c, v[c]);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (M > 16) and its prologue pass.

namespace tc {
constexpr int BM = 128;                  // output rows per block
constexpr int BN = 128;                  // output columns per block
constexpr int BK = 64;                   // K elements per pipeline stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;             // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;                   // warp tile rows
constexpr int WN = 32;                   // warp tile columns
constexpr int MT = WM / 16;              // m16 tiles a warp
constexpr int NG = WN / 16;              // 16-column groups a warp (two n8 mmas each)
constexpr int XS = BM * BK;              // x tile bytes: 128 rows of 64 (4 chunks of 16)
constexpr int WS = BK * BN;              // w tile bytes: 64 k rows of 128 (8 chunks)
constexpr int STAGE = XS + WS;
constexpr int SMEM = STAGES * STAGE;     // 64 KB
constexpr int CODES_PER_THREAD = 8;      // the prologue pass
constexpr int CODES_THREADS = 256;
}  // namespace tc

// Byte offset of 16-byte chunk `c` of x-tile row `m` (rows of 64 bytes): the
// chunk index XORed with bits 1-2 of the row, so the 8 rows an ldmatrix
// phase reads land in 8 distinct bank groups.
__device__ __forceinline__ int xs_off(int m, int c) { return m * 64 + 16 * (c ^ ((m >> 1) & 3)); }

// Byte offset of chunk `c` of w-tile row `k` (rows of 128 bytes): XORed with
// k's bits 0, 2 and 3, distinct over the k rows {0,1,4,5,8,9,12,13} (+2,
// +16, +32) that one transposing ldmatrix reads.
__device__ __forceinline__ int ws_off(int k, int c) {
  return k * 128 + 16 * (c ^ ((k & 1) | (((k >> 2) & 3) << 1)));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes past `src_bytes` are zero.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The same as two 8-byte copies, for rows that start on 8 bytes only.
__device__ __forceinline__ void cp_async8x2(unsigned dst, const int8_t* src, bool lo, bool hi) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(lo ? 8 : 0)
               : "memory");
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst + 8),
               "l"(hi ? src + 8 : src), "r"(hi ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned& r0, unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned& r0, unsigned& r1, unsigned& r2,
                                          unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16 x 32 s8, row) * b (32 x 8 s8, col), int32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The prologue pass of the tensor-core route: `n` activations (fp32 or bf16)
// to their int8 codes, 8 a thread.
template <typename TX>
__global__ void __launch_bounds__(tc::CODES_THREADS)
act_codes_kernel(const TX* __restrict__ x, long long n, const float* __restrict__ aq, int q_lo,
                 int q_hi, int q_shift, int8_t* __restrict__ codes) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * tc::CODES_THREADS + threadIdx.x) * tc::CODES_PER_THREAD;
  if (i0 >= n) return;
  const float s_aq = *aq;
  const float lo = static_cast<float>(q_lo);
  const float hi = static_cast<float>(q_hi);
  if (i0 + tc::CODES_PER_THREAD <= n && (reinterpret_cast<uintptr_t>(x + i0) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(codes + i0) & 7) == 0) {
    float f[8];
    if constexpr (std::is_same<TX, float>::value) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(x + i0));
      const float4 b = __ldg(reinterpret_cast<const float4*>(x + i0) + 1);
      const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = v[j];
    } else {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(x + i0));
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[2 * j] = __uint_as_float(w[j] << 16);
        f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
    unsigned v[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(act_code(f[j], s_aq, lo, hi, q_shift)))
                   << (8 * (j & 3));
    *reinterpret_cast<uint2*>(codes + i0) = make_uint2(v[0], v[1]);
  } else {
    for (long long i = i0; i < n && i < i0 + tc::CODES_PER_THREAD; ++i)
      codes[i] = act_code(to_f32(x[i]), s_aq, lo, hi, q_shift);
  }
}

// kCopy 16: every row of x and w starts on 16 bytes (K and N multiples of
// 16), the stages are filled by 16-byte cp.async; 8: rows start on 8 bytes,
// two 8-byte cp.async a chunk; 0: through registers.
// kSat: `saturate` below 32 bits, folded at every reference K-tile.
template <int kCopy, bool kSat>
__global__ void __launch_bounds__(tc::THREADS, kSat ? 1 : 2)
int_matmul_tc_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, int M, int N,
                     int K, int bk_ref, int acc_bits, int spill16, int flush_bits, Epi epi) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 0..1
  const int wn = warp & 3;   // 0..3
  const int n0 = blockIdx.x * tc::BN;
  const int m0 = blockIdx.y * tc::BM;
  const int KT = (K + tc::BK - 1) / tc::BK;

  // two 16-byte chunks of x and two of w a thread a stage
  auto load_stage = [&](int slot, int k0) {
    uint8_t* xs = smem + slot * tc::STAGE;
    uint8_t* ws = xs + tc::XS;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + j * tc::THREADS;
      const int r = e >> 2, c = e & 3;      // x: row, chunk
      const int kr = e >> 3, wc = e & 7;    // w: k row, chunk
      const int gm = m0 + r, gk = k0 + 16 * c;
      const int gkw = k0 + kr, gn = n0 + 16 * wc;
      const int8_t* xp = x + static_cast<size_t>(gm) * K + gk;
      const int8_t* wp = w + static_cast<size_t>(gkw) * N + gn;
      if constexpr (kCopy == 16) {
        const bool xin = gm < M && gk < K;
        const bool win = gkw < K && gn < N;
        cp_async16(smem_u32(xs + xs_off(r, c)), xin ? xp : x, xin ? 16 : 0);
        cp_async16(smem_u32(ws + ws_off(kr, wc)), win ? wp : w, win ? 16 : 0);
      } else if constexpr (kCopy == 8) {  // K and N multiples of 8: halves wholly in or out
        const bool xrow = gm < M;
        const bool wrow = gkw < K;
        cp_async8x2(smem_u32(xs + xs_off(r, c)), xrow && gk < K ? xp : x, xrow && gk < K,
                    xrow && gk + 8 < K);
        cp_async8x2(smem_u32(ws + ws_off(kr, wc)), wrow && gn < N ? wp : w, wrow && gn < N,
                    wrow && gn + 8 < N);
      } else {
        *reinterpret_cast<int4*>(xs + xs_off(r, c)) = load16(xp, gm < M ? K - gk : 0);
        *reinterpret_cast<int4*>(ws + ws_off(kr, wc)) = load16(wp, gkw < K ? N - gn : 0);
      }
    }
  };

  int acc[tc::MT][tc::NG][2][4];
  int carry[kSat ? tc::MT : 1][tc::NG][2][4];
#pragma unroll
  for (int i = 0; i < tc::MT; ++i)
#pragma unroll
    for (int j = 0; j < tc::NG; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[i][j][e][r] = 0;
          if constexpr (kSat) carry[i][j][e][r] = 0;
        }

#pragma unroll
  for (int s = 0; s < tc::STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s * tc::BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<tc::STAGES - 2>();  // this thread's copies of step kt have landed
    __syncthreads();              // everyone's have; everyone is done with step kt - 1
    {
      const int nk = kt + tc::STAGES - 1;  // into step kt - 1's slot
      if (nk < KT) load_stage(nk % tc::STAGES, nk * tc::BK);
      cp_async_commit();
    }
    const uint8_t* xs = smem + (kt % tc::STAGES) * tc::STAGE;
    const uint8_t* ws = xs + tc::XS;
#pragma unroll
    for (int kk = 0; kk < tc::BK / 32; ++kk) {
      // A: rows (lane & 7) + 8 (matrix & 1) of each m16 tile, chunk 2 kk + (matrix >> 1)
      unsigned a[tc::MT][4];
#pragma unroll
      for (int i = 0; i < tc::MT; ++i) {
        const int row = wm * tc::WM + 16 * i + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldsm_x4(smem_u32(xs + xs_off(row, 2 * kk + (lane >> 4))), a[i][0], a[i][1], a[i][2],
                a[i][3]);
      }
      // B: matrix j of the transposing load reads k rows
      // 16 (j >> 1) + 2 (j & 1) + {0,1,4,5,8,9,12,13} of the 16 columns'
      // chunk; thread (g, q) gets W[k][2g], W[k][2g+1] for k = 4q, 4q+1 (j even)
      // or 4q+2, 4q+3 (j odd), and the byte permutes gather each column's 4 k
      unsigned b[tc::NG][2][2];
      {
        const int r = lane & 7, mi = lane >> 3;
        const int k = 32 * kk + 16 * (mi >> 1) + 2 * (mi & 1) + 4 * (r >> 1) + (r & 1);
#pragma unroll
        for (int j = 0; j < tc::NG; ++j) {
          unsigned r0, r1, r2, r3;
          ldsm_x4_t(smem_u32(ws + ws_off(k, 2 * wn + j)), r0, r1, r2, r3);
          b[j][0][0] = __byte_perm(r0, r1, 0x6420);  // column 2g, k 4q..4q+3
          b[j][1][0] = __byte_perm(r0, r1, 0x7531);  // column 2g + 1
          b[j][0][1] = __byte_perm(r2, r3, 0x6420);  // the same at k + 16
          b[j][1][1] = __byte_perm(r2, r3, 0x7531);
        }
      }
#pragma unroll
      for (int i = 0; i < tc::MT; ++i)
#pragma unroll
        for (int j = 0; j < tc::NG; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) mma_s8(acc[i][j][e], a[i], b[j][e][0], b[j][e][1]);
    }
    if constexpr (kSat) {
      // bk_ref is a multiple of the step, so a step never straddles a reference tile
      const int next = (kt + 1) * tc::BK;
      if (next % bk_ref == 0 || kt + 1 == KT) {
#pragma unroll
        for (int i = 0; i < tc::MT; ++i)
#pragma unroll
          for (int j = 0; j < tc::NG; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                carry[i][j][e][r] =
                    fold(carry[i][j][e][r], acc[i][j][e][r], kSaturate, acc_bits, spill16);
                acc[i][j][e][r] = 0;
              }
      }
    }
  }
  cp_async_wait<0>();

  // the flush: thread (g, q) holds rows g, g + 8 of each m16 tile and, in
  // each 16-column group, columns 4q .. 4q + 3 (even mma: 4q, 4q + 2; odd:
  // 4q + 1, 4q + 3)
  const int g = lane >> 2, q = lane & 3;
  const bool vec = (N & 3) == 0;
#pragma unroll
  for (int j = 0; j < tc::NG; ++j) {
    const int col0 = n0 + wn * tc::WN + 16 * j + 4 * q;
    if (col0 >= N) continue;
    Col cols[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) cols[c] = column(epi, min(col0 + c, N - 1));
#pragma unroll
    for (int i = 0; i < tc::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * tc::WM + 16 * i + g + 8 * h;
        if (row >= M) continue;
        int v[4];
        if constexpr (kSat) {
          v[0] = carry[i][j][0][2 * h];
          v[1] = carry[i][j][1][2 * h];
          v[2] = carry[i][j][0][2 * h + 1];
          v[3] = carry[i][j][1][2 * h + 1];
        } else {
          v[0] = sign_extend(acc[i][j][0][2 * h], flush_bits);
          v[1] = sign_extend(acc[i][j][1][2 * h], flush_bits);
          v[2] = sign_extend(acc[i][j][0][2 * h + 1], flush_bits);
          v[3] = sign_extend(acc[i][j][1][2 * h + 1], flush_bits);
        }
        store4(epi, cols, static_cast<size_t>(row) * N + col0, v, vec, N - col0);
      }
  }
}

template <int kCopy, bool kSat>
int launch_tc(const int8_t* x, const int8_t* w, int M, int N, int K, int bk_ref, int acc_bits,
              int spill16, int flush_bits, const Epi& epi, cudaStream_t s) {
  static bool sized = false;  // shared memory above 48 KB must be asked for once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(int_matmul_tc_kernel<kCopy, kSat>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 tc::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid((N + tc::BN - 1) / tc::BN, (M + tc::BM - 1) / tc::BM);
  int_matmul_tc_kernel<kCopy, kSat><<<grid, tc::THREADS, tc::SMEM, s>>>(
      x, w, M, N, K, bk_ref, acc_bits, spill16, flush_bits, epi);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The decode kernel (M <= 32 rows; the wrapper's route sends it M <= 16).

namespace dec {
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 2;            // blocks an SM (caps the registers at 128)
constexpr int BN = 128;                  // columns a block (a strip); every warp takes all
constexpr int RG = THREADS / BN;         // row groups: thread t owns column t % BN
constexpr int BK = 32;                   // k rows a warp step: one mma depth
constexpr int ROUND = WARPS * BK;        // 256 k: one step of each warp
constexpr int STAGES = 3;                // a warp's ring: 2 steps in flight + 1 multiplied
constexpr int STEP = BK * BN;            // 4 KB: one warp step of w
constexpr int RING = WARPS * STAGES * STEP;
constexpr int XWIN = 1024;               // k of x codes staged at a time (a multiple of ROUND)
constexpr int MAX_ROWS = 32;
constexpr int MAX_SPLITS = 4;            // a strip's splits form one cluster
constexpr int RED_PITCH = BN + 8;        // ints a row of the block's sums in shared memory
constexpr int XB = 4;                    // x words a thread loads before it quantizes them
}  // namespace dec

// The decode kernel's scalar arguments.
struct Dec {
  int M, N, K, bk_ref, acc_bits, spill16, flush_bits;
  int k_split;      // k elements a split (a multiple of bk_ref); gridDim.y splits, one cluster
  int x_rows;       // staged x rows: 8, 16 or 32 (rows past M are zero)
  int x_win;        // staged x window: a multiple of dec::ROUND, at most dec::XWIN
  const float* aq;  // the prologue's scale (null: x is int8 codes)
  int q_lo, q_hi, q_shift;
  int copy16;       // w's rows start on 16 bytes (N % 16 == 0, w aligned)
};

// The decode kernel's shared memory: the x window's codes, the warps' rings
// of w steps, and the block's sums (over the rings once the steps are done;
// apart from them for `saturate`, which sums at every K-tile).
__host__ __device__ constexpr int dec_xs_bytes(int x_rows, int x_win) {
  return x_rows * (x_win + 16);
}
__host__ __device__ constexpr int dec_red_bytes(int x_rows) {
  return x_rows * dec::RED_PITCH * 4;
}
__host__ __device__ constexpr int dec_smem_bytes(int x_rows, int x_win, bool sat) {
  return dec_xs_bytes(x_rows, x_win) +
         (sat ? dec::RING + dec_red_bytes(x_rows)
              : (dec::RING > dec_red_bytes(x_rows) ? dec::RING : dec_red_bytes(x_rows)));
}

// The prologue's code by the reciprocal where that is safe: x * (1 / aq)
// lies within 2^-22 relative of x / aq (two roundings), so unless it is
// within 2^-20 (relative, plus 2^-20 absolute for the fraction's own
// rounding) of a half-integer, it rounds to the same integer as the IEEE
// quotient; near one (and for NaN or inf) the IEEE division decides.  The
// codes are act_code's, bit for bit.
__device__ __forceinline__ int8_t act_code_fast(float x, float aq, float r, float lo, float hi,
                                                int shift) {
  const float q = __fmul_rn(x, r);
  const float f = q - floorf(q);
  if (fabsf(f - 0.5f) > fabsf(q) * 0x1p-20f + 0x1p-20f)
    return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(q), lo), hi)) - shift);
  return act_code(x, aq, lo, hi, shift);
}

// Four consecutive x elements as loaded: int8 codes in one word, or fp32.
template <typename TX>
struct X4 {
  float f[4];
};
template <>
struct X4<int8_t> {
  unsigned u;
};

// Four consecutive x elements from `p`, zero past `valid`; one load when
// `vec` (4-element aligned).
template <typename TX>
__device__ __forceinline__ X4<TX> x_load4(const TX* p, int valid, bool vec) {
  X4<TX> r;
  if constexpr (std::is_same<TX, int8_t>::value) {
    r.u = 0;
    if (vec && valid >= 4) {
      r.u = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
      for (int j = 0; j < 4 && j < valid; ++j)
        r.u |= static_cast<unsigned>(static_cast<uint8_t>(p[j])) << (8 * j);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) r.f[j] = 0.0f;
    if (vec && valid >= 4) {
      if constexpr (std::is_same<TX, float>::value) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        r.f[0] = v.x;
        r.f[1] = v.y;
        r.f[2] = v.z;
        r.f[3] = v.w;
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        r.f[0] = __uint_as_float(v.x << 16);
        r.f[1] = __uint_as_float(v.x & 0xffff0000u);
        r.f[2] = __uint_as_float(v.y << 16);
        r.f[3] = __uint_as_float(v.y & 0xffff0000u);
      }
    } else {
      for (int j = 0; j < 4 && j < valid; ++j) r.f[j] = to_f32(p[j]);
    }
  }
  return r;
}

// The loaded elements as four int8 codes in one word (the prologue's code of
// each of the first `valid`, zero after).
template <typename TX>
__device__ __forceinline__ unsigned x_codes4(const X4<TX>& v, int valid, float aq, float r,
                                             float lo, float hi, int shift) {
  if constexpr (std::is_same<TX, int8_t>::value) {
    return v.u;
  } else {
    unsigned u = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < valid)
        u |= static_cast<unsigned>(static_cast<uint8_t>(act_code_fast(v.f[j], aq, r, lo, hi,
                                                                      shift)))
             << (8 * j);
    return u;
  }
}

// TX: int8_t codes, or fp32 / bf16 through the prologue.  MT: m16 tiles
// (rows up to 16 MT).  kSat: `saturate` below 32 bits, folded at every
// reference K-tile (one split; bk_ref a multiple of dec::ROUND).  w rows
// that start on 16 bytes (`d.copy16`) are copied by cp.async, others staged
// through registers.
template <typename TX, int MT, bool kSat>
__global__ void __launch_bounds__(dec::THREADS, dec::MIN_BLOCKS)
int_matmul_decode_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w, Dec d, Epi epi) {
  constexpr bool kPrologue = !std::is_same<TX, int8_t>::value;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int M = d.M, N = d.N, K = d.K;
  const int splits = gridDim.y;
  const int n0 = blockIdx.x * dec::BN;
  const int k_begin = blockIdx.y * d.k_split;
  const int k_end = min(K, k_begin + d.k_split);
  const int nsteps = k_end > k_begin ? (k_end - k_begin + dec::BK - 1) / dec::BK : 0;
  const int rounds = (nsteps + dec::WARPS - 1) / dec::WARPS;
  const int xpitch = d.x_win + 16;  // (x_win / 4 + 4) words: conflict-free A reads
  uint8_t* xs = smem;               // x_rows x xpitch codes of the current window
  uint8_t* rings = smem + dec_xs_bytes(d.x_rows, d.x_win);
  uint8_t* ring = rings + warp * dec::STAGES * dec::STEP;
  int* red = reinterpret_cast<int*>(kSat ? rings + dec::RING : rings);  // [row][col] sums

  // warp step s (k rows k_begin + 32 s ..) of the strip: 32 x 128 bytes, eight
  // 16-byte chunks a lane, four rows of 128 contiguous bytes a copy
  // instruction; rows past the split's end and columns past N are zero
  auto load_step = [&](int slot, int s) {
    uint8_t* dst = ring + slot * dec::STEP;
    const int k0 = k_begin + s * dec::BK;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane + 32 * i;
      const int kr = e >> 3, c = e & 7;
      const int gk = k0 + kr, gn = n0 + 16 * c;
      const int8_t* src = w + static_cast<size_t>(gk) * N + gn;
      if (d.copy16) {
        const bool in = gk < k_end && gn < N;
        cp_async16(smem_u32(dst + ws_off(kr, c)), in ? src : w, in ? 16 : 0);
      } else {
        *reinterpret_cast<int4*>(dst + ws_off(kr, c)) = load16(src, gk < k_end ? N - gn : 0);
      }
    }
  };

  // the block's x window starting at k = kw0, as int8 codes, by all threads;
  // each thread issues dec::XB loads before it quantizes any
  const float s_aq = kPrologue ? __ldg(d.aq) : 1.0f;
  const float r_aq = kPrologue ? __frcp_rn(s_aq) : 1.0f;
  const float lo = static_cast<float>(d.q_lo);
  const float hi = static_cast<float>(d.q_hi);
  const bool xvec = (K & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto stage_x = [&](int kw0) {
    const int words = d.x_win / 4;
    const int total = d.x_rows * words;
    for (int base = 0; base < total; base += dec::THREADS * dec::XB) {
      X4<TX> v[dec::XB];
      int valid[dec::XB];
#pragma unroll
      for (int u = 0; u < dec::XB; ++u) {
        const int e = base + tid + u * dec::THREADS;
        const int r = e / words, k = kw0 + 4 * (e - r * words);
        valid[u] = e < total && r < M ? k_end - k : 0;
        v[u] = x_load4(x + static_cast<size_t>(r < M ? r : 0) * K + k, valid[u], xvec);
      }
#pragma unroll
      for (int u = 0; u < dec::XB; ++u) {
        const int e = base + tid + u * dec::THREADS;
        if (e >= total) break;
        const int r = e / words, kq = e - r * words;
        *reinterpret_cast<unsigned*>(xs + r * xpitch + 4 * kq) =
            valid[u] > 0 ? x_codes4(v[u], valid[u], s_aq, r_aq, lo, hi, d.q_shift) : 0u;
      }
    }
  };

  int acc[MT][8][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][e][r] = 0;
  constexpr int OWN = dec::MAX_ROWS / dec::RG;  // rows a thread owns: rg, rg + RG, ...
  int carry[kSat ? OWN : 1];  // saturate: thread t's column, its rows
#pragma unroll
  for (int i = 0; i < (kSat ? OWN : 1); ++i) carry[i] = 0;
  const int col = tid % dec::BN, rg = tid / dec::BN;

  // this warp's fragments added into the block's zeroed sums (4 neighbouring
  // columns of rows g, g + 8 of each m16 tile, per 16-column chunk, as the
  // tensor-core kernel's flush holds them); shared-memory integer atomics,
  // in any order: the sums are exact mod 2^32
  auto dump = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * i + g + 8 * h;
        if (row >= d.x_rows) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          int* p = red + row * dec::RED_PITCH + 16 * j + 4 * q;
          atomicAdd(p, acc[i][j][0][2 * h]);
          atomicAdd(p + 1, acc[i][j][1][2 * h]);
          atomicAdd(p + 2, acc[i][j][0][2 * h + 1]);
          atomicAdd(p + 3, acc[i][j][1][2 * h + 1]);
        }
      }
  };
  auto zero_red = [&]() {
    for (int e = tid; e < d.x_rows * dec::RED_PITCH; e += dec::THREADS) red[e] = 0;
  };
  // the block's sum of row m in thread t's column (mod 2^32)
  auto summed = [&](int m) { return red[m * dec::RED_PITCH + col]; };

#pragma unroll
  for (int r = 0; r < dec::STAGES - 1; ++r) {  // the first steps fly while x is quantized
    const int s = warp + dec::WARPS * r;
    if (s < nsteps) load_step(r, s);
    cp_async_commit();
  }
  stage_x(k_begin);
  if constexpr (kSat) zero_red();
  __syncthreads();
  const int wrounds = d.x_win / dec::ROUND;
  for (int r = 0; r < rounds; ++r) {
    if (r > 0 && r % wrounds == 0) {  // the next window of x codes
      __syncthreads();
      stage_x(k_begin + r * dec::ROUND);
      __syncthreads();
    }
    cp_async_wait<dec::STAGES - 2>();  // this lane's copies of round r's step have landed
    __syncwarp();                      // every lane's have; all are done with round r - 1
    {
      const int nr = r + dec::STAGES - 1;  // into round r - 1's slot
      const int ns = warp + dec::WARPS * nr;
      if (ns < nsteps) load_step(nr % dec::STAGES, ns);
      cp_async_commit();
    }
    const int s = warp + dec::WARPS * r;
    if (s < nsteps) {
      const uint8_t* wst = ring + (r % dec::STAGES) * dec::STEP;
      const int kx = (r % wrounds) * dec::ROUND + warp * dec::BK;  // in the window
      // A (row layout): rows g, g + 8 of each m16 tile, k 4q..4q+3 and 16 + 4q..
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint8_t* r0 = xs + (16 * i + g) * xpitch + kx + 4 * q;
        a[i][0] = *reinterpret_cast<const unsigned*>(r0);
        a[i][2] = *reinterpret_cast<const unsigned*>(r0 + 16);
        if (d.x_rows > 16 * i + 8) {
          a[i][1] = *reinterpret_cast<const unsigned*>(r0 + 8 * xpitch);
          a[i][3] = *reinterpret_cast<const unsigned*>(r0 + 8 * xpitch + 16);
        } else {
          a[i][1] = 0u;
          a[i][3] = 0u;
        }
      }
      // B: the tensor-core kernel's transposing loads and byte permutes, one
      // 16-column chunk j at a time
      const int rr = lane & 7, mi = lane >> 3;
      const int k = 16 * (mi >> 1) + 2 * (mi & 1) + 4 * (rr >> 1) + (rr & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        unsigned r0, r1, r2, r3;
        ldsm_x4_t(smem_u32(wst + ws_off(k, j)), r0, r1, r2, r3);
        const unsigned b00 = __byte_perm(r0, r1, 0x6420), b10 = __byte_perm(r0, r1, 0x7531);
        const unsigned b01 = __byte_perm(r2, r3, 0x6420), b11 = __byte_perm(r2, r3, 0x7531);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_s8(acc[i][j][0], a[i], b00, b01);
          mma_s8(acc[i][j][1], a[i], b10, b11);
        }
      }
    }
    if constexpr (kSat) {  // k_begin is 0: fold every K-tile's sum into the carry
      const int next = (r + 1) * dec::ROUND;
      if (next % d.bk_ref == 0 || r + 1 == rounds) {
        dump();
        __syncthreads();
#pragma unroll
        for (int i = 0; i < OWN; ++i)
          if (rg + dec::RG * i < M) {
            carry[i] = fold(carry[i], summed(rg + dec::RG * i), kSaturate, d.acc_bits, d.spill16);
            red[(rg + dec::RG * i) * dec::RED_PITCH + col] = 0;  // for the next tile
          }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[i][j][e][c] = 0;
        __syncthreads();  // the sums are read before the next tile's dump
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (!kSat) {  // the rings become the block's sums
    __syncthreads();
    zero_red();
    __syncthreads();
    dump();
  }
  __syncthreads();

  // thread t owns column n0 + t % BN of rows t / BN, + RG, ...
  const int n = n0 + col;
  const bool live = n < N;
  auto total = [&](int i) {  // row rg + RG i
    if constexpr (kSat) {
#pragma unroll
      for (int ii = 0; ii < OWN; ++ii)
        if (ii == i) return carry[ii];
      return 0;
    } else {
      return summed(rg + dec::RG * i);
    }
  };
  if (splits == 1) {  // the block's sums are the whole sums: flush them
    if (!live) return;
    const Col cl = column(epi, n);
    for (int i = 0, m = rg; m < M; ++i, m += dec::RG)
      store_one(epi, cl, static_cast<size_t>(m) * N + n, sign_extend(total(i), d.flush_bits));
    return;
  }
  // several splits: the strip's splits are one thread-block cluster; each
  // holds its raw int32 sums in shared memory, and the cluster's blocks
  // share out the outputs, each adding every split's sum (through
  // distributed shared memory, mod 2^32: any order gives the same bits)
  // before the one fold and the epilogue
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's sums are in its shared memory
  const int* parts[dec::MAX_SPLITS];
#pragma unroll
  for (int r = 0; r < dec::MAX_SPLITS; ++r)
    parts[r] = r < splits ? cluster.map_shared_rank(red, r) : red;
  for (int e = blockIdx.y * dec::THREADS + tid; e < M * dec::BN; e += splits * dec::THREADS) {
    const int m = e / dec::BN, c = e % dec::BN;
    if (n0 + c >= N) continue;
    int v[dec::MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < dec::MAX_SPLITS; ++r)  // every load in flight, then the sum
      v[r] = r < splits ? parts[r][m * dec::RED_PITCH + c] : 0;
    int sum = 0;
#pragma unroll
    for (int r = 0; r < dec::MAX_SPLITS; ++r) sum = add_wrap32(sum, v[r]);
    store_one(epi, column(epi, n0 + c), static_cast<size_t>(m) * N + n0 + c,
              sign_extend(sum, d.flush_bits));
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

template <typename TX, int MT, bool kSat>
int launch_dec(const void* x, const int8_t* w, const Dec& d, int splits, const Epi& epi,
               cudaStream_t s) {
  auto kernel = int_matmul_decode_kernel<TX, MT, kSat>;
  static bool sized = false;  // shared memory above 48 KB must be asked for once
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dec_smem_bytes(dec::MAX_ROWS, dec::XWIN, kSat));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d.N + dec::BN - 1) / dec::BN, splits);
  cfg.blockDim = dim3(dec::THREADS);
  cfg.dynamicSmemBytes = dec_smem_bytes(d.x_rows, d.x_win, kSat);
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = splits;  // a strip's splits
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TX*>(x), w, d, epi);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename TX>
int launch_dec_rows(const void* x, const int8_t* w, const Dec& d, int splits, bool sat,
                    const Epi& epi, cudaStream_t s) {
  if (d.M <= 16)
    return sat ? launch_dec<TX, 1, true>(x, w, d, splits, epi, s)
               : launch_dec<TX, 1, false>(x, w, d, splits, epi, s);
  return sat ? launch_dec<TX, 2, true>(x, w, d, splits, epi, s)
             : launch_dec<TX, 2, false>(x, w, d, splits, epi, s);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Shapes
// and pointers are validated by the Python wrapper; `bk_ref` must be a
// positive multiple of 64.  `out_q` (int8) is written when `osc` is given,
// else `out_f` when `scale` is given, else `out_i`.  With `aq` (one fp32
// value on the device) `x` is fp32, or bf16 when `x_bf16`, and the prologue
// quantizes it to [q_lo, q_hi] minus `q_shift`; else `x` is int8.  With `osc`
// ((N,) fp32, needs `scale`) the epilogue replays `act` (0 none, 1 relu^2 in
// the cast dtype, 2 tanh gelu in fp32) after a cast to bf16 when `cast_bf16`
// (else fp32), and requantizes to [r_lo, r_hi] minus `r_shift`.  `tc` picks
// the tensor-core kernel; with the prologue it then needs `codes`, an (M, K)
// int8 scratch buffer for the prologue pass's codes.  Otherwise the decode
// kernel runs (M <= 32) over `splits` (at most 4) K splits of `k_split`
// elements (a multiple of `bk_ref`; for `saturate` below 32 bits one split
// and `bk_ref` a multiple of 256), a strip's splits one cluster.
extern "C" int int_matmul_launch(const void* x, const void* w, int M, int N,
                                 int K, int bk_ref, int mode, int acc_bits,
                                 int spill16, const void* scale,
                                 const void* bias, const void* offset,
                                 const void* aq, int q_lo, int q_hi, int q_shift,
                                 const void* osc, int r_lo, int r_hi, int r_shift, int act,
                                 int cast_bf16, void* out_f, void* out_i, void* out_q,
                                 int x_bf16, int tc_route, void* codes, void* stream,
                                 int splits, int k_split) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* a = static_cast<const float*>(aq);
  const Epi epi{static_cast<const float*>(scale), static_cast<const float*>(bias),
                static_cast<const int*>(offset), static_cast<const float*>(osc),
                r_lo, r_hi, r_shift, act, cast_bf16,
                static_cast<float*>(out_f), static_cast<int*>(out_i), static_cast<int8_t*>(out_q)};
  const bool sat = mode == kSaturate && acc_bits < 32;
  // exact and wrap: the per-tile folds reduce mod 2^flush_bits, once at the flush
  int flush_bits = mode == kWrap && acc_bits < 32 ? acc_bits : 32;
  if (spill16) flush_bits = min(flush_bits, 16);
  if (tc_route) {
    const int8_t* xc = static_cast<const int8_t*>(x);
    if (aq != nullptr && K > 0) {
      const long long n = static_cast<long long>(M) * K;
      const long long per_block = static_cast<long long>(tc::CODES_THREADS) * tc::CODES_PER_THREAD;
      const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
      auto* cp = static_cast<int8_t*>(codes);
      if (x_bf16) {
        act_codes_kernel<__nv_bfloat16><<<blocks, tc::CODES_THREADS, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), n, a, q_lo, q_hi, q_shift, cp);
      } else {
        act_codes_kernel<float><<<blocks, tc::CODES_THREADS, 0, s>>>(
            static_cast<const float*>(x), n, a, q_lo, q_hi, q_shift, cp);
      }
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      xc = cp;
    }
    const auto aligned = [&](int bytes) {
      return K % bytes == 0 && N % bytes == 0 &&
             (reinterpret_cast<uintptr_t>(xc) % bytes) == 0 &&
             (reinterpret_cast<uintptr_t>(wp) % bytes) == 0;
    };
#define INT_MATMUL_TC(COPY)                                                                  \
  return sat ? launch_tc<COPY, true>(xc, wp, M, N, K, bk_ref, acc_bits, spill16, flush_bits, \
                                     epi, s)                                                 \
             : launch_tc<COPY, false>(xc, wp, M, N, K, bk_ref, acc_bits, spill16, flush_bits, \
                                      epi, s)
    if (aligned(16)) INT_MATMUL_TC(16);
    if (aligned(8)) INT_MATMUL_TC(8);
    INT_MATMUL_TC(0);
#undef INT_MATMUL_TC
  }
  if (M > dec::MAX_ROWS || splits < 1 || k_split < bk_ref || k_split % bk_ref != 0 ||
      splits > dec::MAX_SPLITS || (sat && (splits > 1 || bk_ref % dec::ROUND != 0)) ||
      static_cast<long long>(splits - 1) * k_split >= (K > 0 ? K : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int span = min(k_split, K > 0 ? K : 1);
  const Dec d{M, N, K, bk_ref, acc_bits, spill16, flush_bits, k_split,
              M <= 8 ? 8 : (M <= 16 ? 16 : 32),
              min((span + dec::ROUND - 1) / dec::ROUND * dec::ROUND, dec::XWIN),
              a, q_lo, q_hi, q_shift,
              N % 16 == 0 && (reinterpret_cast<uintptr_t>(wp) & 15) == 0};
  if (aq == nullptr) return launch_dec_rows<int8_t>(x, wp, d, splits, sat, epi, s);
  if (x_bf16) return launch_dec_rows<__nv_bfloat16>(x, wp, d, splits, sat, epi, s);
  return launch_dec_rows<float>(x, wp, d, splits, sat, epi, s);
}
