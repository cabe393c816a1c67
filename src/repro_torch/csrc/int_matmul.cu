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
//   x    is either int8 codes, or (prologue, `aq` given) fp32 activations
//          quantized while they are staged: clip(rint(x / aq), lo, hi) - shift,
//          with `shift` 128 for unsigned 8-bit codes (symmetrized into the int8
//          operand; the wrapper's offset adds 128 * colsum(w) back).  The
//          division is IEEE (__fdiv_rn, never a reciprocal) and rint rounds
//          half to even, so the codes equal the standalone act-quant's;
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
//          The requant reads the same weights and writes a quarter of the
//          fp32 output's bytes, so its bound is the scale-only kernel's.
//
// What bounds it on the H100: at decode M is the batch (1-8 rows), so the
// kernel reads each weight byte once and does ~M multiply-adds with it; the
// bound is the weight bytes over the 3.35 TB/s of HBM.  At prefill (M = a
// prompt chunk) it is still far below the int8 tensor-core roofline.
//
// Design (simple first): one block of 256 threads owns a 64-row x 64-column
// output tile and walks K in 64-element steps staged in shared memory; the
// weight step is stored transposed, so each thread holds its column's 64
// weights of the step in registers and runs each of its rows' inner product
// on `__dp4a` (four int8 products per instruction), with one guard per row so
// a row's products issue back to back.  Each thread keeps one int32 partial
// per output for the current reference K-tile and folds it into the carried
// accumulator at the reference boundary, so the carry semantics do not
// depend on this kernel's own step size.  Rows past M are skipped, which
// makes a 1-row decode call cost one row of arithmetic; the next step's
// global loads are issued into registers before the current step is
// multiplied, so the weight stream overlaps the arithmetic.  With the
// prologue a thread's x segment is 16 fp32 values (four 16-byte loads),
// issued with the weight loads a step ahead and divided only when the next
// step is staged (an IEEE division is a branch to a slow path behind a
// convergence barrier, so dividing between loads would serialise them).  With
// at most 16 live rows (decode) the step goes through fp32 shared memory and
// all the threads quantize it together after the next step's loads are
// issued: the one warp holding 8 rows' segments would otherwise divide 16
// values a thread alone and set the step's time.  Past 16 rows each thread
// quantizes its own segment.  Rows past M are neither staged nor divided.
// The requant epilogue adds a handful of instructions a flushed output.  Not
// yet done: tensor-core (mma/wgmma) products and split-K for the few-column
// decode shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;                   // output rows per block
constexpr int BN = 64;                   // output columns per block
constexpr int BKC = 64;                  // K elements per shared-memory step
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN; // 4: thread t owns column t % 64
constexpr int RPT = BM / ROW_GROUPS;     // 16 rows per thread: t / 64 + 4 i
constexpr int SPREAD_ROWS = 16;          // prologue: all threads quantize up to 16 rows
constexpr int PITCH = BKC + 16;          // bytes per staged row: 16-byte aligned,
                                         // 20 words -> conflict-free 16-byte reads

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

// 16 fp32 values from `p`, zero past `valid` values; four 16-byte loads when
// aligned.
struct F16 {
  float4 v[4];
};

__device__ __forceinline__ F16 load16(const float* p, int valid) {
  F16 r;
  if (valid >= 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) r.v[q] = __ldg(reinterpret_cast<const float4*>(p) + q);
    return r;
  }
  float f[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) f[j] = j < valid ? p[j] : 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) r.v[q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
  return r;
}

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

// TX is int8_t (codes) or float (the prologue quantizes while staging).
template <typename TX>
__global__ void __launch_bounds__(THREADS)
int_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                  int M, int N, int K, int bk_ref, int mode, int acc_bits,
                  int spill16, const float* __restrict__ scale,
                  const float* __restrict__ bias, const int* __restrict__ offset,
                  const float* __restrict__ aq, int q_lo, int q_hi, int q_shift,
                  const float* __restrict__ osc, int r_lo, int r_hi, int r_shift, int act,
                  int cast_bf16, float* __restrict__ out_f, int* __restrict__ out_i,
                  int8_t* __restrict__ out_q) {
  constexpr bool kPrologue = std::is_same<TX, float>::value;
  __shared__ __align__(16) int8_t xs[BM * PITCH];  // xs[r][k]
  __shared__ __align__(16) int8_t ws[BN * PITCH];  // ws[n][k] (transposed)
  __shared__ __align__(16) float xf[kPrologue ? BM * BKC : 4];  // the prologue's fp32 step

  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int rg = tid / BN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int rows = min(BM, M - m0);

  // staging roles: one 16-byte segment of x (16 int8 codes, or 16 fp32
  // values for the prologue) and one of w per thread per step
  const int xr = tid / (BKC / 16);        // x row 0..63
  const int xk = (tid % (BKC / 16)) * 16; // x column offset within the step
  const int wk = tid / (BN / 16);         // w row (k) 0..63
  const int wn = (tid % (BN / 16)) * 16;  // w column offset within the tile

  auto load_x = [&](int k0) {
    const int valid = xr < rows ? K - (k0 + xk) : 0;
    return load16(x + static_cast<size_t>(m0 + xr) * K + k0 + xk, valid);
  };
  // the prologue's quantizer (unused for int8 codes); with at most 16 live
  // rows the step is quantized by all the threads from shared memory, else
  // each thread quantizes its own segment (measured faster past ~16 rows)
  const float s_aq = aq != nullptr ? *aq : 1.0f;
  const bool spread = rows <= SPREAD_ROWS;
  const float lo = static_cast<float>(q_lo);
  const float hi = static_cast<float>(q_hi);
  auto load_w = [&](int k0) {
    const int valid = k0 + wk < K ? N - (n0 + wn) : 0;
    return load16(w + static_cast<size_t>(k0 + wk) * N + n0 + wn, valid);
  };

  int carry[RPT];
  int part[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    carry[i] = 0;
    part[i] = 0;
  }

  auto xv = load_x(0);
  int4 wv = load_w(0);
  for (int k0 = 0; k0 < K; k0 += BKC) {
    {
      if constexpr (kPrologue) {
        if (xr < rows && spread) {  // the fp32 step, quantized below by every thread
#pragma unroll
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<float4*>(xf + xr * BKC + xk + 4 * q) = xv.v[q];
        } else if (xr < rows) {  // many rows: each thread quantizes its own segment
          const float f[16] = {xv.v[0].x, xv.v[0].y, xv.v[0].z, xv.v[0].w,
                               xv.v[1].x, xv.v[1].y, xv.v[1].z, xv.v[1].w,
                               xv.v[2].x, xv.v[2].y, xv.v[2].z, xv.v[2].w,
                               xv.v[3].x, xv.v[3].y, xv.v[3].z, xv.v[3].w};
          int v[4] = {0, 0, 0, 0};
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const unsigned c = static_cast<uint8_t>(act_code(f[j], s_aq, lo, hi, q_shift));
            v[j >> 2] |= static_cast<int>(c << (8 * (j & 3)));
          }
          *reinterpret_cast<int4*>(xs + xr * PITCH + xk) = make_int4(v[0], v[1], v[2], v[3]);
        }
      } else {
        *reinterpret_cast<int4*>(xs + xr * PITCH + xk) = xr < rows ? xv : make_int4(0, 0, 0, 0);
      }
      const int words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        ws[(wn + j) * PITCH + wk] =
            static_cast<int8_t>((words[j >> 2] >> (8 * (j & 3))) & 0xff);
      }
    }
    __syncthreads();
    if (k0 + BKC < K) {  // next step's loads fly while this one multiplies
      xv = load_x(k0 + BKC);
      wv = load_w(k0 + BKC);
    }
    if constexpr (kPrologue) {
      if (spread) {  // block-uniform: every thread reaches the barrier or none
        // the few live rows' values spread over all the threads (2 a thread
        // at a decode M of 8): each IEEE division is a branch behind a
        // convergence barrier, so the one warp holding 8 rows' segments,
        // dividing 16 values a thread alone, would set the step's time
        for (int e = tid; e < rows * BKC; e += THREADS)
          xs[(e / BKC) * PITCH + e % BKC] = act_code(xf[e], s_aq, lo, hi, q_shift);
        __syncthreads();
      }
    }
    // this thread's column of the step: 64 int8 weights in 16 registers
    const int4* wrow = reinterpret_cast<const int4*>(ws + col * PITCH);
    int wq[BKC / 4];
#pragma unroll
    for (int q = 0; q < BKC / 16; ++q) {
      const int4 v = wrow[q];
      wq[4 * q] = v.x;
      wq[4 * q + 1] = v.y;
      wq[4 * q + 2] = v.z;
      wq[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (rg + i * ROW_GROUPS < rows) {
        const int4* xrow = reinterpret_cast<const int4*>(xs + (rg + i * ROW_GROUPS) * PITCH);
        int acc = part[i];
#pragma unroll
        for (int q = 0; q < BKC / 16; ++q) {
          const int4 v = xrow[q];
          acc = __dp4a(v.x, wq[4 * q], acc);
          acc = __dp4a(v.y, wq[4 * q + 1], acc);
          acc = __dp4a(v.z, wq[4 * q + 2], acc);
          acc = __dp4a(v.w, wq[4 * q + 3], acc);
        }
        part[i] = acc;
      }
    }
    __syncthreads();
    // bk_ref is a multiple of BKC, so a step never straddles a reference tile
    const int next = k0 + BKC;
    if (next % bk_ref == 0 || next >= K) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        carry[i] = fold(carry[i], part[i], mode, acc_bits, spill16);
        part[i] = 0;
      }
    }
  }

  const int n = n0 + col;
  if (n >= N) return;
  const float sc = scale != nullptr ? scale[n] : 0.0f;
  const float bi = bias != nullptr ? bias[n] : 0.0f;
  const int off = offset != nullptr ? offset[n] : 0;
  const float os = osc != nullptr ? osc[n] : 1.0f;
  const float rlo = static_cast<float>(r_lo);
  const float rhi = static_cast<float>(r_hi);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + i * ROW_GROUPS;
    if (r >= rows) continue;
    const size_t o = static_cast<size_t>(m0 + r) * N + n;
    if (scale != nullptr) {
      float y = __fmul_rn(__int2float_rn(add_wrap32(carry[i], off)), sc);
      if (bias != nullptr) y = __fadd_rn(y, bi);
      if (osc != nullptr) {
        out_q[o] = requant_code(y, os, rlo, rhi, r_shift, act, cast_bf16);
      } else {
        out_f[o] = y;
      }
    } else {
      out_i[o] = carry[i];
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Shapes
// and pointers are validated by the Python wrapper; `bk_ref` must be a
// positive multiple of 64.  `out_q` (int8) is written when `osc` is given,
// else `out_f` when `scale` is given, else `out_i`.  With `aq` (one fp32
// value on the device) `x` is fp32 and the prologue quantizes it to
// [q_lo, q_hi] minus `q_shift`; else `x` is int8.  With `osc` ((N,) fp32,
// needs `scale`) the epilogue replays `act` (0 none, 1 relu^2 in the cast
// dtype, 2 tanh gelu in fp32) after a cast to bf16 when `cast_bf16` (else
// fp32), and requantizes to [r_lo, r_hi] minus `r_shift`.
extern "C" int int_matmul_launch(const void* x, const void* w, int M, int N,
                                 int K, int bk_ref, int mode, int acc_bits,
                                 int spill16, const void* scale,
                                 const void* bias, const void* offset,
                                 const void* aq, int q_lo, int q_hi, int q_shift,
                                 const void* osc, int r_lo, int r_hi, int r_shift, int act,
                                 int cast_bf16, void* out_f, void* out_i, void* out_q,
                                 void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* of = static_cast<const int*>(offset);
  const auto* a = static_cast<const float*>(aq);
  const auto* os = static_cast<const float*>(osc);
  auto* of_ = static_cast<float*>(out_f);
  auto* oi = static_cast<int*>(out_i);
  auto* oq = static_cast<int8_t*>(out_q);
  if (aq != nullptr) {
    int_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), wp, M, N, K, bk_ref, mode, acc_bits, spill16, sc, bi,
        of, a, q_lo, q_hi, q_shift, os, r_lo, r_hi, r_shift, act, cast_bf16, of_, oi, oq);
  } else {
    int_matmul_kernel<int8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(x), wp, M, N, K, bk_ref, mode, acc_bits, spill16, sc, bi,
        of, nullptr, 0, 0, 0, os, r_lo, r_hi, r_shift, act, cast_bf16, of_, oi, oq);
  }
  return static_cast<int>(cudaGetLastError());
}
