// int8 x int8 -> int32 matmul with P-bit accumulator emulation and the fused
// W8A8 epilogue, for Hopper (sm_90a).
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
//   out  = (acc + offset[n]) * scale[n] (+ bias[n]) in fp32 when `scale` is
//          given (one rounded multiply, then one rounded add: __fmul_rn /
//          __fadd_rn keep nvcc from contracting them into an FMA, so the
//          scale-only output is bit-identical to the plain version), else
//          the raw int32 accumulator.
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
// multiplied, so the weight stream overlaps the arithmetic.  Not yet done:
// tensor-core (mma/wgmma) products and split-K for the few-column decode
// shapes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                   // output rows per block
constexpr int BN = 64;                   // output columns per block
constexpr int BKC = 64;                  // K elements per shared-memory step
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN; // 4: thread t owns column t % 64
constexpr int RPT = BM / ROW_GROUPS;     // 16 rows per thread: t / 64 + 4 i
constexpr int PITCH = BKC + 16;          // bytes per staged row: 16-byte aligned,
                                         // 20 words -> conflict-free 16-byte reads

enum Mode { kExact = 0, kWrap = 1, kSaturate = 2 };

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

__global__ void __launch_bounds__(THREADS)
int_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  int M, int N, int K, int bk_ref, int mode, int acc_bits,
                  int spill16, const float* __restrict__ scale,
                  const float* __restrict__ bias, const int* __restrict__ offset,
                  float* __restrict__ out_f, int* __restrict__ out_i) {
  __shared__ __align__(16) int8_t xs[BM * PITCH];  // xs[r][k]
  __shared__ __align__(16) int8_t ws[BN * PITCH];  // ws[n][k] (transposed)

  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int rg = tid / BN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int rows = min(BM, M - m0);

  // staging roles: one 16-byte segment of x and one of w per thread per step
  const int xr = tid / (BKC / 16);        // x row 0..63
  const int xk = (tid % (BKC / 16)) * 16; // x column offset within the step
  const int wk = tid / (BN / 16);         // w row (k) 0..63
  const int wn = (tid % (BN / 16)) * 16;  // w column offset within the tile

  auto load_x = [&](int k0) {
    const int valid = xr < rows ? K - (k0 + xk) : 0;
    return load16(x + static_cast<size_t>(m0 + xr) * K + k0 + xk, valid);
  };
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

  int4 xv = load_x(0);
  int4 wv = load_w(0);
  for (int k0 = 0; k0 < K; k0 += BKC) {
    {
      *reinterpret_cast<int4*>(xs + xr * PITCH + xk) = xv;
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
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + i * ROW_GROUPS;
    if (r >= rows) continue;
    const size_t o = static_cast<size_t>(m0 + r) * N + n;
    if (scale != nullptr) {
      float y = __fmul_rn(__int2float_rn(add_wrap32(carry[i], off)), sc);
      if (bias != nullptr) y = __fadd_rn(y, bi);
      out_f[o] = y;
    } else {
      out_i[o] = carry[i];
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Shapes
// and pointers are validated by the Python wrapper; `bk_ref` must be a
// positive multiple of 64.  `out_f` is written when `scale` is given, else
// `out_i`.
extern "C" int int_matmul_launch(const void* x, const void* w, int M, int N,
                                 int K, int bk_ref, int mode, int acc_bits,
                                 int spill16, const void* scale,
                                 const void* bias, const void* offset,
                                 void* out_f, void* out_i, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), M, N, K,
      bk_ref, mode, acc_bits, spill16, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const int*>(offset),
      static_cast<float*>(out_f), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
