// RWKV-6 (Finch) recurrence for Hopper (sm_90a): one sequential scan per
// (batch, head) with the head's fp32 state carried across all T steps.
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
// and the final state S_T, which may be written over S_0 in place: each
// block reads its own (b, h) state before it writes it.
//
// What bounds it on the H100: at decode (B=8, H=64, T=1) the call moves
// each head's 16 KB state in and out, 2 x 8 x 64 x 16 KB = 16.8 MB, ~5 us
// at 3.35 TB/s; the arithmetic is 4 Dk Dv flops a step.  At prefill (B=1,
// T=32) it is latency-bound: 32 dependent steps on only 64 blocks, each step
// a staged load, two block barriers and a 64-deep reduction.
//
// Design (simple first): the TPU's sequential chunk axis becomes a loop
// inside one block of 256 threads per (b, h).  Thread t owns state column
// t % 64 and the 16 rows 16 (t / 64) .. +15 of it, in registers for all T
// steps.  Each step's r, k, w (Dk values) and v (Dv values) are staged in
// shared memory, one value a thread, loaded one step ahead into a register
// so the next step's global load overlaps this step's arithmetic.  Each
// thread folds its 16 rows into a partial y and updates its 16 state
// values; the four partials of a column are summed through shared memory
// and written by the first Dv threads.  Inputs are read with their own
// (b, h, t) strides (the feature axis contiguous), so the caller's head
// views of (B, T, D) projections need no copy, and y is written with its
// own strides.  Dk, Dv <= 64.  Not yet done: the chunked matrix form
// (Finch appendix D) on tensor cores for long prefill chunks.

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
