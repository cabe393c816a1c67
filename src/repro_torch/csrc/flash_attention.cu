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
// hubert's (8, 16, 1000, 80) that is 41 GFLOP against 82 MB: 0.61 ms at the
// 67 TFLOP/s fp32 CUDA-core peak this kernel runs on (0.041 ms on bf16
// tensor cores), 0.025 ms for the bytes.
//
// Design (simple first, CUDA cores): the TPU kernel's grid (B*H, Tq/bq,
// Tk/bk) walks the key axis sequentially with the softmax state in VMEM.
// Here one block of 256 threads owns (batch*head, a 64-query tile) and loops
// over 64-key tiles inside the block (tiles wholly outside the causal or
// window range are skipped).  The query tile is staged once in shared
// memory as fp32 (scaled), each key tile transposed (d-major) and each value
// tile as they are converted to fp32.  Thread (ty, tx) of a 16 x 16 grid
// owns query rows ty + 16 i (i < 4): it computes the scores of columns
// tx + 16 j (j < 4) from shared memory, reduces the rows' max and sum over
// its 16 lanes with shuffles, writes its probabilities to shared memory and
// accumulates output columns tx + 16 j (j < D / 16) in registers.  Pitches
// keep every shared-memory access free of bank conflicts.  Not yet done:
// tensor cores (mma/wgmma) for the two products, double-buffered tile loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KVH,
           int Tq, int Tk, const Strides& st, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool sized = false;  // shared memory above 48 KB must be asked for once
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
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out, int B, int H,
             int KVH, int Tq, int Tk, const Strides& st, float scale, int causal, int window,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, stream);
    case 80: return launch<T, 80>(q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`; returns a cudaError (0 on success).  Validated by the
// Python wrapper: q (B, Tq, H, D), k and v (B, Tk, KVH, D) strided with a
// contiguous last axis (`strides`: q's, k's and v's batch, time and head
// strides in elements), one dtype (`bf16` 1: bfloat16, 0: fp32), H a
// multiple of KVH, D in {16, 32, 64, 80, 128}; out (B, Tq, H, D) contiguous
// in that dtype.  `window` <= 0 means none.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int KVH, int Tq, int Tk, int D,
                                      const long long* strides, float scale, int causal,
                                      int window, int bf16, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_d<__nv_bfloat16>(D, q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, s);
  return launch_d<float>(D, q, k, v, out, B, H, KVH, Tq, Tk, st, scale, causal, window, s);
}
