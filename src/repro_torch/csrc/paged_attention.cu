// Paged-attention decode for Hopper (sm_90a): one query token per row
// against K/V pools read through a block table.
//
// Replaces the Pallas TPU kernel `paged_attention_kernel` /
// `paged_attention_pallas` (repro/kernels/paged_attention.py): fp32 and bf16
// pools, int8 code pools, and packed int4 pools (uint8, two codes a byte at
// Dh / 2: element 2i in the low nibble, 2i + 1 in the high, each
// sign-extended as (x ^ 8) - 8).  Integer pools come with fp32 per-slot scale
// pools ks/vs (NB, bs, KV) and are dequantized in registers while a block is
// staged, in the reference's order: code times the slot's scale, in fp32
// (__fmul_rn), then the dot with q * scale.  Inputs: q (B, H, Dh); pools
// kp/vp (NB, bs, KV, Dh) (Dh / 2 bytes a row for int4); block table
// bt (B, MB) int32; lengths (B,) int32 counting valid keys (this step's
// included).  Key position p of row b lives at pool block bt[b, p / bs],
// slot p % bs, and is valid iff p < length (and p >= length - window when a
// window is set).  Output (B, H, Dh) in q's dtype:
//   softmax over the valid keys of (q * scale) . k, times v, in fp32, with
//   rows that have no valid key giving zeros (the flush-time guard
//   `l > 0 ? 1 / max(l, 1e-30) : 0`), never NaN.
//
// What bounds it on the H100: the K/V bytes each row reads, length x KV x
// Dh x 2 (K and V) x the pool's element size (1 byte for int8, half a byte
// for int4, plus 4 bytes of scale a slot and KV head), over the 3.35 TB/s of
// HBM; the arithmetic (2 x G flops per K/V element) is negligible.
//
// Design: one block per (KV head, row).  The TPU grid walks (row, KV head,
// table entry) with the table entry innermost and sequential, carrying the
// softmax state in VMEM scratch; here the block loads its own lengths[b] and
// bt[b, :] and loops over the table entries in order inside the block, so
// nothing carries between blocks.  The G = H / KV query heads sharing the KV
// head are the rows of each (G, bs) score panel; the running max, sum and the
// (G, Dh) accumulator stay in shared memory for the whole walk.  The walk
// covers only the table entries that hold valid keys (from the window's
// first block to the block of the last key): an entry past the row's length
// would be fully masked, so skipping it gives the same result without
// reading it.  Keys past the length inside the last block are loaded and
// masked.  Not yet done: splitting long rows across blocks (flash-decoding)
// and vectorised 16-byte pool loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

// One pool element as fp32: `slot` indexes (NB, bs, KV) rows of Dh elements,
// `sc` the matching per-slot scales (unused for float pools).
__device__ __forceinline__ float pool_elem(const float* p, size_t slot, int d, int Dh,
                                           const float*) {
  return p[slot * Dh + d];
}
__device__ __forceinline__ float pool_elem(const __nv_bfloat16* p, size_t slot, int d, int Dh,
                                           const float*) {
  return __bfloat162float(p[slot * Dh + d]);
}
__device__ __forceinline__ float pool_elem(const int8_t* p, size_t slot, int d, int Dh,
                                           const float* sc) {
  return __fmul_rn(static_cast<float>(p[slot * Dh + d]), sc[slot]);
}
// uint8 pools are packed int4: row `slot` holds Dh / 2 bytes
__device__ __forceinline__ float pool_elem(const uint8_t* p, size_t slot, int d, int Dh,
                                           const float* sc) {
  const int byte = p[slot * (Dh / 2) + d / 2];
  const int nib = (d & 1) ? (byte >> 4) : (byte & 0xF);
  return __fmul_rn(static_cast<float>((nib ^ 8) - 8), sc[slot]);
}

__device__ __forceinline__ bool key_valid(int kpos, int len, int window) {
  return kpos < len && (window <= 0 || kpos >= len - window);
}

template <typename TQ, typename TP>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                       const TP* __restrict__ vp, const float* __restrict__ ksc,
                       const float* __restrict__ vsc, const int* __restrict__ bt,
                       const int* __restrict__ lengths, TQ* __restrict__ out,
                       int H, int KV, int Dh, int bs, int MB, float scale,
                       int window) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  float* qs = smem;          // (G, Dh) scaled queries
  float* ks = qs + G * Dh;   // (bs, Dh) current key block
  float* vs = ks + bs * Dh;  // (bs, Dh) current value block
  float* ps = vs + bs * Dh;  // (G, bs) scores, then probabilities
  float* acc = ps + G * bs;  // (G, Dh) unnormalised output
  float* ms = acc + G * Dh;  // (G,) running max
  float* ls = ms + G;        // (G,) running sum
  float* al = ls + G;        // (G,) this step's rescale factor

  const size_t qoff = (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) * Dh;
  for (int i = tid; i < G * Dh; i += THREADS) {
    qs[i] = to_f32(q[qoff + i]) * scale;
    acc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = kNeg;
    ls[g] = 0.0f;
  }

  const int len = lengths[b];
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int j_begin = lo / bs;
  const int j_end = min((len + bs - 1) / bs, MB);
  for (int j = j_begin; j < j_end; ++j) {
    const size_t blk = static_cast<size_t>(bt[static_cast<size_t>(b) * MB + j]);
    __syncthreads();  // previous step's readers are done with ks/vs/ps
    for (int i = tid; i < bs * Dh; i += THREADS) {
      const int o = i / Dh;
      const int d = i % Dh;
      const size_t slot = (blk * bs + o) * KV + h;
      ks[i] = pool_elem(kp, slot, d, Dh, ksc);
      vs[i] = pool_elem(vp, slot, d, Dh, vsc);
    }
    __syncthreads();
    for (int i = tid; i < G * bs; i += THREADS) {
      const int g = i / bs;
      const int o = i % bs;
      float s = 0.0f;
      for (int d = 0; d < Dh; ++d) s += qs[g * Dh + d] * ks[o * Dh + d];
      ps[i] = key_valid(j * bs + o, len, window) ? s : kNeg;
    }
    __syncthreads();
    for (int g = warp; g < G; g += WARPS) {
      float mb = kNeg;
      for (int o = lane; o < bs; o += 32) mb = fmaxf(mb, ps[g * bs + o]);
      for (int w = 16; w > 0; w >>= 1) mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, w));
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mb);
      float sum = 0.0f;
      for (int o = lane; o < bs; o += 32) {
        const float p =
            key_valid(j * bs + o, len, window) ? expf(ps[g * bs + o] - m_new) : 0.0f;
        ps[g * bs + o] = p;
        sum += p;
      }
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        ls[g] = alpha * ls[g] + sum;
        ms[g] = m_new;
        al[g] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * Dh; i += THREADS) {
      const int g = i / Dh;
      const int d = i % Dh;
      float pv = 0.0f;
      for (int o = 0; o < bs; ++o) pv += ps[g * bs + o] * vs[o * Dh + d];
      acc[i] = al[g] * acc[i] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * Dh; i += THREADS) {
    const float l = ls[i / Dh];
    const float norm = l > 0.0f ? 1.0f / fmaxf(l, 1e-30f) : 0.0f;
    from_f32(acc[i] * norm, &out[qoff + i]);
  }
}

template <typename TQ, typename TP>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* bt, const void* lengths, void* out, int B, int H, int KV, int Dh,
           int bs, int MB, float scale, int window, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) * (2 * G * Dh + 2 * bs * Dh + G * bs + 3 * G);
  auto kernel = paged_attention_kernel<TQ, TP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(KV, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), H, KV, Dh, bs, MB,
      scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_pools(const void* q, const void* kp, const void* vp, const void* ks,
                 const void* vs, const void* bt, const void* lengths, void* out, int B,
                 int H, int KV, int Dh, int bs, int MB, float scale, int window,
                 int pool_kind, cudaStream_t s) {
  switch (pool_kind) {
    case 0:
      return launch<TQ, float>(q, kp, vp, ks, vs, bt, lengths, out, B, H, KV, Dh, bs, MB, scale, window, s);
    case 1:
      return launch<TQ, __nv_bfloat16>(q, kp, vp, ks, vs, bt, lengths, out, B, H, KV, Dh, bs, MB, scale, window, s);
    case 2:
      return launch<TQ, int8_t>(q, kp, vp, ks, vs, bt, lengths, out, B, H, KV, Dh, bs, MB, scale, window, s);
    case 3:
      return launch<TQ, uint8_t>(q, kp, vp, ks, vs, bt, lengths, out, B, H, KV, Dh, bs, MB, scale, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  q and
// out are fp32 (q_bf16 = 0) or bf16 (1); the two pools share one kind:
// 0 fp32, 1 bf16, 2 int8 codes, 3 packed int4 (uint8, Dh / 2 bytes a row),
// the integer kinds with fp32 scale pools ks/vs (NB, bs, KV), else null.
// Shapes are validated by the Python wrapper.  `window` <= 0 means no
// sliding window.
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* bt,
                                      const void* lengths, void* out, int B,
                                      int H, int KV, int Dh, int bs, int MB,
                                      float scale, int window, int q_bf16,
                                      int pool_kind, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return launch_pools<__nv_bfloat16>(q, kp, vp, ks, vs, bt, lengths, out, B, H, KV, Dh, bs, MB, scale, window, pool_kind, s);
  return launch_pools<float>(q, kp, vp, ks, vs, bt, lengths, out, B, H, KV, Dh, bs, MB, scale, window, pool_kind, s);
}
