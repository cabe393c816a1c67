// MLA absorbed-decode latent attention for Hopper (sm_90a): one query token
// per row against the compressed latent and rope-key pools, read through a
// block table.
//
// Replaces the Pallas TPU kernel `paged_mla_attention_kernel` /
// `paged_mla_attention_pallas` (repro/kernels/paged_attention.py), for fp32,
// bf16, int8 and packed int4 pools (uint8, two codes a byte at half the
// width: element 2i in the low nibble, 2i + 1 in the high, sign-extended as
// (x ^ 8) - 8).  Integer pools come with fp32 per-token scale pools ckvs and
// kpes (NB, bs) and are dequantized while a block is staged, in the
// reference's order: code times the token's scale (__fmul_rn), then the
// act-quant replay on the dequantized latent.  Inputs: q_lat (B, H, R) and
// q_pe (B, H, P) fp32 (the
// query absorbed through the up-projection's key half, and its rope half);
// pools ckvp (NB, bs, R) and kpep (NB, bs, P), one per token and shared by
// every head; block table bt (B, MB) int32; lengths (B,) int32 counting
// valid keys (this step's included).  Key position p of row b lives at pool
// block bt[b, p / bs], slot p % bs, and is valid iff p < length.  Output
// o_lat (B, H, R) fp32:
//   s = (q_lat . ckv + q_pe . kpe) * scale over the valid keys,
//   o_lat = softmax(s) @ ckv, fp32 online softmax,
// with rows that have no valid key giving zeros (the flush-time guard
// `l > 0 ? 1 / max(l, 1e-30) : 0`), never NaN.  With `aq` given, the latent
// is replaced by its activation fake-quant clip(rint(ckv / s_aq), lo, hi) *
// s_aq before both uses (the absorb path's A2Q quantizer): a division, not
// a multiply by the reciprocal, rounding half to even, each step rounded on
// its own (__fdiv_rn / __fmul_rn, so nvcc cannot contract or reassociate).
//
// What bounds it on the H100: the arithmetic.  Every head reads the same
// latent, so the pool bytes (length x (R + P) x element size per row) are
// small (int8 and int4 pools shrink them further), while each key costs
// 2 x H x (R + P + R) fp32 flops (scores and PV), which at H = 128 is far
// above the bytes' time at 3.35 TB/s.  The
// kernel runs these flops on the CUDA cores (67 TFLOP/s fp32).
//
// Design: one block per (group of HEADS_PER_BLOCK heads, row); warp w of the
// block owns head g = group * HEADS_PER_BLOCK + w.  The TPU grid walks
// (row, table entry) with the table entry sequential, carrying the softmax
// state in VMEM scratch; here the block loads its own lengths[b] and
// bt[b, :] and walks the table entries in order, so nothing carries between
// blocks.  Each 16-token latent block is staged once in shared memory,
// converted to fp32 and, with `aq`, fake-quantized there, once per element
// for all the block's heads; the scores and the PV product then both read
// the same staged block, as the TPU kernel reuses its ckv block.  Staging
// issues all of a thread's 16-byte loads before it uses any (with one block
// of 8 warps on an SM there is little else to hide device-memory latency);
// an integer pool's 16 bytes widen to 16 (int8) or 32 (int4) fp32 values,
// scaled by the token scales the block stages into shared memory first.
// A warp keeps
// its head's query (R / 32 + P / 32 values a lane), running max and sum,
// and its (R,) accumulator in registers: lane l holds latent columns l,
// l + 32, ...; key o's score is reduced across the warp (4 keys' reductions
// interleaved) and kept by lane o, and the PV step broadcasts each key's
// probability from that lane.  The walk stops at the block of the last valid key, so table entries past the
// length are never read; the keys past the length inside that last block
// are staged but get no score and add nothing.  Not yet done: tensor cores,
// TMA staging with a second buffer, splitting long rows across blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HEADS_PER_BLOCK = 8;
constexpr int THREADS = 32 * HEADS_PER_BLOCK;
constexpr int MAX_R = 512;  // latent width: R / 32 accumulator registers a lane
constexpr int MAX_P = 64;   // rope width
constexpr int RL = MAX_R / 32;
constexpr int PL = MAX_P / 32;
constexpr int STAGE_LOADS = 4;    // 16-byte loads in flight per thread while staging
constexpr int KEYS_AT_ONCE = 4;   // score reductions interleaved per warp
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int w = 16; w > 0; w >>= 1) v += __shfl_xor_sync(0xffffffffu, v, w);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int w = 16; w > 0; w >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, w));
  return v;
}

// Pools hold fp32 (float), bf16 (its 16 bits, uint16_t), int8 codes
// (int8_t) or packed int4 codes (uint8_t).  VEC: logical elements in one
// 16-byte load; PACK: logical elements a stored element holds; QUANT: codes
// that need the per-token scales.
template <typename TP>
struct Pool {
  static constexpr int VEC = 16 / sizeof(TP);
  static constexpr int PACK = 1;
  static constexpr bool QUANT = false;
};
template <>
struct Pool<int8_t> {
  static constexpr int VEC = 16;
  static constexpr int PACK = 1;
  static constexpr bool QUANT = true;
};
template <>
struct Pool<uint8_t> {
  static constexpr int VEC = 32;
  static constexpr int PACK = 2;
  static constexpr bool QUANT = true;
};

// Widening a bf16 is a shift: it is the top half of the fp32 with the same
// bits.  An int8 code is byte b of a little-endian word, sign-extended by
// shifts; an int4 code is nibble n (element n of the word's 8), likewise.
__device__ __forceinline__ void widen(uint4 r, float* o, float) {
  o[0] = __uint_as_float(r.x);
  o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z);
  o[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen(uint4 r, float* o, uint16_t) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = __uint_as_float(w[k] << 16);  // little-endian: the even element is low
    o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(uint4 r, float* o, int8_t) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      o[4 * k + b] = static_cast<float>(static_cast<int>(w[k] << (24 - 8 * b)) >> 24);
}
__device__ __forceinline__ void widen(uint4 r, float* o, uint8_t) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      o[8 * k + n] = static_cast<float>(static_cast<int>(w[k] << (28 - 4 * n)) >> 28);
}

// Copy n logical pool elements (rows of `width`; n a multiple of VEC, src
// 16-byte aligned) to shared memory as fp32: integer codes times their
// token's scale (`tok_scale`, shared memory, indexed by element / width),
// then the activation fake-quant when `replay` is set.  16-byte loads,
// STAGE_LOADS a thread issued before any is used (a bf16 latent block is 4
// loads a thread, fp32 8, int8 2, int4 1, all in flight at once), so no
// load waits behind a division: each IEEE division is a branch to a slow path with a convergence
// barrier, which kept element-by-element loads serial.
template <typename TP>
__device__ __forceinline__ void stage(const TP* __restrict__ src, float* __restrict__ dst,
                                      int n, int width, const float* __restrict__ tok_scale,
                                      bool replay, float s_aq, int q_lo, int q_hi) {
  constexpr int VEC = Pool<TP>::VEC;
  // loads in flight a thread: a 16 x 512 latent block is 8 fp32 / 4 bf16 /
  // 2 int8 / 1 int4 loads a thread, so integer pools need fewer registers
  constexpr int LOADS = VEC <= 8 ? STAGE_LOADS : STAGE_LOADS * 8 / VEC;
  const int nv = n / VEC;
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  for (int base = threadIdx.x; base < nv; base += THREADS * LOADS) {
    uint4 raw[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = base + u * THREADS;
      raw[u] = i < nv ? src4[i] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = base + u * THREADS;
      if (i >= nv) break;
      float x[VEC];
      widen(raw[u], x, TP());
      if (Pool<TP>::QUANT) {
        int tok = i * VEC / width;  // a load may straddle tokens when width < VEC
        int rem = i * VEC - tok * width;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          x[e] = __fmul_rn(x[e], tok_scale[tok]);
          if (++rem == width) {
            rem = 0;
            ++tok;
          }
        }
      }
      if (replay) {
        // integer pools hold many zero codes (int4 ~1 in 6), and an IEEE
        // division of zero takes the slow path: a zero divides 1 instead
        // and keeps its own value (the replay maps +-0 to itself)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const bool zero = Pool<TP>::QUANT && x[e] == 0.0f;
          const float code = fminf(fmaxf(rintf(__fdiv_rn(zero ? 1.0f : x[e], s_aq)),
                                         static_cast<float>(q_lo)),
                                   static_cast<float>(q_hi));
          x[e] = zero ? x[e] : __fmul_rn(code, s_aq);
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(dst + i * VEC + e) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  }
}

template <typename TP>
__global__ void __launch_bounds__(THREADS)
paged_mla_attention_kernel(const float* __restrict__ q_lat,
                           const float* __restrict__ q_pe,
                           const TP* __restrict__ ckvp,
                           const TP* __restrict__ kpep,
                           const float* __restrict__ ckvs,
                           const float* __restrict__ kpes,
                           const int* __restrict__ bt,
                           const int* __restrict__ lengths,
                           const float* __restrict__ aq, float* __restrict__ out,
                           int H, int R, int P, int bs, int MB, float scale,
                           int q_lo, int q_hi) {
  extern __shared__ float smem[];
  constexpr int PACK = Pool<TP>::PACK;
  float* ckv_s = smem;            // (bs, R) staged latent block, fp32
  float* kpe_s = ckv_s + bs * R;  // (bs, P) staged rope-key block
  float* ckv_sc = kpe_s + bs * P; // (bs,) the block's latent scales (integer pools)
  float* kpe_sc = ckv_sc + bs;    // (bs,) its rope-key scales

  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.x * HEADS_PER_BLOCK + threadIdx.x / 32;
  const bool live = g < H;  // a warp past H stages and syncs but owns no head
  const float s_aq = aq != nullptr ? *aq : 1.0f;

  float ql[RL], qp[PL], acc[RL];
  const size_t qoff = static_cast<size_t>(b) * H + (live ? g : 0);
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const int r = lane + 32 * i;
    ql[i] = (live && r < R) ? q_lat[qoff * R + r] : 0.0f;
    acc[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int p = lane + 32 * i;
    qp[i] = (live && p < P) ? q_pe[qoff * P + p] : 0.0f;
  }
  float m = kNeg;
  float l = 0.0f;

  const int len = lengths[b];
  const int j_end = min((len + bs - 1) / bs, MB);
  for (int j = 0; j < j_end; ++j) {
    const size_t blk = static_cast<size_t>(bt[static_cast<size_t>(b) * MB + j]);
    const int nvalid = min(bs, len - j * bs);
    if (Pool<TP>::QUANT && static_cast<int>(threadIdx.x) < bs) {  // read only by staging
      ckv_sc[threadIdx.x] = ckvs[blk * bs + threadIdx.x];
      kpe_sc[threadIdx.x] = kpes[blk * bs + threadIdx.x];
    }
    __syncthreads();  // the previous block's readers are done with ckv_s/kpe_s
    stage(ckvp + blk * bs * (R / PACK), ckv_s, bs * R, R, ckv_sc, aq != nullptr, s_aq, q_lo,
          q_hi);
    stage(kpep + blk * bs * (P / PACK), kpe_s, bs * P, P, kpe_sc, false, 1.0f, 0, 0);
    __syncthreads();

    // scores, KEYS_AT_ONCE keys at a time so their reductions interleave;
    // lane o keeps key o's
    float s_mine = kNeg;
    for (int o0 = 0; o0 < nvalid; o0 += KEYS_AT_ONCE) {
      float part[KEYS_AT_ONCE];
#pragma unroll
      for (int k = 0; k < KEYS_AT_ONCE; ++k) {
        const int o = min(o0 + k, nvalid - 1);  // a key past nvalid is never kept
        float lat = 0.0f;
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          const int r = lane + 32 * i;
          if (r < R) lat += ql[i] * ckv_s[o * R + r];
        }
        float pe = 0.0f;
#pragma unroll
        for (int i = 0; i < PL; ++i) {
          const int p = lane + 32 * i;
          if (p < P) pe += qp[i] * kpe_s[o * P + p];
        }
        part[k] = lat + pe;
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) {
#pragma unroll
        for (int k = 0; k < KEYS_AT_ONCE; ++k)
          part[k] += __shfl_xor_sync(0xffffffffu, part[k], w);
      }
#pragma unroll
      for (int k = 0; k < KEYS_AT_ONCE; ++k)
        if (lane == o0 + k && o0 + k < nvalid) s_mine = part[k] * scale;
    }
    // online softmax over this block's valid keys
    const float m_new = fmaxf(m, warp_max(s_mine));
    const float p = lane < nvalid ? expf(s_mine - m_new) : 0.0f;
    const float alpha = expf(m - m_new);
    l = alpha * l + warp_sum(p);
    m = m_new;
    float pv[RL];
#pragma unroll
    for (int i = 0; i < RL; ++i) pv[i] = 0.0f;
    for (int o = 0; o < nvalid; ++o) {
      const float po = __shfl_sync(0xffffffffu, p, o);
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int r = lane + 32 * i;
        if (r < R) pv[i] += po * ckv_s[o * R + r];
      }
    }
#pragma unroll
    for (int i = 0; i < RL; ++i) acc[i] = alpha * acc[i] + pv[i];
  }
  if (!live) return;
  const float norm = l > 0.0f ? 1.0f / fmaxf(l, 1e-30f) : 0.0f;
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const int r = lane + 32 * i;
    if (r < R) out[qoff * R + r] = acc[i] * norm;
  }
}

template <typename TP>
int launch(const void* q_lat, const void* q_pe, const void* ckvp, const void* kpep,
           const void* ckvs, const void* kpes, const void* bt, const void* lengths,
           const void* aq, void* out, int B, int H, int R, int P, int bs, int MB, float scale,
           int act_bits, cudaStream_t stream) {
  if (R > MAX_R || P > MAX_P || bs > 32 || R % 8 || P % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(bs) * (R + P + 2);
  auto kernel = paged_mla_attention_kernel<TP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int q_lo = act_bits > 0 ? -(1 << (act_bits - 1)) : 0;
  const int q_hi = act_bits > 0 ? (1 << (act_bits - 1)) - 1 : 0;
  const dim3 grid((H + HEADS_PER_BLOCK - 1) / HEADS_PER_BLOCK, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_pe),
      static_cast<const TP*>(ckvp), static_cast<const TP*>(kpep),
      static_cast<const float*>(ckvs), static_cast<const float*>(kpes),
      static_cast<const int*>(bt), static_cast<const int*>(lengths),
      act_bits > 0 ? static_cast<const float*>(aq) : nullptr,
      static_cast<float*>(out), H, R, P, bs, MB, scale, q_lo, q_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 on success).  q_lat, q_pe
// and out are fp32; the two pools share one kind: 0 fp32, 1 bf16, 2 int8
// codes, 3 packed int4 (uint8, half the width), the integer kinds with fp32
// per-token scale pools ckvs/kpes (NB, bs), else null.  `aq` points at one
// fp32 activation-quantizer scale on the device and is read only when
// act_bits > 0.  Shapes are validated by the Python wrapper; R <= 512,
// P <= 64, bs <= 32 and R, P multiples of 8 are checked here too.  The pools
// must be 16-byte aligned, and so must every block of them.
extern "C" int paged_mla_attention_launch(const void* q_lat, const void* q_pe,
                                          const void* ckvp, const void* kpep,
                                          const void* ckvs, const void* kpes,
                                          const void* bt, const void* lengths,
                                          const void* aq, void* out, int B, int H,
                                          int R, int P, int bs, int MB, float scale,
                                          int act_bits, int pool_kind, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pool_kind) {
    case 0:
      return launch<float>(q_lat, q_pe, ckvp, kpep, ckvs, kpes, bt, lengths, aq, out, B, H, R,
                           P, bs, MB, scale, act_bits, s);
    case 1:
      return launch<uint16_t>(q_lat, q_pe, ckvp, kpep, ckvs, kpes, bt, lengths, aq, out, B, H,
                              R, P, bs, MB, scale, act_bits, s);
    case 2:
      return launch<int8_t>(q_lat, q_pe, ckvp, kpep, ckvs, kpes, bt, lengths, aq, out, B, H, R,
                            P, bs, MB, scale, act_bits, s);
    case 3:
      return launch<uint8_t>(q_lat, q_pe, ckvp, kpep, ckvs, kpes, bt, lengths, aq, out, B, H,
                             R, P, bs, MB, scale, act_bits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
