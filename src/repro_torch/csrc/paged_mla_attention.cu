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
// s_aq before both uses (the absorb path's A2Q quantizer): the IEEE
// quotient rounded half to even, each step rounded on its own (__fdiv_rn /
// __fmul_rn, so nvcc cannot contract or reassociate; the tensor-core kernel
// gets the same quotient from 1 / s_aq and two fmas, see replay8).
//
// What bounds it on the H100: the arithmetic, at a served context.  Every
// head reads the same latent, so the pool bytes (length x (R + P) x element
// size a row) are small, while each key costs 2 x H x (R + P + R) operations
// (scores and PV): at B = 8, H = 128 and DeepSeek-V3's 4K context that is
// 9.1 GFLOP, 9.2 us at the 989 TFLOP/s of the bf16 tensor cores, against
// 11.3 us for the 37.7 MB of bf16 pools at 3.35 TB/s (int8 and int4 pools
// read half and a quarter of that).  On the fp32 CUDA cores (67 TFLOP/s) the
// same work takes at least 136 us.  At a few dozen keys a row the launch
// and the round trips to memory bound it.
//
// Two kernels, picked by the wrapper (`kernels/paged_mla_attention.py`):
//
// (1) bf16, int8 and int4 pools, with no replay or a replay of at most 9
// bits: `paged_mla_attention_tc_kernel` on the bf16 tensor cores.  MLA's
// absorbed decode is a small matrix product with the heads as its rows: all
// heads of a row share one latent.
//   * Grid (H / 16 head tiles, B, S runs): a block of 8 warps owns a row, 16
//     heads (the m16 rows of both products) and one run of the row's table.
//     Warp w owns latent columns 64 w .. 64 w + 63 in both products (and
//     warps 0-3 16 rope columns each in the scores), so its query fragments
//     and its (16, 64) fp32 accumulator stay in registers.  A warp's latent
//     scores go to shared memory before warps 0-3 reuse the registers for
//     the rope columns.
//     Each 64-key step is staged, widened and replayed once for the 16
//     heads (8 heads a staging in the CUDA-core kernel).  Tried and slower
//     on an H100: the widening shared among a row's head tiles through
//     distributed shared memory (a cluster barrier a step: 2.3x), and three
//     steps in flight with the next one widened during this one's products
//     (no gain: the widening and the products share the issue slots).
//   * Products: `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`, the
//     latent B fragments by `ldmatrix` (scores) and `ldmatrix.trans` (PV)
//     on the same [key][column] rows, padded to an odd number of 16-byte
//     chunks.  Precision stays fp32's: q_lat and q_pe are split into bf16 hi
//     + mid + lo (three 8-bit slices of the 24-bit mantissa: three score
//     products), and the latent operand is exact in bf16: bf16 pools as they
//     are, int8 and int4 codes (the token scale applied to the fp32 score
//     column after the product, and folded into P: then P as three bf16
//     terms), and the replay's integer
//     codes clip(rint(x / s_aq)) (|code| <= 256 at 9 bits; s_aq applied
//     after both products), x being the dequantized latent code * scale
//     (__fmul_rn) as in the reference.  The latent and rope parts keep their
//     own factors (their scales differ).  P is split into bf16 hi + lo
//     (flash_attention.cu's 2^-16 relative), so the output stays within the
//     2e-5 of the CUDA-core kernel.  TF32 (10 bits) would not.
//   * Steps of 64 keys: the next step's rows (and the codes' scales) fly as
//     `cp.async` copies into a second buffer while this one is multiplied
//     (the first step's while the query fragments load);
//     the warps' partial scores meet in shared memory, 16 threads a head
//     run the online softmax (fp32 exp, the running max and sum), and P
//     (times the folded token scale) is written for every warp's PV.
//   * Split-KV in the cluster: a row's table is cut into S runs of whole
//     entries (`mla_splits`, from the static shapes and the SM count); each
//     block leaves its partial (m,
//     l, unnormalized O) in shared memory, and after a cluster barrier the
//     blocks share out the outputs, merging the runs in order through
//     distributed shared memory (as paged_attention.cu does).  No state
//     between calls.
//   * The walk stops at the last valid key: a table entry past the length,
//     and the pool block behind it, are never read; a key past the length
//     inside the last block is zero-filled, never copied.  A row of one key
//     has a softmax weight of exactly 1: its output is the key's dequantized
//     (and replayed) latent, written from fp32 as the reference computes it.
//
// (2) fp32 pools, and a replay of more than 9 bits (their latent is not
// exact in bf16): `paged_mla_attention_kernel` on the CUDA cores.  One block
// per (group of HEADS_PER_BLOCK heads, row); warp w of the block owns head g
// = group * HEADS_PER_BLOCK + w.  The TPU grid walks (row, table entry) with
// the table entry sequential, carrying the softmax state in VMEM scratch;
// here the block loads its own lengths[b] and bt[b, :] and walks the table
// entries in order, so nothing carries between blocks.  Each 16-token latent
// block is staged once in shared memory, converted to fp32 and, with `aq`,
// fake-quantized there, once per element for all the block's heads; the
// scores and the PV product then both read the same staged block, as the
// TPU kernel reuses its ckv block.  Staging issues all of a thread's 16-byte
// loads before it uses any; an integer pool's 16 bytes widen to 16 (int8) or
// 32 (int4) fp32 values, scaled by the token scales the block stages into
// shared memory first.  A warp keeps its head's query (R / 32 + P / 32
// values a lane), running max and sum, and its (R,) accumulator in
// registers: lane l holds latent columns l, l + 32, ...; key o's score is
// reduced across the warp (4 keys' reductions interleaved) and kept by lane
// o, and the PV step broadcasts each key's probability from that lane.  The
// walk stops at the block of the last valid key; the keys past the length
// inside that last block are staged but get no score and add nothing.
//
// Not yet done: wgmma with 64-head tiles (the widening and the replay, one
// bf16 value at a time for each 16-head tile, cost as much as both
// products), TMA, the widening overlapped with the products (warp
// specialization).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
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


// ---------------------------------------------------------------------------
// The tensor-core kernel: bf16, int8 and int4 pools, the replay at act_bits
// <= 9 (see the note at the top).
// ---------------------------------------------------------------------------
namespace tc {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int HT = 16;                // heads a block: the m16 rows of both products
constexpr int KS = 64;                // keys a step
constexpr int TPK = THREADS / KS;     // threads staging a key
constexpr int KPT = KS / 16;          // keys a softmax thread takes (16 threads a head)
constexpr int RP = 512;               // latent columns: warp w owns 64 w .. 64 w + 63
constexpr int PP = 64;                // rope columns: warp w < 4 owns 16 w .. 16 w + 15
constexpr int LPITCH = RP * 2 + 16;   // bytes of a staged bf16 latent row (odd 16-byte chunks)
constexpr int PPITCH = PP * 2 + 16;   // bytes of a staged bf16 rope row
constexpr int SPITCH = KS + 8;        // floats of a score / probability row
constexpr int MAX_SPLITS = 8;         // a row's runs are one thread-block cluster
constexpr float kNeg = -1e30f;

struct Args {
  int B, H, R, P, bs, MB, eps;  // eps: table entries a run
  int lat_rb, rope_rb;          // bytes of a pool row
  int lat_cg, rope_cg;          // bytes a copy (16, 8 or 4: the largest dividing the row)
  int replay;
  float scale, q_lo, q_hi;
};

// Byte offsets of the dynamic shared memory.  bf16 pools are staged as they
// are, in two buffers, and the products read them (the replay rewrites them
// in place); integer pools are staged raw in two buffers and widened into
// one bf16 buffer each step.
template <int KIND>
struct Layout {
  static constexpr bool QUANT = KIND >= 2;
  static constexpr int RAWL = KIND == 1 ? LPITCH : KIND == 2 ? RP : RP / 2;  // a staged latent row
  static constexpr int RAWP = KIND == 1 ? PPITCH : KIND == 2 ? PP : PP / 2;  // a staged rope row
  static constexpr int LAT = 0;                                // [2][KS][RAWL]
  static constexpr int ROPE = LAT + 2 * KS * RAWL;             // [2][KS][RAWP]
  static constexpr int CVT_LAT = ROPE + 2 * KS * RAWP;         // codes: bf16 [KS][LPITCH]
  static constexpr int CVT_ROPE = CVT_LAT + (QUANT ? KS * LPITCH : 0);  // codes: [KS][PPITCH]
  static constexpr int SCALES = CVT_ROPE + (QUANT ? KS * PPITCH : 0);  // [2 buffers][2][KS] f32
  static constexpr int LSC = SCALES + 4 * 2 * 2 * KS;  // the step's per-key factors [3][KS]
  static constexpr int RED = LSC + 4 * 3 * KS;          // [WARPS][HT][SPITCH] f32
  static constexpr int PBUF = RED + 4 * WARPS * HT * SPITCH;  // [HT][SPITCH] f32
  static constexpr int STATS = PBUF + 4 * HT * SPITCH;         // alpha, m, l [3][HT] f32
  static constexpr int TABLE = STATS + 4 * 3 * HT;             // the run's entries [eps] int
  static constexpr int BYTES = TABLE;                          // + 4 eps
  // a run's partial output for the cluster merge, over the staging buffers
  static constexpr int PART = 0;  // [HT][RP] f32
  static_assert(HT * RP * 4 <= RED, "the partial output overlays the staging buffers");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `n` (16, 8 or 4) bytes global -> shared, asynchronously; zeros (and no
// read) when `in` is false.
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in, int n) {
  const unsigned d = smem_u32(dst);
  const int sz = in ? n : 0;
  if (n == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(sz)
                 : "memory");
  } else if (n == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(sz)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(sz)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(const void* p, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
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

__device__ __forceinline__ unsigned bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const unsigned*>(&h);
}

// x0, x1 as bf16 hi + lo (one A-fragment register each): hi = bf16(x),
// lo = bf16(x - hi), the difference exact in fp32.
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

// The replay's codes clip(rint(x / s_aq), lo, hi) of 8 values in place,
// with the IEEE quotient computed without a division: q = x * (1 / s_aq),
// rounded, lies within an ulp of x / s_aq, the residual x - s_aq q is exact
// under an fma, and one more fma rounds the quotient correctly (Markstein's
// correction, given 1 / s_aq correctly rounded).  Branch-free: a division,
// or a branch to one, an element made the replay 2-4x slower on an H100.
// A zero keeps its value's code (0).
__device__ __forceinline__ void replay8(float (&x)[8], float s_aq, float inv, float lo, float hi) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float q = __fmul_rn(x[e], inv);
    x[e] = fminf(fmaxf(rintf(__fmaf_rn(__fmaf_rn(-s_aq, q, x[e]), inv, q)), lo), hi);
  }
}

// 8 codes as loaded (int8: two words, int4: one) widened to floats.
template <int KIND>
__device__ __forceinline__ void widen8(const uint8_t* p, float (&x)[8]) {
  if constexpr (KIND == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = static_cast<float>(static_cast<int>(w.x << (24 - 8 * e)) >> 24);
      x[4 + e] = static_cast<float>(static_cast<int>(w.y << (24 - 8 * e)) >> 24);
    }
  } else {
    const unsigned w = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = static_cast<float>(static_cast<int>(w << (28 - 4 * e)) >> 28);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(bits(__floats2bfloat162_rn(x[0], x[1])), bits(__floats2bfloat162_rn(x[2], x[3])),
                    bits(__floats2bfloat162_rn(x[4], x[5])), bits(__floats2bfloat162_rn(x[6], x[7])));
}

// A row of one valid key: its softmax weight is exactly 1, so the output is
// the key's latent itself, dequantized and replayed in fp32 as the
// reference computes it (code * scale, then clip(rint(x / s_aq)) * s_aq).
template <int KIND>
__device__ void single_key(const uint8_t* __restrict__ ckvp, const float* __restrict__ ckvs,
                           const int* __restrict__ bt, float* __restrict__ out, float s_aq,
                           const Args& a, int b, int h0) {
  const size_t row = static_cast<size_t>(bt[static_cast<size_t>(b) * a.MB]) * a.bs;
  const uint8_t* src = ckvp + row * a.lat_rb;
  const int heads = min(HT, a.H - h0);
  for (int i = threadIdx.x; i < heads * a.R; i += THREADS) {
    const int r = i % a.R;
    float x;
    if constexpr (KIND == 1) {
      x = __uint_as_float(static_cast<unsigned>(reinterpret_cast<const uint16_t*>(src)[r]) << 16);
    } else if constexpr (KIND == 2) {
      x = __fmul_rn(static_cast<float>(reinterpret_cast<const int8_t*>(src)[r]), ckvs[row]);
    } else {
      const int nib = (src[r / 2] >> (4 * (r & 1))) & 15;
      x = __fmul_rn(static_cast<float>((nib ^ 8) - 8), ckvs[row]);
    }
    if (a.replay) x = __fmul_rn(fminf(fmaxf(rintf(__fdiv_rn(x, s_aq)), a.q_lo), a.q_hi), s_aq);
    out[(static_cast<size_t>(b) * a.H + h0 + i / a.R) * a.R + r] = x;
  }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
paged_mla_attention_tc_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_pe,
                              const uint8_t* __restrict__ ckvp, const uint8_t* __restrict__ kpep,
                              const float* __restrict__ ckvs, const float* __restrict__ kpes,
                              const int* __restrict__ bt, const int* __restrict__ lengths,
                              const float* __restrict__ aq, float* __restrict__ out,
                              const Args a) {
  using Lay = Layout<KIND>;
  constexpr bool QUANT = Lay::QUANT;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint8_t sm[];
  float* scales = reinterpret_cast<float*>(sm + Lay::SCALES);  // [buf][lat, rope][KS]
  float* lsc = reinterpret_cast<float*>(sm + Lay::LSC);        // the latent score factor
  float* rsc = lsc + KS;                                        // the rope score factor
  float* fold = rsc + KS;                                       // folded into P
  float* red = reinterpret_cast<float*>(sm + Lay::RED);
  float* pbuf = reinterpret_cast<float*>(sm + Lay::PBUF);
  float* alpha_s = reinterpret_cast<float*>(sm + Lay::STATS);
  float* m_s = alpha_s + HT;
  float* l_s = m_s + HT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int h0 = blockIdx.x * HT;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int S = gridDim.z;
  const int len = min(lengths[b], a.MB * a.bs);
  const float s_aq = a.replay ? *aq : 1.0f;

  if (len == 1) {  // the same for every block of the cluster: no barrier is skipped
    if (z == 0) single_key<KIND>(ckvp, ckvs, bt, out, s_aq, a, b, h0);
    return;
  }

  // the keys of this run: whole table entries, none past the length
  const int kbeg = z * a.eps * a.bs;
  const int kend = min((z + 1) * a.eps * a.bs, len);
  const int nsteps = kend > kbeg ? (kend - kbeg + KS - 1) / KS : 0;

  // the run's table entries that hold valid keys, staged once
  int* table = reinterpret_cast<int*>(sm + Lay::TABLE);
  const int e0 = kbeg / a.bs;
  for (int e = tid; e < (kend - kbeg + a.bs - 1) / a.bs; e += THREADS)
    table[e] = bt[static_cast<size_t>(b) * a.MB + e0 + e];

  // zero the bf16 rows' columns past R and P once (copies never write them)
  if (a.R < RP || a.P < PP) {
    uint8_t* lat0 = sm + (QUANT ? Lay::CVT_LAT : Lay::LAT);
    for (int i = tid; i < (QUANT ? 1 : 2) * KS * (RP - a.R); i += THREADS) {
      const int row = i / (RP - a.R), c = i % (RP - a.R);
      reinterpret_cast<uint16_t*>(lat0 + row * LPITCH)[a.R + c] = 0;
    }
    uint8_t* rope0 = sm + (QUANT ? Lay::CVT_ROPE : Lay::ROPE);
    for (int i = tid; i < (QUANT ? 1 : 2) * KS * (PP - a.P); i += THREADS) {
      const int row = i / (PP - a.P), c = i % (PP - a.P);
      reinterpret_cast<uint16_t*>(rope0 + row * PPITCH)[a.P + c] = 0;
    }
  }
  // stage step `st` into buffer `buf`: TPK threads a key, each a share of
  // its latent and rope rows (and, for codes, its two scales)
  const auto stage = [&](int st, int buf) {
    const int key = tid / TPK, sub = tid % TPK;
    const int kp = kbeg + st * KS + key;
    const bool in = kp < kend;
    size_t row = 0;
    if (in) {
      const int e = kp / a.bs;
      row = static_cast<size_t>(table[e - e0]) * a.bs + (kp - e * a.bs);
    }
    uint8_t* ld = sm + Lay::LAT + (buf * KS + key) * Lay::RAWL;
    const uint8_t* ls = ckvp + row * a.lat_rb;
    for (int c = sub * a.lat_cg; c < a.lat_rb; c += TPK * a.lat_cg)
      cp_async(ld + c, in ? ls + c : ckvp, in, a.lat_cg);
    uint8_t* pd = sm + Lay::ROPE + (buf * KS + key) * Lay::RAWP;
    const uint8_t* ps = kpep + row * a.rope_rb;
    for (int c = sub * a.rope_cg; c < a.rope_rb; c += TPK * a.rope_cg)
      cp_async(pd + c, in ? ps + c : kpep, in, a.rope_cg);
    if (QUANT && sub < 2)
      cp_async(scales + (buf * 2 + sub) * KS + key, in ? (sub ? kpes : ckvs) + row : ckvs, in, 4);
  };

  __syncthreads();  // the table before the first copies
  if (nsteps > 0) stage(0, 0);
  cp_async_commit();

  // the query tile as A fragments (loaded while the first step's rows fly),
  // q split into bf16 hi + mid + lo: reg r of k-step ks holds row g + 8 (r &
  // 1), columns 16 ks + 8 (r >> 1) + 2 t4, + 1
  unsigned qh[4][4], qm[4][4], ql[4][4], ph_[4], pm_[4], pl_[4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = h0 + g + 8 * (r & 1);
      const int col = 64 * warp + 16 * ks + 8 * (r >> 1) + 2 * t4;
      const float* src = q_lat + (static_cast<size_t>(b) * a.H + h) * a.R + col;
      const bool in = h < a.H && col < a.R;  // R is even: col + 1 < R too
      split3(in ? src[0] : 0.0f, in ? src[1] : 0.0f, qh[ks][r], qm[ks][r], ql[ks][r]);
    }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int h = h0 + g + 8 * (r & 1);
    const int col = 16 * warp + 8 * (r >> 1) + 2 * t4;
    const float* src = q_pe + (static_cast<size_t>(b) * a.H + h) * a.P + col;
    const bool in = warp < 4 && h < a.H && col < a.P;
    split3(in ? src[0] : 0.0f, in ? src[1] : 0.0f, ph_[r], pm_[r], pl_[r]);
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
  float m_run = kNeg, l_run = 0.0f;  // softmax threads: head tid >> 4
  const float inv_aq = __frcp_rn(s_aq);
  // P with a code pool's token scale folded in (no replay) spans the scale's
  // range: three bf16 terms keep its 2^-24, as two keep P's own 2^-16 else
  const bool fold3 = QUANT && !a.replay;

  for (int st = 0; st < nsteps; ++st) {
    const int buf = st & 1;
    const int k0 = kbeg + st * KS;
    cp_async_wait<0>();
    __syncthreads();  // this step's rows have landed; every warp is done with the other buffer
    if (st + 1 < nsteps) stage(st + 1, buf ^ 1);
    cp_async_commit();
    // the step's per-key factors, and codes (or the replay's codes) widened to bf16
    if (tid < KS) {
      const bool in = k0 + tid < kend;
      const float cs = QUANT ? scales[(buf * 2) * KS + tid] : 1.0f;
      const float ks = QUANT ? scales[(buf * 2 + 1) * KS + tid] : 1.0f;
      lsc[tid] = in ? (a.replay ? s_aq : cs) : 0.0f;
      rsc[tid] = in ? ks : 0.0f;
      fold[tid] = in ? (a.replay ? 1.0f : cs) : 0.0f;
    }
    const int g8 = a.R / 8;
    if constexpr (QUANT) {  // 8 codes a thread and step into the bf16 buffer
      for (int i = tid; i < KS * g8; i += THREADS) {
        const int key = i / g8, c8 = i - key * g8;
        float x[8];
        widen8<KIND>(sm + Lay::LAT + (buf * KS + key) * Lay::RAWL + (KIND == 2 ? 8 : 4) * c8, x);
        if (a.replay) {
          const float cs = scales[(buf * 2) * KS + key];
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = __fmul_rn(x[e], cs);
          replay8(x, s_aq, inv_aq, a.q_lo, a.q_hi);
        }
        *reinterpret_cast<uint4*>(sm + Lay::CVT_LAT + key * LPITCH + 16 * c8) = pack8(x);
      }
      const int p8 = a.P / 8;
      for (int i = tid; i < KS * p8; i += THREADS) {
        const int key = i / p8, c8 = i - key * p8;
        float x[8];
        widen8<KIND>(sm + Lay::ROPE + (buf * KS + key) * Lay::RAWP + (KIND == 2 ? 8 : 4) * c8, x);
        *reinterpret_cast<uint4*>(sm + Lay::CVT_ROPE + key * PPITCH + 16 * c8) = pack8(x);
      }
    } else if (a.replay) {  // bf16: the replay's codes in place
      for (int i = tid; i < KS * g8; i += THREADS) {
        const int key = i / g8, c8 = i - key * g8;
        uint4* p = reinterpret_cast<uint4*>(sm + Lay::LAT + (buf * KS + key) * LPITCH + 16 * c8);
        const uint4 w = *p;
        const unsigned wv[4] = {w.x, w.y, w.z, w.w};
        float x[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          x[2 * k] = __uint_as_float(wv[k] << 16);
          x[2 * k + 1] = __uint_as_float(wv[k] & 0xffff0000u);
        }
        replay8(x, s_aq, inv_aq, a.q_lo, a.q_hi);
        *p = pack8(x);
      }
    }
    __syncthreads();
    const uint8_t* lat = sm + (QUANT ? Lay::CVT_LAT : Lay::LAT + buf * KS * LPITCH);
    const uint8_t* rope = sm + (QUANT ? Lay::CVT_ROPE : Lay::ROPE + buf * KS * PPITCH);

    // S = Q K^T over the warp's 64 latent columns: n8 tile j holds keys
    // 8 j .. 8 j + 7; the warp's partial, times the per-key latent factor,
    // goes to shared memory, then warps 0-3 add their 16 rope columns' part
    // (times the rope factor) in the same registers
    float sc[KS / 8][4];
#pragma unroll
    for (int j = 0; j < KS / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[j][r] = 0.0f;
#pragma unroll
    for (int tp = 0; tp < KS / 16; ++tp) {
      const int key = 16 * tp + (lane & 7) + 8 * (lane >> 4);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        unsigned r[4];
        ldsm_x4(lat + key * LPITCH + 16 * (8 * warp + 2 * ks + ((lane >> 3) & 1)), r);
        mma(sc[2 * tp], qh[ks], r[0], r[1]);
        mma(sc[2 * tp], qm[ks], r[0], r[1]);
        mma(sc[2 * tp], ql[ks], r[0], r[1]);
        mma(sc[2 * tp + 1], qh[ks], r[2], r[3]);
        mma(sc[2 * tp + 1], qm[ks], r[2], r[3]);
        mma(sc[2 * tp + 1], ql[ks], r[2], r[3]);
      }
    }
    float* rw = red + warp * HT * SPITCH;
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
      const int key = 8 * j + 2 * t4;
      const float l0 = lsc[key], l1 = lsc[key + 1];
      *reinterpret_cast<float2*>(rw + g * SPITCH + key) = make_float2(sc[j][0] * l0, sc[j][1] * l1);
      *reinterpret_cast<float2*>(rw + (g + 8) * SPITCH + key) =
          make_float2(sc[j][2] * l0, sc[j][3] * l1);
    }
    if (warp < 4) {
#pragma unroll
      for (int j = 0; j < KS / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[j][r] = 0.0f;
#pragma unroll
      for (int tp = 0; tp < KS / 16; ++tp) {
        const int key = 16 * tp + (lane & 7) + 8 * (lane >> 4);
        unsigned r[4];
        ldsm_x4(rope + key * PPITCH + 16 * (2 * warp + ((lane >> 3) & 1)), r);
        mma(sc[2 * tp], ph_, r[0], r[1]);
        mma(sc[2 * tp], pm_, r[0], r[1]);
        mma(sc[2 * tp], pl_, r[0], r[1]);
        mma(sc[2 * tp + 1], ph_, r[2], r[3]);
        mma(sc[2 * tp + 1], pm_, r[2], r[3]);
        mma(sc[2 * tp + 1], pl_, r[2], r[3]);
      }
#pragma unroll
      for (int j = 0; j < KS / 8; ++j) {
        const int key = 8 * j + 2 * t4;
        const float r0 = rsc[key], r1 = rsc[key + 1];
        float2* lo = reinterpret_cast<float2*>(rw + g * SPITCH + key);
        float2* hi = reinterpret_cast<float2*>(rw + (g + 8) * SPITCH + key);
        *lo = make_float2(lo->x + sc[j][0] * r0, lo->y + sc[j][1] * r1);
        *hi = make_float2(hi->x + sc[j][2] * r0, hi->y + sc[j][3] * r1);
      }
    }
    __syncthreads();

    // online softmax: 16 threads a head, KPT keys each
    {
      const int hh = tid >> 4, k2 = KPT * (tid & 15);
      float s[KPT], p[KPT];
      float mx = kNeg;
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        float x = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) x += red[(w * HT + hh) * SPITCH + k2 + u];
        s[u] = x * a.scale;
        if (k0 + k2 + u < kend) mx = fmaxf(mx, s[u]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        p[u] = k0 + k2 + u < kend ? expf(s[u] - m_new) : 0.0f;
        ps += p[u];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l_run = alpha * l_run + ps;
      m_run = m_new;
#pragma unroll
      for (int u = 0; u < KPT; ++u) pbuf[hh * SPITCH + k2 + u] = p[u] * fold[k2 + u];
      if ((tid & 15) == 0) alpha_s[hh] = alpha;
    }
    __syncthreads();

    // O = alpha O + P V over the warp's 64 latent columns, P as bf16 hi + lo
    const float a0 = alpha_s[g], a1 = alpha_s[g + 8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      unsigned p0[4], p1[4], p2[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 pv = *reinterpret_cast<const float2*>(
            pbuf + (g + 8 * (r & 1)) * SPITCH + 16 * kk + 8 * (r >> 1) + 2 * t4);
        if (fold3) {
          split3(pv.x, pv.y, p0[r], p1[r], p2[r]);
        } else {
          split2(pv.x, pv.y, p0[r], p1[r]);
        }
      }
      const int key = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int w2 = 0; w2 < 4; ++w2) {
        unsigned r[4];
        ldsm_x4_t(lat + key * LPITCH + 16 * (8 * warp + 2 * w2 + (lane >> 4)), r);
        mma(acc[2 * w2], p0, r[0], r[1]);
        mma(acc[2 * w2], p1, r[0], r[1]);
        mma(acc[2 * w2 + 1], p0, r[2], r[3]);
        mma(acc[2 * w2 + 1], p1, r[2], r[3]);
        if (fold3) {
          mma(acc[2 * w2], p2, r[0], r[1]);
          mma(acc[2 * w2 + 1], p2, r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if ((tid & 15) == 0) {
    m_s[tid >> 4] = m_run;
    l_s[tid >> 4] = l_run;
  }
  __syncthreads();  // every warp is done with the staging buffers

  const float out_mul = a.replay ? s_aq : 1.0f;  // the replay's codes times s_aq
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int h = h0 + g + 8 * i;
      if (h >= a.H) continue;
      const float l = l_s[g + 8 * i];
      const float norm = l > 0.0f ? 1.0f / fmaxf(l, 1e-30f) : 0.0f;
      float* orow = out + (static_cast<size_t>(b) * a.H + h) * a.R;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * warp + 8 * j + 2 * t4;
        if (col < a.R)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(acc[j][2 * i] * norm * out_mul, acc[j][2 * i + 1] * norm * out_mul);
      }
    }
    return;
  }

  // several runs: a row's runs are one cluster; each block leaves its
  // unnormalized partial in shared memory, and after a cluster barrier the
  // blocks share out the outputs, merging every run's partial in run order
  // through distributed shared memory; a second barrier keeps each block's
  // shared memory alive until it has been read
  float* part = reinterpret_cast<float*>(sm + Lay::PART);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(part + (g + 8 * i) * RP + 64 * warp + 8 * j + 2 * t4) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float* parts[MAX_SPLITS];
  const float* ms[MAX_SPLITS];
  const float* ls[MAX_SPLITS];
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r) {
    const int rr = r < S ? r : 0;
    parts[r] = cluster.map_shared_rank(part, rr);
    ms[r] = cluster.map_shared_rank(m_s, rr);
    ls[r] = cluster.map_shared_rank(l_s, rr);
  }
  const int heads = min(HT, a.H - h0);
  for (int i = z * THREADS + tid; i < heads * a.R; i += S * THREADS) {
    const int hh = i / a.R, col = i % a.R;
    float mr[MAX_SPLITS];
    float mx = kNeg;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      mr[r] = r < S ? ms[r][hh] : kNeg;
      mx = fmaxf(mx, mr[r]);
    }
    float l = 0.0f, o = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r >= S) break;
      const float f = expf(mr[r] - mx);
      l += ls[r][hh] * f;
      o += parts[r][hh * RP + col] * f;
    }
    const float norm = l > 0.0f ? 1.0f / fmaxf(l, 1e-30f) : 0.0f;
    out[(static_cast<size_t>(b) * a.H + h0 + hh) * a.R + col] = o * norm * out_mul;
  }
  cluster.sync();
}

// The largest copy (16, 8 or 4 bytes) that divides a row of `bytes`.
int copy_bytes(int bytes) { return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : 4; }

template <int KIND>
int launch(const void* q_lat, const void* q_pe, const void* ckvp, const void* kpep,
           const void* ckvs, const void* kpes, const void* bt, const void* lengths,
           const void* aq, void* out, int B, int H, int R, int P, int bs, int MB, float scale,
           int act_bits, int splits, cudaStream_t stream) {
  if (R > RP || P > PP || R % 8 || P % 8 || bs < 1 || MB < 1 || splits < 1 ||
      splits > MAX_SPLITS || act_bits > 9)
    return static_cast<int>(cudaErrorInvalidValue);
  const int eps = (MB + splits - 1) / splits;
  if ((splits - 1) * eps >= MB) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.B = B;
  a.H = H;
  a.R = R;
  a.P = P;
  a.bs = bs;
  a.MB = MB;
  a.eps = eps;
  a.lat_rb = KIND == 1 ? 2 * R : KIND == 2 ? R : R / 2;
  a.rope_rb = KIND == 1 ? 2 * P : KIND == 2 ? P : P / 2;
  a.lat_cg = copy_bytes(a.lat_rb);
  a.rope_cg = copy_bytes(a.rope_rb);
  a.replay = act_bits > 0;
  a.scale = scale;
  a.q_lo = act_bits > 0 ? static_cast<float>(-(1 << (act_bits - 1))) : 0.0f;
  a.q_hi = act_bits > 0 ? static_cast<float>((1 << (act_bits - 1)) - 1) : 0.0f;
  const int smem = Layout<KIND>::BYTES + 4 * eps;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_mla_attention_tc_kernel<KIND>;
  static int sized = 0;  // shared memory above 48 KB must be asked for
  if (smem > sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((H + HT - 1) / HT, B, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;  // a row's runs
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(q_lat), static_cast<const float*>(q_pe),
      static_cast<const uint8_t*>(ckvp), static_cast<const uint8_t*>(kpep),
      static_cast<const float*>(ckvs), static_cast<const float*>(kpes),
      static_cast<const int*>(bt), static_cast<const int*>(lengths),
      static_cast<const float*>(aq), static_cast<float*>(out), a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 on success).  q_lat, q_pe
// and out are fp32; the two pools share one kind: 0 fp32, 1 bf16, 2 int8
// codes, 3 packed int4 (uint8, half the width), the integer kinds with fp32
// per-token scale pools ckvs/kpes (NB, bs), else null.  `aq` points at one
// fp32 activation-quantizer scale on the device and is read only when
// act_bits > 0.  Shapes are validated by the Python wrapper; R <= 512,
// P <= 64, bs <= 32 and R, P multiples of 8 are checked here too.  The pools
// must be 16-byte aligned, and so must every block of them.  `tc` picks the
// tensor-core kernel (bf16, int8 and int4 pools, act_bits <= 9), whose row
// table is cut into `splits` (at most 8) runs of ceil(MB / splits) entries,
// a row's runs one cluster; else the CUDA-core kernel (`splits` must be 1).
extern "C" int paged_mla_attention_launch(const void* q_lat, const void* q_pe,
                                          const void* ckvp, const void* kpep,
                                          const void* ckvs, const void* kpes,
                                          const void* bt, const void* lengths,
                                          const void* aq, void* out, int B, int H,
                                          int R, int P, int bs, int MB, float scale,
                                          int act_bits, int pool_kind, void* stream,
                                          int splits, int tc) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    switch (pool_kind) {
      case 1:
        return tc::launch<1>(q_lat, q_pe, ckvp, kpep, ckvs, kpes, bt, lengths, aq, out, B, H, R,
                             P, bs, MB, scale, act_bits, splits, s);
      case 2:
        return tc::launch<2>(q_lat, q_pe, ckvp, kpep, ckvs, kpes, bt, lengths, aq, out, B, H, R,
                             P, bs, MB, scale, act_bits, splits, s);
      case 3:
        return tc::launch<3>(q_lat, q_pe, ckvp, kpep, ckvs, kpes, bt, lengths, aq, out, B, H, R,
                             P, bs, MB, scale, act_bits, splits, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
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
