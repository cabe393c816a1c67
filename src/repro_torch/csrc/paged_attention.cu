// Paged-attention decode for Hopper (sm_90a): one query token per row
// against K/V pools read through a block table.
//
// Replaces the Pallas TPU kernel `paged_attention_kernel` /
// `paged_attention_pallas` (repro/kernels/paged_attention.py): fp32 and bf16
// pools, int8 code pools, and packed int4 pools (uint8, two codes a byte at
// Dh / 2: element 2i in the low nibble, 2i + 1 in the high, each
// sign-extended as (x ^ 8) - 8).  Integer pools come with fp32 per-slot scale
// pools ks/vs (NB, bs, KV) and are dequantized in registers, in the
// reference's order: code times the slot's scale, in fp32 (__fmul_rn), then
// the dot with q * scale.  Inputs: q (B, H, Dh); pools kp/vp (NB, bs, KV, Dh)
// (Dh / 2 bytes a row for int4); block table bt (B, MB) int32; lengths (B,)
// int32 counting valid keys (this step's included).  Key position p of row b
// lives at pool block bt[b, p / bs], slot p % bs, and is valid iff p < length
// (and p >= length - window when a window is set).  Output (B, H, Dh) in q's
// dtype:
//   softmax over the valid keys of (q * scale) . k, times v, in fp32, with
//   rows that have no valid key giving zeros (the flush-time guard
//   `l > 0 ? 1 / max(l, 1e-30) : 0`), never NaN.
//
// What bounds it on the H100: the K/V bytes each row reads, length x KV x
// Dh x 2 (K and V) x the pool's element size (1 byte for int8, half a byte
// for int4, plus 4 bytes of scale a slot and KV head), over the 3.35 TB/s of
// HBM; the arithmetic (2 x G flops per K/V element) is negligible.  At a
// served context (thousands of keys a row) that is tens of MB a call; at a
// few dozen keys the launch and the round trips to memory bound it.
//
// Design (split-KV, "flash-decoding"):
//   * Grid (KV x head groups, B, S).  The TPU walks a row's table entries in
//     order on one core; here each row's table is cut into S runs of whole
//     entries, one block each, so B x KV x S blocks cover the card even at
//     small batch.  S comes from MB (a static shape) and the SM count in the
//     wrapper, never from `lengths`.  A block loads its row's length and
//     only the table entries that hold its valid keys (from the window's
//     first key to the last key): an entry past the length is never read,
//     nor the pool block behind it.  A block whose run holds no valid key
//     writes an empty partial (l = 0) at once.
//   * Inside a block, each warp takes its own passes of consecutive keys: a
//     K/V row is spread over Dh / 8 lanes, 8 elements a lane (a bf16 Dh=64
//     row is 8 lanes of 16 bytes; fp32 two 16-byte loads a lane; int8 8
//     bytes, int4 4 bytes, fully coalesced), so a warp holds 32 / (Dh / 8)
//     keys at once, 2 a lane group a pass.  Scores are the lane group's
//     partial dots summed with xor shuffles.  Eight elements a lane (rather
//     than 16 bytes whatever the type) keep the G query rows and G
//     accumulators of 8 fp32 values in registers for every pool type.
//   * The G = H / KV query heads of a KV head share every K/V load (up to 4
//     heads a block; more heads take more head groups).
//   * Each warp streams its passes through its own 4-deep ring in shared
//     memory: every lane `cp.async`s its own pieces (and slot scales) of the
//     next three passes while it multiplies the current one, and reads back
//     only what it copied, so it waits on its own copies and nothing else;
//     the bytes in flight do not depend on the registers the math needs.
//   * Each lane group keeps its own online softmax (m, l, acc), rescaled
//     once a pass; the groups of a warp merge by shuffles, the warps of a
//     block through shared memory.  No barrier a key or a table entry.
//   * Splits merge in a fixed order in the same launch, without a
//     workspace: the S runs of a (row, KV head, head group) are one
//     thread-block cluster (S <= 8).  Each block leaves its partial (m, l,
//     unnormalized acc) in shared memory; after a cluster barrier the
//     blocks share out the outputs, each merging the S partials in run
//     order through distributed shared memory.  The order is fixed, so the
//     output is the same on every run, and nothing is left between calls
//     (a CUDA graph replays it as it is).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int EPL = 8;     // elements of a K/V row a lane holds
constexpr int UNROLL = 2;  // keys a lane group takes a pass
constexpr int STAGES = 4;  // a warp's ring of passes: 3 in flight + 1 read
constexpr int MAX_SPLITS = 8;  // a row's runs are one thread-block cluster (portable size)
constexpr float kNeg = -1e30f;

// Bytes of one lane's piece (8 elements) of a pool row.
template <typename TP>
__host__ __device__ constexpr int piece_bytes() {
  return std::is_same<TP, uint8_t>::value ? EPL / 2 : EPL * static_cast<int>(sizeof(TP));
}

// Bytes of one warp's pass in its ring: UNROLL keys x K and V x 32 lanes'
// pieces, then (integer pools) the same lanes' copies of the slot scales.
template <typename TP>
__host__ __device__ constexpr int pass_bytes() {
  constexpr bool quant = std::is_same<TP, int8_t>::value || std::is_same<TP, uint8_t>::value;
  return UNROLL * 2 * 32 * (piece_bytes<TP>() + (quant ? 4 : 0));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` (4, 8 or 16) global -> shared, asynchronously.
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(bytes)
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

// Bytes of one pool row of Dh elements.
template <typename TP>
__host__ __device__ constexpr int row_bytes(int Dh) {
  return std::is_same<TP, uint8_t>::value ? Dh / 2 : Dh * static_cast<int>(sizeof(TP));
}

// A lane's 8 elements of one pool row, as loaded (up to 32 bytes).
struct Raw {
  uint4 a, b;
};

// Load elements d0 .. d0 + 7 of the row at `row` (clipped to Dh); one or two
// vector loads when `vec` (Dh a multiple of 8 and the pool 16-byte aligned).
template <typename TP>
__device__ __forceinline__ Raw load_piece(const uint8_t* row, int d0, int Dh, bool vec) {
  Raw r{make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  if (vec && d0 + EPL <= Dh) {
    if constexpr (std::is_same<TP, float>::value) {
      r.a = __ldg(reinterpret_cast<const uint4*>(row + 4 * d0));
      r.b = __ldg(reinterpret_cast<const uint4*>(row + 4 * d0) + 1);
    } else if constexpr (std::is_same<TP, __nv_bfloat16>::value) {
      r.a = __ldg(reinterpret_cast<const uint4*>(row + 2 * d0));
    } else if constexpr (std::is_same<TP, int8_t>::value) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + d0));
      r.a.x = v.x;
      r.a.y = v.y;
    } else {
      r.a.x = __ldg(reinterpret_cast<const unsigned*>(row + d0 / 2));
    }
    return r;
  }
  unsigned w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int e = 0; e < EPL && d0 + e < Dh; ++e) {
    const int d = d0 + e;
    if constexpr (std::is_same<TP, float>::value) {
      w[e] = __ldg(reinterpret_cast<const unsigned*>(row) + d);
    } else if constexpr (std::is_same<TP, __nv_bfloat16>::value) {
      w[e >> 1] |= static_cast<unsigned>(__ldg(reinterpret_cast<const uint16_t*>(row) + d))
                   << (16 * (e & 1));
    } else if constexpr (std::is_same<TP, int8_t>::value) {
      w[e >> 2] |= static_cast<unsigned>(__ldg(row + d)) << (8 * (e & 3));
    } else {
      const unsigned byte = __ldg(row + d / 2);
      w[0] |= ((d & 1) ? (byte >> 4) : (byte & 0xF)) << (4 * e);
    }
  }
  r.a = make_uint4(w[0], w[1], w[2], w[3]);
  r.b = make_uint4(w[4], w[5], w[6], w[7]);
  return r;
}

// The 8 loaded elements as fp32: bf16 widened exactly, integer codes times
// the slot's scale `sc` (one rounded multiply, as the reference dequantizes).
template <typename TP>
__device__ __forceinline__ void widen(const Raw& r, float sc, float (&f)[EPL]) {
  if constexpr (std::is_same<TP, float>::value) {
    const unsigned w[8] = {r.a.x, r.a.y, r.a.z, r.a.w, r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
    for (int e = 0; e < EPL; ++e) f[e] = __uint_as_float(w[e]);
  } else if constexpr (std::is_same<TP, __nv_bfloat16>::value) {
    const unsigned w[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      f[e] = __uint_as_float((e & 1) ? (w[e >> 1] & 0xffff0000u) : (w[e >> 1] << 16));
  } else if constexpr (std::is_same<TP, int8_t>::value) {
    const unsigned w[2] = {r.a.x, r.a.y};
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int code = static_cast<int8_t>((w[e >> 2] >> (8 * (e & 3))) & 0xff);
      f[e] = __fmul_rn(static_cast<float>(code), sc);
    }
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int nib = static_cast<int>((r.a.x >> (4 * e)) & 0xF);
      f[e] = __fmul_rn(static_cast<float>((nib ^ 8) - 8), sc);
    }
  }
}

// The kernel's launch-wide arguments.
struct Args {
  int B, H, KV, Dh, bs, MB, window;
  int G, head_groups;  // G = H / KV query heads a KV head, in groups of GB
  int eps;             // table entries a split (gridDim.z splits, one cluster)
  float scale;
  int vec;             // pools and q allow the vector loads
};

template <typename TQ, typename TP, int GB>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const TQ* __restrict__ q, const uint8_t* __restrict__ kp,
                       const uint8_t* __restrict__ vp, const float* __restrict__ ksc,
                       const float* __restrict__ vsc, const int* __restrict__ bt,
                       const int* __restrict__ lengths, TQ* __restrict__ out, Args a) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value || std::is_same<TP, uint8_t>::value;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x / a.head_groups;   // KV head
  const int hg = blockIdx.x % a.head_groups;  // head group
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int Dh = a.Dh, bs = a.bs;
  const int heads = min(GB, a.G - hg * GB);  // live heads of the group
  const int h0 = h * a.G + hg * GB;          // first query head
  int lpr = 1;  // lanes a K/V row: the pieces of 8 elements, rounded up to a power of two
  while (lpr * EPL < Dh) lpr <<= 1;
  const int rpw = 32 / lpr;  // keys a warp holds at once
  const int sub = lane / lpr;
  const int d0 = (lane % lpr) * EPL;
  const bool has = d0 < Dh;
  const int rb = row_bytes<TP>(Dh);
  const int pstride = GB * (Dh + 2);

  // the run's valid keys: [p_lo, p_hi)
  const int len = lengths[b];
  const int lo_win = a.window > 0 ? max(len - a.window, 0) : 0;
  const int p_lo = max(split * a.eps * bs, lo_win);
  const int p_hi = min(min((split + 1) * a.eps * bs, len), a.MB * bs);
  const int j_lo = p_lo / bs;
  const int n_ent = p_hi > p_lo ? (p_hi - 1) / bs - j_lo + 1 : 0;
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem) + warp * STAGES * pass_bytes<TP>();
  float* wpart = smem + WARPS * STAGES * pass_bytes<TP>() / 4;  // WARPS partials of GB (Dh + 2)
  // then the block's partial (pstride floats), then the run's entries that hold valid keys
  int* bts = reinterpret_cast<int*>(wpart + (WARPS + 1) * pstride);
  for (int i = tid; i < n_ent; i += THREADS) bts[i] = bt[static_cast<size_t>(b) * a.MB + j_lo + i];

  // this lane's query pieces, times the score scale
  float qv[GB][EPL];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    const bool live = gi < heads && has;
    const TQ* qrow = q + (static_cast<size_t>(b) * a.H + h0 + (live ? gi : 0)) * Dh;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qv[gi][e] = live && d0 + e < Dh ? to_f32(qrow[d0 + e]) * a.scale : 0.0f;
  }
  float m[GB], l[GB], acc[GB][EPL];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    m[gi] = kNeg;
    l[gi] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.0f;
  }
  __syncthreads();  // bts

  // each warp streams its passes (UNROLL keys a lane group, rpw groups) through
  // its own ring: every lane copies its own pieces (and scales) and reads
  // back only those, so a lane waits on its own copies and nothing else
  constexpr int PB = piece_bytes<TP>();
  const int pass = rpw * UNROLL;
  const int npass = p_hi > p_lo + warp * pass ? (p_hi - p_lo - warp * pass - 1) / (WARPS * pass) + 1
                                              : 0;
  const bool vec = a.vec != 0;
  auto piece = [&](int slot, int u, int kv) {
    return ring + slot * pass_bytes<TP>() + ((u * 2 + kv) * 32 + lane) * PB;
  };
  auto scale_at = [&](int slot, int u, int kv) {
    return reinterpret_cast<float*>(ring + slot * pass_bytes<TP>() + UNROLL * 2 * 32 * PB) +
           (u * 2 + kv) * 32 + lane;
  };
  const int bs_shift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;  // block size a power of two
  auto issue = [&](int slot, int i) {
    const int base = p_lo + (warp + WARPS * i) * pass;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int kpos = base + sub + rpw * u;
      if (i >= npass || kpos >= p_hi) continue;
      const int ent = bs_shift >= 0 ? kpos >> bs_shift : kpos / bs;
      const size_t slot_kv =
          (static_cast<size_t>(bts[ent - j_lo]) * bs + (kpos - ent * bs)) * a.KV + h;
      const uint8_t* rows[2] = {kp + slot_kv * rb, vp + slot_kv * rb};
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        if (has && vec && d0 + EPL <= Dh) {
          const uint8_t* src = rows[kv] + static_cast<size_t>(d0) * PB / EPL;
          if constexpr (PB == 32) {
            cp_async<16>(piece(slot, u, kv), src);
            cp_async<16>(piece(slot, u, kv) + 16, src + 16);
          } else {
            cp_async<PB>(piece(slot, u, kv), src);
          }
        } else if (has) {  // a row of other than 8k elements, or a pool off 16 bytes
          const Raw r = load_piece<TP>(rows[kv], d0, Dh, false);
          const unsigned wds[8] = {r.a.x, r.a.y, r.a.z, r.a.w, r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
          for (int t = 0; t < PB / 4; ++t) reinterpret_cast<unsigned*>(piece(slot, u, kv))[t] = wds[t];
        }
        if constexpr (kQuant) cp_async<4>(scale_at(slot, u, kv), (kv ? vsc : ksc) + slot_kv);
      }
    }
  };
  auto fetch = [&](int slot, int u, int kv) {  // a piece back from the ring, as loaded
    Raw r{make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
    const uint8_t* p = piece(slot, u, kv);
    if constexpr (PB == 32) {
      r.a = *reinterpret_cast<const uint4*>(p);
      r.b = *reinterpret_cast<const uint4*>(p + 16);
    } else if constexpr (PB == 16) {
      r.a = *reinterpret_cast<const uint4*>(p);
    } else if constexpr (PB == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      r.a.x = v.x;
      r.a.y = v.y;
    } else {
      r.a.x = *reinterpret_cast<const unsigned*>(p);
    }
    return r;
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    issue(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < npass; ++i) {
    cp_async_wait<STAGES - 2>();  // this lane's copies of pass i have landed
    issue((i + STAGES - 1) % STAGES, i + STAGES - 1);  // into pass i - 1's slot
    cp_async_commit();
    const int slot = i % STAGES;
    const int base = p_lo + (warp + WARPS * i) * pass;
    bool ok[UNROLL];
    float s[GB][UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = base + sub + rpw * u < p_hi;
      float kf[EPL];
      if (ok[u] && has) {
        widen<TP>(fetch(slot, u, 0), kQuant ? *scale_at(slot, u, 0) : 0.0f, kf);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[e] = 0.0f;
      }
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += qv[gi][e] * kf[e];
        s[gi][u] = dot;
      }
    }
    for (int off = 1; off < lpr; off <<= 1)  // the lane group's partial dots summed
#pragma unroll
      for (int gi = 0; gi < GB; ++gi)
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) s[gi][u] += __shfl_xor_sync(0xffffffffu, s[gi][u], off);
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (ok[u]) mx = fmaxf(mx, s[gi][u]);
      const float alpha = expf(m[gi] - mx);
      m[gi] = mx;
      l[gi] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[gi][e] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (ok[u]) {
          const float p = expf(s[gi][u] - mx);
          l[gi] += p;
          s[gi][u] = p;
        }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u] || !has) continue;
      float vf[EPL];
      widen<TP>(fetch(slot, u, 1), kQuant ? *scale_at(slot, u, 1) : 0.0f, vf);
#pragma unroll
      for (int gi = 0; gi < GB; ++gi)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[gi][e] += s[gi][u] * vf[e];
    }
  }
  cp_async_wait<0>();

  // the warp's lane groups merged (xor partners compute the same sums)
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float mn = fmaxf(m[gi], mo);
      const float fa = expf(m[gi] - mn), fb = expf(mo - mn);
      l[gi] = l[gi] * fa + lo * fb;
      m[gi] = mn;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
        acc[gi][e] = acc[gi][e] * fa + ao * fb;
      }
    }
  }
  float* mine = wpart + warp * pstride;  // [GB][Dh] acc, then GB m, GB l
  if (sub == 0 && has) {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        if (d0 + e < Dh) mine[gi * Dh + d0 + e] = acc[gi][e];
      if (lane == 0) {
        mine[GB * Dh + gi] = m[gi];
        mine[GB * Dh + GB + gi] = l[gi];
      }
    }
  }
  __syncthreads();

  // the block's partial: the warps merged in order
  float* slot_out = wpart + WARPS * pstride;  // [GB][Dh] acc, then GB m, GB l
  for (int i = tid; i < GB * Dh; i += THREADS) {
    const int gi = i / Dh;
    float mx = kNeg;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wpart[w * pstride + GB * Dh + gi]);
    float ls = 0.0f, as = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(wpart[w * pstride + GB * Dh + gi] - mx);
      ls += wpart[w * pstride + GB * Dh + GB + gi] * f;
      as += wpart[w * pstride + i] * f;
    }
    if (S == 1) {
      if (gi < heads) {
        const float norm = ls > 0.0f ? 1.0f / fmaxf(ls, 1e-30f) : 0.0f;
        from_f32(as * norm, &out[(static_cast<size_t>(b) * a.H + h0 + gi) * Dh + i % Dh]);
      }
      continue;
    }
    slot_out[i] = as;
    if (i % Dh == 0) {
      slot_out[GB * Dh + gi] = mx;
      slot_out[GB * Dh + GB + gi] = ls;
    }
  }
  if (S == 1) return;
  // several runs: a (row, KV head, head group)'s runs are one thread-block
  // cluster; after a cluster barrier its blocks share out the outputs, each
  // merging every run's partial through distributed shared memory in run
  // order (the same sums on every run), and a second barrier keeps each
  // block's shared memory alive until it has been read
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float* parts[MAX_SPLITS];
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r)
    parts[r] = r < S ? cluster.map_shared_rank(slot_out, r) : slot_out;
  for (int i = split * THREADS + tid; i < heads * Dh; i += S * THREADS) {
    const int gi = i / Dh;
    float mr[MAX_SPLITS];
    float mx = kNeg;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      mr[r] = r < S ? parts[r][GB * Dh + gi] : kNeg;
      mx = fmaxf(mx, mr[r]);
    }
    float ls = 0.0f, as = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r >= S) break;
      const float f = expf(mr[r] - mx);
      ls += parts[r][GB * Dh + GB + gi] * f;
      as += parts[r][i] * f;
    }
    const float norm = ls > 0.0f ? 1.0f / fmaxf(ls, 1e-30f) : 0.0f;
    from_f32(as * norm, &out[(static_cast<size_t>(b) * a.H + h0 + gi) * Dh + i % Dh]);
  }
  cluster.sync();
}

template <typename TQ, typename TP, int GB>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* bt, const void* lengths, void* out, const Args& a, int splits,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(WARPS) * STAGES * pass_bytes<TP>() +
                      sizeof(float) * (WARPS + 1) * GB * (a.Dh + 2) + sizeof(int) * a.eps;
  auto kernel = paged_attention_kernel<TQ, TP, GB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.KV * a.head_groups, a.B, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;  // a (row, KV head, head group)'s runs
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(q), static_cast<const uint8_t*>(kp),
      static_cast<const uint8_t*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename TQ, typename TP>
int launch_heads(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
                 const void* bt, const void* lengths, void* out, Args a, int splits,
                 cudaStream_t s) {
  const int gb = a.G < 4 ? a.G : 4;
  a.head_groups = (a.G + gb - 1) / gb;
  switch (gb) {
    case 1:
      return launch<TQ, TP, 1>(q, kp, vp, ks, vs, bt, lengths, out, a, splits, s);
    case 2:
      return launch<TQ, TP, 2>(q, kp, vp, ks, vs, bt, lengths, out, a, splits, s);
    case 3:
      return launch<TQ, TP, 3>(q, kp, vp, ks, vs, bt, lengths, out, a, splits, s);
    default:
      return launch<TQ, TP, 4>(q, kp, vp, ks, vs, bt, lengths, out, a, splits, s);
  }
}

template <typename TQ>
int launch_pools(const void* q, const void* kp, const void* vp, const void* ks,
                 const void* vs, const void* bt, const void* lengths, void* out,
                 const Args& a, int splits, int pool_kind, cudaStream_t s) {
  switch (pool_kind) {
    case 0:
      return launch_heads<TQ, float>(q, kp, vp, ks, vs, bt, lengths, out, a, splits, s);
    case 1:
      return launch_heads<TQ, __nv_bfloat16>(q, kp, vp, ks, vs, bt, lengths, out, a, splits, s);
    case 2:
      return launch_heads<TQ, int8_t>(q, kp, vp, ks, vs, bt, lengths, out, a, splits, s);
    case 3:
      return launch_heads<TQ, uint8_t>(q, kp, vp, ks, vs, bt, lengths, out, a, splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  q and
// out are fp32 (q_bf16 = 0) or bf16 (1); the two pools share one kind:
// 0 fp32, 1 bf16, 2 int8 codes, 3 packed int4 (uint8, Dh / 2 bytes a row),
// the integer kinds with fp32 scale pools ks/vs (NB, bs, KV), else null.
// Shapes are validated by the Python wrapper; Dh is at most 256.  `window`
// <= 0 means no sliding window.  The table is cut into `splits` (at most 8)
// runs of ceil(MB / splits) entries, a row's runs one cluster.
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* bt,
                                      const void* lengths, void* out, int B,
                                      int H, int KV, int Dh, int bs, int MB,
                                      float scale, int window, int q_bf16,
                                      int pool_kind, void* stream, int splits) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh < 1 || Dh > 32 * EPL || KV < 1 || H % KV != 0 || MB < 1 || splits < 1 ||
      splits > MAX_SPLITS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int eps = (MB + splits - 1) / splits;
  if ((splits - 1) * eps >= MB) return static_cast<int>(cudaErrorInvalidValue);
  // rows of a multiple of 8 elements in 16-byte aligned pools: every lane's
  // piece starts on its load's size (32, 16, 8 or 4 bytes)
  const auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = Dh % EPL == 0 && a16(kp) && a16(vp);
  Args a{B, H, KV, Dh, bs, MB, window, H / KV, 1, eps, scale, vec ? 1 : 0};
  if (q_bf16)
    return launch_pools<__nv_bfloat16>(q, kp, vp, ks, vs, bt, lengths, out, a, splits, pool_kind, s);
  return launch_pools<float>(q, kp, vp, ks, vs, bt, lengths, out, a, splits, pool_kind, s);
}
