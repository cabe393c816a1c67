// Fused A2Q weight quantizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `a2q_quantize_kernel` / `a2q_quantize_pallas`
// (repro/kernels/a2q_quantize.py).  For an fp32 weight v (K, C) row-major
// (each output channel a column) it computes, per column c:
//
//   l1[c]     = max(sum_k |v[k, c]|, 1e-12)
//   q[k, c]   = clip(trunc(gs[c] * v[k, c] / l1[c]), n, p)      int8
//   deq[k, c] = q[k, c] * s[c]                                  fp32
//
// deq is written only when the caller passes it (a deploy keeps q and s;
// deq is exactly q * s, s being a power of two), with gs = 2^(min(t, T) - d)
// and s = 2^d given per column.  The caller computes gs and s with the plain
// version's own torch expression (`core.a2q._effective_gs`): CUDA's exp2f,
// torch.exp2 and jnp.exp2 differ in the last bits, so exponentials are kept
// out of the kernel.  gs * v is rounded once (__fmul_rn) and divided by l1
// as IEEE does (the quotient's trunc, see pass 2).  The l1 sum is the plain
// version's own fp32 sum, in its order (`core.a2q.pairwise_sum`): a perfect
// binary tree over the rows zero-padded to a power of two, one rounded fp32
// add a node, so l1 and every code equal the plain version's bit for bit on
// any device.  Rounding toward zero keeps every column's sum |q| <= gs <= the
// A2Q budget.
//
// What bounds it on the H100: bytes.  v is read once from device memory and
// q written once: 5 bytes an element at 3.35 TB/s (9 with deq), a few
// operations an element.  Every model the port serves is deployed through
// it at start-up (1,525 matrices in one chip_smoke.py run, 768 of them
// deepseek-v3's 7168 x 2048 / 2048 x 7168 experts).
//
// Design: the l1 norm needs all of K before any code is final, and a strip
// of columns read by one block left most SMs idle (C / 32 blocks) with few
// bytes in flight.  Here each strip's rows are split across the G blocks of
// a thread-block cluster, and the block keeps its rows of v in shared memory
// for the second pass, so v crosses from device memory once.
//   * Grid (C / W strips, G splits), cluster (1, G): W in {8, 16, 32}
//     columns (a row segment of 32-128 contiguous bytes, 16-byte loads of 4
//     neighbouring columns), G in 1..8; `a2q_split` in
//     kernels/a2q_quantize.py picks W, G and the chunk S from (K, C) and the
//     SM count.
//   * The rows are cut into chunks of S rows (S a power of two >= 8); chunk
//     i covers rows [i S, i S + S), a perfect subtree of the pairwise tree,
//     and block g of a strip takes chunks [g cpb, g cpb + cpb), cpb a power
//     of two: its rows are one perfect subtree too.  Thread (slot, quad)
//     sums chunk slot's rows of its 4 columns, a 16-byte load a row (16 rows
//     in flight), each 8 rows one ((a + b) + (c + d)) + ((e + f) + (g + h))
//     node, the nodes joined by a binary-counter stack (rows past K are
//     zeros, which an fp32 add leaves exact).  With `resident`, each loaded
//     row is also kept in shared memory ([slot][S + 1 rows][W], one pad row a
//     chunk keeps the stores free of bank conflicts).
//   * The cpb chunk sums join in shared memory in the tree's order; after a
//     cluster barrier every block reads the G blocks' subtree sums through
//     distributed shared memory and joins them (padded with zeros to 8), so
//     l1 is the same float the plain version sums.  A second barrier keeps
//     each block's sum alive until every block has read it.  No workspace,
//     atomics or state between calls (a CUDA graph replays a launch as it
//     is).
//   * Pass 2 quantizes the block's rows from shared memory (from device
//     memory again when the rows do not fit, `resident` = 0), 4 codes a
//     4-byte store.  The quotient (gs v) / l1 is the IEEE one, from 1 / l1
//     and two fmas (codes4).
// Not yet done: one launch over a whole stack of equal matrices (a layer's
// 256 experts), TMA loads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PIECE = 8;        // rows a thread loads at once (one tree node)
constexpr int MAX_LEVELS = 24;  // stack levels: 2^24 nodes a thread
constexpr int MAX_SPLITS = 8;   // a strip's blocks are one cluster (portable size)
constexpr int MAX_W = 32;

struct Args {
  int K, C;
  int W, G, S;       // strip columns, splits (cluster size), chunk rows
  int qlog, slog;    // log2(W / 4), log2(S)
  int cpb, nch;      // chunks a block, chunks a strip
  int resident, vec; // rows kept in shared memory; 16-byte loads and 4-byte code stores
  float n, p;
};

__device__ __forceinline__ float4 abs4(float4 a) {
  return make_float4(fabsf(a.x), fabsf(a.y), fabsf(a.z), fabsf(a.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The binary-counter stack of a pairwise sum over 4 columns: the node of
// index `idx` among its level's nodes joins its left neighbours while idx
// is odd; `close` joins the pending nodes (the set bits of the node count)
// from the lowest level up, as zero nodes past the count would join them.
__device__ __forceinline__ void push(float4 (&stk)[MAX_LEVELS], float4 x, unsigned idx) {
  int level = 0;
  while (idx & 1u) {
    x = add4(stk[level], x);
    ++level;
    idx >>= 1;
  }
  stk[level] = x;
}

__device__ __forceinline__ float4 close(const float4 (&stk)[MAX_LEVELS], unsigned count) {
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int level = 0; level < MAX_LEVELS; ++level)
    if ((count >> level) & 1u) x = add4(stk[level], x);
  return x;
}

// Columns c .. c + 3 of row `row` (zeros past C).
__device__ __forceinline__ float4 load4(const float* __restrict__ v, long long row, int c,
                                        const Args& a) {
  const float* p = v + row * a.C + c;
  if (a.vec) return __ldg(reinterpret_cast<const float4*>(p));
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = c + j < a.C ? __ldg(p + j) : 0.0f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// trunc(x / l1) clipped for 4 values, the IEEE quotient computed without a
// division: q = x * (1 / l1), rounded, lies within an ulp of x / l1, the
// residual x - l1 q is exact under an fma, and one more fma rounds the
// quotient correctly (Markstein's correction, given 1 / l1 correctly
// rounded).  Branch-free: a division, or a branch to one, an element made
// the second pass 2-4x slower on an H100.
__device__ __forceinline__ void codes4(float (&x)[4], const float* l1, const float* inv, float n,
                                       float p) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float q = __fmul_rn(x[e], inv[e]);
    x[e] = fminf(fmaxf(truncf(__fmaf_rn(__fmaf_rn(-l1[e], q, x[e]), inv[e], q)), n), p);
  }
}

__global__ void __launch_bounds__(THREADS)
a2q_quantize_kernel(const float* __restrict__ v, const float* __restrict__ gs,
                    const float* __restrict__ s, float* __restrict__ deq,
                    int8_t* __restrict__ q, float* __restrict__ l1_out, const Args a) {
  extern __shared__ float4 rows_s[];         // resident rows: [cpb][S + 1][W / 4]
  __shared__ float part[THREADS * 4];        // this block's chunk sums: [slot][W]
  __shared__ float l1s[MAX_W], invs[MAX_W], gss[MAX_W], ss[MAX_W];
  namespace cg = cooperative_groups;

  const int Q = a.W / 4;
  const int tid = threadIdx.x;
  const int quad = tid & (Q - 1);
  const int slot = tid >> a.qlog;
  const int col0 = blockIdx.x * a.W;
  const int split = blockIdx.y;
  const int c0 = split * a.cpb;  // this block's first chunk
  const int nslots = max(0, min(a.cpb, a.nch - c0));
  const long long row0 = static_cast<long long>(c0) << a.slog;
  const long long row_end = min(static_cast<long long>(c0 + nslots) << a.slog,
                                static_cast<long long>(a.K));
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // pass 1: chunk `slot`'s sums of |v| for columns col0 + 4 quad .. + 3
  if (slot < nslots) {
    const int c = col0 + 4 * quad;
    const long long r0 = row0 + (static_cast<long long>(slot) << a.slog);
    const long long r1 = min(r0 + a.S, static_cast<long long>(a.K));
    const int npieces = static_cast<int>((r1 - r0 + PIECE - 1) / PIECE);
    float4* keep = rows_s + static_cast<size_t>(slot) * (a.S + 1) * Q + quad;
    float4 stk[MAX_LEVELS];
    for (int pc = 0; pc < npieces; pc += 2) {  // two nodes' 16 loads in flight
      float4 x[2 * PIECE];
#pragma unroll
      for (int i = 0; i < 2 * PIECE; ++i) {
        const long long row = r0 + pc * PIECE + i;
        x[i] = (row < r1 && c < a.C) ? load4(v, row, c, a) : zero4;
      }
      if (a.resident) {
#pragma unroll
        for (int i = 0; i < 2 * PIECE; ++i)
          if (r0 + pc * PIECE + i < r1) keep[(pc * PIECE + i) * Q] = x[i];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (pc + u == npieces) break;
        const float4* y = x + u * PIECE;
        const float4 node =
            add4(add4(add4(abs4(y[0]), abs4(y[1])), add4(abs4(y[2]), abs4(y[3]))),
                 add4(add4(abs4(y[4]), abs4(y[5])), add4(abs4(y[6]), abs4(y[7]))));
        push(stk, node, static_cast<unsigned>(pc + u));
      }
    }
    const float4 sum = close(stk, static_cast<unsigned>(npieces));
    float* dst = part + slot * a.W + 4 * quad;
    dst[0] = sum.x;
    dst[1] = sum.y;
    dst[2] = sum.z;
    dst[3] = sum.w;
  } else if (slot < a.cpb) {  // chunks past the last one are zeros
    float* dst = part + slot * a.W + 4 * quad;
    dst[0] = dst[1] = dst[2] = dst[3] = 0.0f;
  }
  // the block's cpb chunk sums (a perfect subtree) joined in the tree's order
  for (int step = 1; step < a.cpb; step *= 2) {
    __syncthreads();
    for (int i = tid; i < (a.cpb / (2 * step)) * a.W; i += THREADS) {
      const int j = (i / a.W) * 2 * step, cl = i % a.W;
      part[j * a.W + cl] = part[j * a.W + cl] + part[(j + step) * a.W + cl];
    }
  }
  // the G blocks' subtrees (G <= 8, padded with zeros to 8) in the tree's
  // order, through distributed shared memory; every block computes l1
  if (a.G > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  if (tid < a.W) {
    float x[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      x[r] = r >= a.G ? 0.0f : a.G > 1 ? cg::this_cluster().map_shared_rank(part, r)[tid] : part[tid];
    const float sum = ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
    const float t = fmaxf(sum, 1e-12f);
    const int c = col0 + tid;
    l1s[tid] = t;
    invs[tid] = __frcp_rn(t);
    gss[tid] = c < a.C ? gs[c] : 0.0f;
    ss[tid] = c < a.C ? s[c] : 0.0f;
    if (split == 0 && c < a.C) l1_out[c] = t;
  }
  // every block has read every block's sums (and l1s is written)
  if (a.G > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  // pass 2: the block's rows, 4 columns a thread and step
  const long long nq = (row_end - row0) << a.qlog;
  for (long long f = tid; f < nq; f += THREADS) {
    const int qd = static_cast<int>(f & (Q - 1));
    const long long lr = f >> a.qlog;
    const int c = col0 + 4 * qd;
    if (c >= a.C) continue;
    const long long row = row0 + lr;
    float4 x4;
    if (a.resident) {
      const long long sl = lr >> a.slog;
      x4 = rows_s[((sl * (a.S + 1)) + (lr & (a.S - 1))) * Q + qd];
    } else {
      x4 = load4(v, row, c, a);
    }
    const int k = 4 * qd;
    float code[4] = {__fmul_rn(gss[k], x4.x), __fmul_rn(gss[k + 1], x4.y),
                     __fmul_rn(gss[k + 2], x4.z), __fmul_rn(gss[k + 3], x4.w)};
    codes4(code, l1s + k, invs + k, a.n, a.p);
    const size_t o = static_cast<size_t>(row) * a.C + c;
    if (a.vec) {
      const unsigned packed = (static_cast<unsigned>(static_cast<int>(code[0])) & 0xffu) |
                              ((static_cast<unsigned>(static_cast<int>(code[1])) & 0xffu) << 8) |
                              ((static_cast<unsigned>(static_cast<int>(code[2])) & 0xffu) << 16) |
                              (static_cast<unsigned>(static_cast<int>(code[3])) << 24);
      *reinterpret_cast<unsigned*>(q + o) = packed;
      if (deq != nullptr)
        *reinterpret_cast<float4*>(deq + o) =
            make_float4(__fmul_rn(code[0], ss[4 * qd]), __fmul_rn(code[1], ss[4 * qd + 1]),
                        __fmul_rn(code[2], ss[4 * qd + 2]), __fmul_rn(code[3], ss[4 * qd + 3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e >= a.C) break;
        q[o + e] = static_cast<int8_t>(static_cast<int>(code[e]));
        if (deq != nullptr) deq[o + e] = __fmul_rn(code[e], ss[4 * qd + e]);
      }
    }
  }
}

int ilog2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 on success).  Shapes,
// dtypes and contiguity are validated by the Python wrapper: v (K, C) fp32,
// gs and s (C,) fp32, deq (K, C) fp32 or null, q (K, C) int8, l1 (C,) fp32, and
// -128 <= n <= p <= 127.  `strip` (8, 16 or 32 columns), `splits` (1 to 8
// blocks a strip, one cluster), `chunk` (rows a chunk, a power of two >= 8)
// and `resident` (keep the block's rows in shared memory) come from
// `a2q_split`; they change the speed, never the result.  A block takes cpb
// chunks, the least power of two with cpb * splits >= ceil(K / chunk); the
// launch is refused unless cpb <= 1024 / strip and the last block holds a
// chunk.
extern "C" int a2q_quantize_launch(const void* v, const void* gs, const void* s, int K, int C,
                                   int n, int p, void* deq, void* q, void* l1, void* stream,
                                   int strip, int splits, int chunk, int resident) {
  if (K < 1 || C < 1 || (strip != 8 && strip != 16 && strip != 32) || splits < 1 ||
      splits > MAX_SPLITS || chunk < 8 || (chunk & (chunk - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.K = K;
  a.C = C;
  a.W = strip;
  a.G = splits;
  a.S = chunk;
  a.qlog = ilog2(strip / 4);
  a.slog = ilog2(chunk);
  a.nch = static_cast<int>((static_cast<long long>(K) + chunk - 1) / chunk);
  a.cpb = 1;  // a power of two: each block's chunks are one perfect subtree
  while (a.cpb * splits < a.nch) a.cpb *= 2;
  if (a.cpb > THREADS * 4 / strip || (a.nch + a.cpb - 1) / a.cpb != splits ||
      static_cast<long long>(K) > (1LL << MAX_LEVELS) * PIECE)
    return static_cast<int>(cudaErrorInvalidValue);
  a.resident = resident ? 1 : 0;
  const auto aligned = [](const void* ptr, uintptr_t m) {
    return (reinterpret_cast<uintptr_t>(ptr) & (m - 1)) == 0;
  };
  a.vec = C % 4 == 0 && aligned(v, 16) && aligned(q, 4) && (deq == nullptr || aligned(deq, 16));
  a.n = static_cast<float>(n);
  a.p = static_cast<float>(p);
  const size_t smem =
      resident ? sizeof(float) * static_cast<size_t>(min(a.cpb, a.nch)) * (chunk + 1) * strip : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        a2q_quantize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + strip - 1) / strip, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = splits;  // a strip's splits
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, a2q_quantize_kernel, static_cast<const float*>(v), static_cast<const float*>(gs),
      static_cast<const float*>(s), static_cast<float*>(deq), static_cast<int8_t*>(q),
      static_cast<float*>(l1), a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
