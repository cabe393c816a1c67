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
// deq is exactly q * s, s being a power of two).
// with gs = 2^(min(t, T) - d) and s = 2^d given per column.  The caller
// computes gs and s with the plain version's own torch expression
// (`core.a2q._effective_gs`): CUDA's exp2f, torch.exp2 and jnp.exp2 differ in
// the last bits, so exponentials are kept out of the kernel.  The multiply
// and the division are rounded once each in that order (__fmul_rn,
// __fdiv_rn: IEEE, never a reciprocal), as the plain version computes
// `gs * v / l1`.  The l1 sum is the plain version's own fp32 sum, in its
// order (`core.a2q.pairwise_sum`): a perfect binary tree over the rows
// zero-padded to a power of two, one rounded fp32 add a node, so l1 and
// every code equal the plain version's bit for bit on any device (an fp64
// sum, rounded once, lay a few fp32 ulps from torch.sum's and moved 84
// codes of the 1,525 matrices a full chip_smoke.py run deploys on an H100,
// each one apart at a near-integer).  Rounding toward zero keeps every column's
// sum |q| <= gs <= the A2Q budget.
//
// What bounds it on the H100: bytes.  Each element is read twice (the l1
// norm needs all of K before any code is final; the second read mostly hits
// L2 for the narrow strips) and written as 1 + 4 bytes; a few operations an
// element.  The bound counts v read once: 9 bytes an element at 3.35 TB/s
// with deq, 5 without.
//
// Design (simple first): the TPU kernel's sequential (C/bc, 2, K/bk) grid
// carries the l1 norm in VMEM from phase 0 to phase 1.  Here one block of
// 256 threads owns a strip of 32 columns (coalesced: a warp reads one row's
// 32 contiguous columns, 128 bytes) and loops over K twice inside the block.
// Pass 1: the zero-padded rows (P = max(2^ceil(log2 K), 8)) split into 8
// contiguous chunks of P / 8, one per row group; a thread sums its chunk's
// perfect subtree with a binary-counter stack (rows four at a time as one
// ((a + b) + (c + d)) node; the zero rows past K are skipped, since x + 0 =
// x), and the 8 chunk sums meet as ((p0 + p1) + (p2 + p3)) + ((p4 + p5) +
// (p6 + p7)).  Pass 2 writes q and q * s.  No carry crosses blocks.  Not
// yet done: the second pass from shared memory or registers for short K,
// and more blocks in flight for narrow matrices (C / 32 blocks on 132 SMs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;                // columns per block (one warp's row segment)
constexpr int ROWG = 8;                 // row groups striding K
constexpr int THREADS = COLS * ROWG;

constexpr int MAX_LEVELS = 32;

// The binary-counter stack of one thread's pairwise sum: a node of `level`
// (2^level rows) with index `idx` among that level's nodes of the chunk
// joins its left neighbours while idx is odd.
__device__ __forceinline__ void push(float (&stk)[MAX_LEVELS], float x, int level,
                                     unsigned idx) {
  while (idx & 1u) {
    x = stk[level] + x;
    ++level;
    idx >>= 1;
  }
  stk[level] = x;
}

__global__ void __launch_bounds__(THREADS)
a2q_quantize_kernel(const float* __restrict__ v, const float* __restrict__ gs,
                    const float* __restrict__ s, int K, int C, float n, float p,
                    float* __restrict__ deq, int8_t* __restrict__ q,
                    float* __restrict__ l1_out) {
  __shared__ float part[ROWG][COLS];
  __shared__ float l1s[COLS];
  const int tc = threadIdx.x % COLS;
  const int rg = threadIdx.x / COLS;
  const int c = blockIdx.x * COLS + tc;
  const bool live = c < C;
  const size_t ld = static_cast<size_t>(C);

  // this row group's chunk of the zero-padded rows: [k0, k0 + S)
  long long padded = ROWG;
  while (padded < K) padded *= 2;
  const long long S = padded / ROWG;
  const long long k0 = rg * S;
  const long long k1 = min(k0 + S, static_cast<long long>(K));
  float x = 0.0f;
  if (live && k0 < k1) {
    const float* col = v + c;
    float stk[MAX_LEVELS];
    long long k = k0;
    if (S >= 4) {  // chunk starts are multiples of 4: whole quads first
      for (; k + 3 < k1; k += 4) {
        const float a = fabsf(__ldg(col + k * ld));
        const float b = fabsf(__ldg(col + (k + 1) * ld));
        const float cc = fabsf(__ldg(col + (k + 2) * ld));
        const float d = fabsf(__ldg(col + (k + 3) * ld));
        push(stk, (a + b) + (cc + d), 2, static_cast<unsigned>((k - k0) >> 2));
      }
    }
    for (; k < k1; ++k) push(stk, fabsf(__ldg(col + k * ld)), 0, static_cast<unsigned>(k - k0));
    // the pending nodes (the set bits of the row count) close from the
    // lowest level up, as the zero rows past K would close them
    const unsigned count = static_cast<unsigned>(k1 - k0);
    for (int level = 0; level < MAX_LEVELS; ++level)
      if ((count >> level) & 1u) x = stk[level] + x;
  }
  part[rg][tc] = x;
  __syncthreads();
  if (rg == 0) {
    const float sum = ((part[0][tc] + part[1][tc]) + (part[2][tc] + part[3][tc])) +
                      ((part[4][tc] + part[5][tc]) + (part[6][tc] + part[7][tc]));
    const float t = fmaxf(sum, 1e-12f);
    l1s[tc] = t;
    if (live) l1_out[c] = t;
  }
  __syncthreads();
  if (!live) return;

  const float l1 = l1s[tc];
  const float g = gs[c];
  const float sc = s[c];
#pragma unroll 4
  for (int k = rg; k < K; k += ROWG) {
    const size_t o = k * ld + c;
    const float r = __fdiv_rn(__fmul_rn(g, __ldg(v + o)), l1);
    const float code = fminf(fmaxf(truncf(r), n), p);
    q[o] = static_cast<int8_t>(static_cast<int>(code));
    if (deq != nullptr) deq[o] = __fmul_rn(code, sc);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Shapes,
// dtypes and contiguity are validated by the Python wrapper: v (K, C) fp32,
// gs and s (C,) fp32, deq (K, C) fp32 or null, q (K, C) int8, l1 (C,) fp32, and
// -128 <= n <= p <= 127.
extern "C" int a2q_quantize_launch(const void* v, const void* gs, const void* s, int K, int C,
                                   int n, int p, void* deq, void* q, void* l1, void* stream) {
  const dim3 grid((C + COLS - 1) / COLS);
  a2q_quantize_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(gs), static_cast<const float*>(s),
      K, C, static_cast<float>(n), static_cast<float>(p), static_cast<float*>(deq),
      static_cast<int8_t*>(q), static_cast<float*>(l1));
  return static_cast<int>(cudaGetLastError());
}
