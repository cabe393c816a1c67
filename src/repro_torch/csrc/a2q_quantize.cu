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
// the last bits, so exponentials are kept out of the kernel and a code
// depends only on the l1 sum.  The multiply and the division are rounded
// once each in that order (__fmul_rn, __fdiv_rn: IEEE, never a reciprocal),
// as the plain version computes `gs * v / l1`.  The l1 sum is accumulated
// in fp64 and rounded once, so it lies within an fp32 ulp of the exact sum;
// torch.sum's fp32 sum lies a few ulps from it, and a code can differ by one
// from the plain version's where gs * v / l1 lies that close to an integer.
// Rounding toward zero keeps every column's sum |q| <= gs <= the A2Q budget,
// whatever the sum.
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
// 32 contiguous columns, 128 bytes) and loops over K twice inside the block,
// 8 row groups striding K: pass 1 sums |v| per thread in fp64 (four partial
// sums in flight), the 8 row groups' partials are added in shared memory in
// a fixed order; pass 2 writes q and q * s.  No carry crosses blocks.  Not
// yet done: the second pass from shared memory or registers for short K,
// and more blocks in flight for narrow matrices (C / 32 blocks on 132 SMs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;                // columns per block (one warp's row segment)
constexpr int ROWG = 8;                 // row groups striding K
constexpr int THREADS = COLS * ROWG;

__global__ void __launch_bounds__(THREADS)
a2q_quantize_kernel(const float* __restrict__ v, const float* __restrict__ gs,
                    const float* __restrict__ s, int K, int C, float n, float p,
                    float* __restrict__ deq, int8_t* __restrict__ q,
                    float* __restrict__ l1_out) {
  __shared__ double part[ROWG][COLS];
  __shared__ float l1s[COLS];
  const int tc = threadIdx.x % COLS;
  const int rg = threadIdx.x / COLS;
  const int c = blockIdx.x * COLS + tc;
  const bool live = c < C;
  const size_t ld = static_cast<size_t>(C);

  double acc = 0.0;
  if (live) {
    const float* col = v + c;
    double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
    int k = rg;
    for (; k + 3 * ROWG < K; k += 4 * ROWG) {  // four loads in flight a thread
      a0 += fabsf(__ldg(col + k * ld));
      a1 += fabsf(__ldg(col + (k + ROWG) * ld));
      a2 += fabsf(__ldg(col + (k + 2 * ROWG) * ld));
      a3 += fabsf(__ldg(col + (k + 3 * ROWG) * ld));
    }
    for (; k < K; k += ROWG) a0 += fabsf(__ldg(col + k * ld));
    acc = (a0 + a1) + (a2 + a3);
  }
  part[rg][tc] = acc;
  __syncthreads();
  if (rg == 0) {
    double sum = 0.0;
#pragma unroll
    for (int r = 0; r < ROWG; ++r) sum += part[r][tc];
    const float t = fmaxf(static_cast<float>(sum), 1e-12f);
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
