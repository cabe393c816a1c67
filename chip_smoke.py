"""Smoke run of the PyTorch port on one CUDA card (an H100 for the numbers in
PERF.md): builds the kernels, holds each against its plain PyTorch version at
the main path's shapes, serves full-width smollm-135m through the paged
engine on the kernels, and checks the result.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build every kernel from ``src/repro_torch/csrc`` (one nvcc per source, in
   parallel) and print the build seconds;
3. hold each kernel against its plain version on the card: ``int_matmul`` at
   M in {1, 8, 64} for the four (K, N) pairs of a smollm-135m layer with the
   int16 carry and the fused scale (A2Q-deployed weights), plus raw int32,
   ``wrap`` and ``saturate`` on full-range weights; ``paged_attention`` at
   B=8, H=9, KV=3, Dh=64, bs=16 with ragged lengths including 0, fp32 and
   bf16 pools.  Times come from CUDA graphs of back-to-back calls timed with
   CUDA events; the int_matmul weights rotate over 30 layer copies so each
   call streams its weights from HBM as the 30-layer model does;
4. serve full-width smollm-135m (30 layers, random A2Q weights from seed 0,
   deployed to int8): 8 requests, prompt 64, 32 new tokens, batch 8, through
   ``PagedServeEngine`` with ``Runtime(int_forward=True, decode_kernel=True)``;
   print prefill and decode tok/s and check that the launch counts show both
   kernels on every decode tick (210 int_matmul and 30 paged_attention);
5. compare the int path with the default ``Runtime()`` (dequant bf16
   matmuls, gathered-view attention) on the same weights: the prompts'
   logits must agree to two bf16 ulps of the largest logit (``eps``), and
   the greedy tokens served on the dequant path must agree with the int
   path's under ``parity_up_to_ties`` at that ``eps``; then a reduced model
   on the card against the same model on the CPU (plain versions), token for
   token and margin for margin;
6. print the ``kernels`` line, then the result line.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
every ported kernel with its launches on the main path, its error against the
plain version, and its time beside the plain version's, a PyTorch library
call's and the card's bound.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores (the paged kernel's fp32 FMAs)

SMOLLM_SITES = {  # (K, N) of the seven linears of one smollm-135m layer -> count
    (576, 576): 2,   # wq, wo
    (576, 192): 2,   # wk, wv
    (576, 1536): 2,  # w_in, w_gate
    (1536, 576): 1,  # w_out
}
LAYERS = 30
# plain vs kernel tolerances: int_matmul is bit-exact; paged attention is fp32
# softmax summed in another order (fp32 pools), plus one bf16 rounding of the
# output (bf16 pools: one ulp at |o| < 2)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0**-6}


def phase(title: str) -> None:
    print(f"== {title}", flush=True)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` (``reps`` back-to-back calls captured
    in one CUDA graph, replayed and timed with CUDA events)."""
    fn()  # warm up outside the capture (lazy library handles, allocator)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def a2q_bounded_weights(gen, K, N, device):
    """int8 (K, N) weights with every column's l1 norm within the A2Q budget
    of P=16, N=8 signed inputs (255.99), as ``deploy_params`` produces them."""
    w = torch.randint(-127, 128, (K, N), generator=gen, device=device, dtype=torch.int32)
    keep = torch.rand((K, N), generator=gen, device=device) < 24.0 / K
    w = w * keep
    l1 = w.abs().sum(0, keepdim=True).clamp_min(1)
    w = torch.trunc(w.float() * torch.clamp(255.0 / l1, max=1.0)).to(torch.int8)
    return w


def check_int_matmul(dev) -> dict:
    from repro_torch.kernels.int_matmul import int_matmul_cuda, int_matmul_plain
    from repro_torch.kernels.ops import int_matmul_block_k

    gen = torch.Generator(device=dev).manual_seed(1)
    per_layer = {M: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0, "ops": 0.0}
                 for M in (1, 8, 64)}
    worst = 0.0
    for (K, N), count in SMOLLM_SITES.items():
        ws = [a2q_bounded_weights(gen, K, N, dev) for _ in range(LAYERS)]
        ws_cm = [w.t().contiguous().t() for w in ws]  # column-major copies for cuBLASLt
        scale = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
        kw = dict(acc_bits=16, mode="exact", block_k=int_matmul_block_k(K), spill_int16=True)
        for M in (1, 8, 64):
            x = torch.randint(-128, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
            got = int_matmul_cuda(x, ws[0], scale, **kw)
            torch.cuda.synchronize()
            want = int_matmul_plain(x, ws[0], scale, **kw)
            err = (got - want).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(f"int_matmul M={M} K={K} N={N}: kernel != plain, max err {err}")
            worst = max(worst, err)
            it = iter(range(10**9))
            ms = graph_ms(lambda: int_matmul_cuda(x, ws[next(it) % LAYERS], scale, **kw), LAYERS)
            it = iter(range(10**9))
            plain_ms = graph_ms(lambda: int_matmul_plain(x, ws[next(it) % LAYERS], scale, **kw), LAYERS)
            lib_ms = None
            if M > 16:  # torch._int_mm's shape rule (and K, N multiples of 8)
                it = iter(range(10**9))
                lib_ms = graph_ms(lambda: torch._int_mm(x, ws_cm[next(it) % LAYERS]), LAYERS)
            n_bytes = M * K + K * N + 4 * N + 4 * M * N
            n_ops = 2 * M * K * N
            b_ms, b_by = bound_ms(n_bytes, n_ops, INT8_OPS_PER_S)
            print(f"int_matmul M={M} K={K} N={N}: max_abs_err {err} kernel_ms {ms:.5f} "
                  f"plain_ms {plain_ms:.5f} bound_ms {b_ms:.6f} ({b_by}) "
                  f"library_ms(_int_mm) {'n/a' if lib_ms is None else f'{lib_ms:.5f}'}", flush=True)
            acc = per_layer[M]
            acc["ms"] += count * ms
            acc["plain_ms"] += count * plain_ms
            acc["bytes"] += count * n_bytes
            acc["ops"] += count * n_ops
    # the other carry modes and the raw int32 output, on full-range weights
    x = torch.randint(-128, 128, (8, 1536), generator=gen, device=dev, dtype=torch.int8)
    w = torch.randint(-128, 128, (1536, 576), generator=gen, device=dev, dtype=torch.int8)
    for kw in (dict(acc_bits=32, mode="exact"), dict(acc_bits=16, mode="wrap", spill_int16=True),
               dict(acc_bits=16, mode="saturate", spill_int16=True),
               dict(acc_bits=12, mode="saturate")):
        got = int_matmul_cuda(x, w, block_k=512, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, int_matmul_plain(x, w, block_k=512, **kw)):
            raise AssertionError(f"int_matmul {kw}: kernel != plain")
        print(f"int_matmul raw int32 {kw}: equal", flush=True)
    for M, acc in per_layer.items():
        acc["bound_ms"], acc["bound_by"] = bound_ms(acc["bytes"], acc["ops"], INT8_OPS_PER_S)
        print(f"int_matmul one layer's 7 calls at M={M}: kernel_ms {acc['ms']:.5f} "
              f"plain_ms {acc['plain_ms']:.5f} bound_ms {acc['bound_ms']:.6f} ({acc['bound_by']})",
              flush=True)
    dec = per_layer[8]
    return {"name": "int_matmul", "route": "cuda", "source": "src/repro_torch/csrc/int_matmul.cu",
            "replaces": "src/repro/kernels/int_matmul.py:300",
            "at": "one smollm-135m layer's 7 decode calls, M=8, int16 carry, fused scale",
            "max_abs_err": worst, "ms": dec["ms"], "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"], "library_ms": None}


def paged_case(dev, dtype, B=8, H=9, KV=3, Dh=64, bs=16, max_seq=96):
    gen = torch.Generator(device=dev).manual_seed(2)
    MB = max_seq // bs
    NB = B * MB + 1
    lengths = torch.tensor([0, 1, 17, 33, 64, 65, 80, 96], dtype=torch.int32, device=dev)[:B]
    perm = torch.randperm(NB - 1, generator=gen, device=dev).to(torch.int32) + 1
    bt = perm[: B * MB].reshape(B, MB).clone()
    used = (lengths[:, None] + bs - 1) // bs
    bt[torch.arange(MB, device=dev)[None, :] >= used] = 0  # entries past the length: trash
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((NB, bs, KV, Dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((NB, bs, KV, Dh), generator=gen, device=dev).to(dtype)
    return q, kp, vp, bt, lengths


def check_paged_attention(dev) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain

    entry = None
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, bt, lengths = paged_case(dev, dtype)
        B, H, Dh = q.shape
        KV = kp.shape[2]
        worst = 0.0
        for window in (None, 20):
            got = paged_attention_cuda(q, kp, vp, bt, lengths, window=window)
            torch.cuda.synchronize()
            want = paged_attention_plain(q, kp, vp, bt, lengths, window=window)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= ATTN_TOL[dtype]:
                raise AssertionError(f"paged_attention {dtype} window={window}: max err {err}")
            if not torch.isfinite(got).all() or got[0].abs().max().item() != 0.0:
                raise AssertionError("paged_attention: non-finite output or nonzero empty row")
            worst = max(worst, err)
        ms = graph_ms(lambda: paged_attention_cuda(q, kp, vp, bt, lengths), LAYERS)
        plain_ms = graph_ms(lambda: paged_attention_plain(q, kp, vp, bt, lengths), LAYERS)
        # yardstick: SDPA on the already-gathered view (the gather not timed)
        S = bt.shape[1] * kp.shape[1]
        kg = kp[bt.long()].reshape(B, S, KV, Dh).transpose(1, 2).contiguous()
        vg = vp[bt.long()].reshape(B, S, KV, Dh).transpose(1, 2).contiguous()
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        qs = q[:, :, None, :]
        G = H // KV  # heads h*G..h*G+G-1 share KV head h
        kg, vg = kg.repeat_interleave(G, dim=1), vg.repeat_interleave(G, dim=1)
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask), LAYERS)
        esize = kp.element_size()
        toks = lengths.sum().item()
        n_bytes = (q.numel() * q.element_size() * 2 + toks * KV * Dh * 2 * esize
                   + bt.numel() * 4 + B * 4)
        n_ops = 4 * toks * (H // KV) * KV * Dh  # QK^T and PV multiply-adds, 2 flops each
        b_ms, b_by = bound_ms(n_bytes, n_ops, FP32_FLOPS_PER_S)
        print(f"paged_attention {str(dtype).replace('torch.', '')} B={B} H={H} KV={KV} Dh={Dh} "
              f"bs={kp.shape[1]} lengths={lengths.tolist()}: max_abs_err {worst:.3g} "
              f"kernel_ms {ms:.5f} plain_ms {plain_ms:.5f} bound_ms {b_ms:.6f} ({b_by}) "
              f"library_ms(sdpa, gathered) {lib_ms:.5f}", flush=True)
        if dtype == torch.bfloat16:  # the main path's pools
            entry = {"name": "paged_attention", "route": "cuda",
                     "source": "src/repro_torch/csrc/paged_attention.cu",
                     "replaces": "src/repro/kernels/paged_attention.py:212",
                     "at": "B=8 H=9 KV=3 Dh=64 bs=16 bf16 pools, ragged lengths incl. 0",
                     "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms}
    return entry


def serve(dev):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.int_matmul import int_matmul_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.lm import Runtime, apply_lm, init_lm
    from repro_torch.nn.module import tree_to
    from repro_torch.serve.engine import PagedServeEngine, deploy_params, parity_up_to_ties

    phase("4: serve full-width smollm-135m on the kernels")
    arch = get_arch("smollm-135m")
    t0 = time.perf_counter()
    params = deploy_params(init_lm(torch.Generator(device=dev).manual_seed(0), arch, device=dev),
                           arch.quant)
    torch.cuda.synchronize()
    print(f"init + deploy of {arch.name} ({arch.n_layers} layers, d_model {arch.d_model}): "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab, (64,)).astype(np.int32) for _ in range(8)]
    kw = dict(batch=8, max_seq=96, block_size=16, prefill_chunk=32, device=dev)
    engine = PagedServeEngine(arch, params, rt=Runtime(int_forward=True, decode_kernel=True), **kw)
    engine.generate(prompts[:1], max_new=2)  # warm-up: first-call library set-up
    engine.reset_stats()
    torch.cuda.synchronize()
    int_matmul_cuda.launches = 0
    paged_attention_cuda.launches = 0
    outs = engine.generate(prompts, max_new=32)
    torch.cuda.synchronize()
    launches = {"int_matmul": int_matmul_cuda.launches,
                "paged_attention": paged_attention_cuda.launches}
    tp = engine.throughput()
    ticks = tp["decode_dispatches"]
    chunks = sum(-(-len(p) // 32) for p in prompts)
    print(f"prefill: {tp['prefill_tokens']} tok in {tp['prefill_s']:.3f}s "
          f"({tp['prefill_tok_s']:.1f} tok/s) | decode: {tp['decode_tokens']} tok in "
          f"{tp['decode_s']:.3f}s ({tp['decode_tok_s']:.1f} tok/s, {ticks} ticks)", flush=True)
    print(f"launches on the main path: {launches} over {ticks} decode ticks and "
          f"{chunks} prefill chunks", flush=True)
    per_forward = 7 * arch.n_layers
    if launches["int_matmul"] != per_forward * (ticks + chunks) or \
            launches["paged_attention"] != arch.n_layers * ticks or ticks < 31:
        raise AssertionError(f"launch counts {launches} do not show {per_forward} int_matmul "
                             f"and {arch.n_layers} paged_attention per decode tick")
    for r, o in zip(engine.last_requests, outs):
        if len(o) != 32 or not all(0 <= t < arch.vocab for t in o) or \
                not np.isfinite(r.margins).all():
            raise AssertionError(f"bad output: {o} margins {r.margins}")
    print(f"req 0 tokens: {outs[0]}", flush=True)

    phase("5: same weights and prompts on the dequant bf16 path; reduced model card vs CPU")
    toks = torch.as_tensor(np.stack(prompts), device=dev)
    l_int = apply_lm(params, arch, tokens=toks, rt=Runtime(int_forward=True))[0].float()
    l_deq = apply_lm(params, arch, tokens=toks)[0].float()
    scale = l_deq.abs().max().item()
    diff = (l_int - l_deq).abs().max().item()
    eps = 2.0**-6 * scale  # two bf16 ulps at the top of the logit range
    print(f"prompt logits, int path vs dequant path: max |diff| {diff:.4g}, max |logit| "
          f"{scale:.4g}, bound {eps:.4g}; argmax agreement "
          f"{(l_int.argmax(-1) == l_deq.argmax(-1)).float().mean().item():.4f}", flush=True)
    if not (np.isfinite(diff) and diff <= eps):
        raise AssertionError(f"int path logits off the dequant path by {diff} > {eps}")
    ref = PagedServeEngine(arch, params, rt=Runtime(), **kw)
    ref.generate(prompts[:1], max_new=2)
    ref.reset_stats()
    ref_outs = ref.generate(prompts, max_new=32)
    rtp = ref.throughput()
    print(f"dequant path: prefill {rtp['prefill_tok_s']:.1f} tok/s | decode "
          f"{rtp['decode_tok_s']:.1f} tok/s ({rtp['decode_dispatches']} ticks)", flush=True)
    ok, ties, detail = parity_up_to_ties(ref.last_requests, outs, eps)
    same = sum(a == b for a, b in zip(ref_outs, outs))
    marg = max(abs(a - b) for r, g in zip(ref.last_requests, engine.last_requests)
               for a, b in zip(r.margins, g.margins))
    print(f"served tokens, int path vs dequant path: parity_up_to_ties eps={eps:.4g}: ok={ok} "
          f"ties={ties} identical_requests={same}/{len(outs)}; max greedy-margin diff "
          f"{marg:.4g}", flush=True)
    if not ok:
        raise AssertionError(f"parity failed: {detail}")
    small = reduced(arch)
    sp = deploy_params(init_lm(torch.Generator().manual_seed(0), small, device="cpu"), small.quant)
    small_prompts = [p[: 5 + 3 * i] % small.vocab for i, p in enumerate(prompts[:3])]
    skw = dict(batch=2, max_seq=32, block_size=4, prefill_chunk=4,
               rt=Runtime(int_forward=True, decode_kernel=True))
    cpu_e = PagedServeEngine(small, sp, device="cpu", **skw)
    cpu_outs = cpu_e.generate(small_prompts, max_new=5)
    gpu_e = PagedServeEngine(small, tree_to(sp, dev), device=dev, **skw)
    gpu_outs = gpu_e.generate(small_prompts, max_new=5)
    ok, ties, detail = parity_up_to_ties(cpu_e.last_requests, gpu_outs, 1e-4)
    marg = max(abs(a - b) for r, g in zip(cpu_e.last_requests, gpu_e.last_requests)
               for a, b in zip(r.margins, g.margins))
    print(f"reduced smollm-135m card vs CPU: tokens {gpu_outs} vs {cpu_outs}, ties {ties}, "
          f"max margin diff {marg:.3g}", flush=True)
    if not ok or ties or marg > 1e-4:
        raise AssertionError(f"card vs CPU disagree: {detail}, margin diff {marg}")
    return launches


def main() -> int:
    phase("1: device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import resolve_device  # fails outside a checkout of the repo
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")  # also turns TF32 off: fp32 matmuls in full fp32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    phase("2: build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {list(logs)} in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    phase("3: kernels against their plain versions")
    entries = [check_int_matmul(dev), check_paged_attention(dev)]
    launches = serve(dev)
    for e in entries:
        e["launches"] = launches[e["name"]]

    phase("6: result")
    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
