"""Time the decode kernels of one source tree on a CUDA card: ``int_matmul``
at the decoders' few-row shapes and ``paged_attention`` at the smoke shape
and at a served 2048-token context, each held to its plain version first.

    python3 tools/time_decode_kernels.py [--src DIR] [--tag NAME]

``--src`` is the ``src`` directory of the tree to time (default: this
checkout's), so two commits can be timed in one process-per-tree call on one
card: unpack the other commit with ``git archive`` under ``build/`` and run
the script once on each tree, in turns.  Only the wrappers' public
arguments are used, which every version of the port shares.  Prints one
line per shape and, last, a JSON object of every time under ``--tag``.

Times: CUDA graphs of back-to-back calls timed with CUDA events.  Weights
and pools rotate over enough copies that the calls stream them from HBM
(more than the 50 MB L2), as a model whose layers each hold their own do.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6


def graph_ms(fn, reps: int) -> float:
    fn()
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


def copies_for(n_bytes: int) -> int:
    """Copies of an operand that together exceed the L2 (at least 2)."""
    return max(2, int(2 * L2_BYTES // max(n_bytes, 1)) + 1)


def a2q_weights(gen, K, N, dev):
    w = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int32)
    w = w * (torch.rand((K, N), generator=gen, device=dev) < 24.0 / K)
    l1 = w.abs().sum(0, keepdim=True).clamp_min(1)
    return torch.trunc(w.float() * torch.clamp(255.0 / l1, max=1.0)).to(torch.int8)


# (site, K, N, x kind): the decoders' linears at decode; "pro" is fp32 x
# through the prologue, "req" the prologue + relu^2 requant (rwkv6 cm.wk)
SMOLLM = [("smollm wq/wo", 576, 576, 2), ("smollm wk/wv", 576, 192, 2),
          ("smollm w_in/w_gate", 576, 1536, 2), ("smollm w_out", 1536, 576, 1)]
SHAPES = [("rwkv6 tm 4096x4096", 4096, 4096, "pro"), ("rwkv6 cm.wk", 4096, 14336, "req"),
          ("deepseek w_out", 18432, 7168, "pro"), ("deepseek head", 7168, 129280, "int8")]


def time_int_matmul(dev, rows) -> dict:
    from repro_torch.kernels.int_matmul import int_matmul_cuda, int_matmul_plain
    from repro_torch.kernels.ops import int_matmul_block_k

    gen = torch.Generator(device=dev).manual_seed(21)
    s_aq = torch.tensor([6.0 / 127], device=dev)
    pro = dict(aq_scale=s_aq, q_lo=-128, q_hi=127, q_shift=0)
    out = {}
    for M in rows:
        layer = {"int8": 0.0, "pro": 0.0, "bytes": 0}
        for site, K, N, count in SMOLLM:
            ws = [a2q_weights(gen, K, N, dev) for _ in range(30)]
            scale = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
            kw = dict(acc_bits=16, mode="exact", block_k=int_matmul_block_k(K), spill_int16=True)
            x8 = torch.randint(-128, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
            xf = torch.randn((M, K), generator=gen, device=dev) * 3
            for name, x, extra in (("int8", x8, {}), ("pro", xf, pro)):
                got = int_matmul_cuda(x, ws[0], scale, **kw, **extra)
                torch.cuda.synchronize()
                if not torch.equal(got, int_matmul_plain(x, ws[0], scale, **kw, **extra)):
                    raise AssertionError(f"int_matmul {site} {name} M={M}: kernel != plain")
                it = iter(range(10**9))
                layer[name] += count * graph_ms(
                    lambda: int_matmul_cuda(x, ws[next(it) % 30], scale, **kw, **extra), 30)
            layer["bytes"] += count * K * N
            del ws
        out[f"smollm layer 7 calls M={M}"] = {
            "int8_ms": layer["int8"], "prologue_ms": layer["pro"],
            "bound_ms": layer["bytes"] / HBM_BYTES_PER_S * 1e3}
        print(f"int_matmul smollm layer's 7 calls M={M}: int8 x {layer['int8']:.5f} ms, "
              f"prologue {layer['pro']:.5f} ms", flush=True)
        for site, K, N, kind in SHAPES:
            n = copies_for(K * N)
            ws = [a2q_weights(gen, K, N, dev) for _ in range(n)]
            scale = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
            kw = dict(acc_bits=16, mode="exact", block_k=int_matmul_block_k(K), spill_int16=True)
            if kind == "int8":
                x = torch.randint(-128, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
            else:
                x = torch.randn((M, K), generator=gen, device=dev) * 3
                kw.update(pro)
            if kind == "req":
                y = int_matmul_plain(x, ws[0], scale, **kw)
                kw.update(out_scale=torch.full((N,), (y.clamp_min(0) ** 2).max().item() / 200,
                                               device=dev),
                          r_lo=0, r_hi=255, r_shift=128, act_fn="relu2",
                          cast_dtype=torch.bfloat16)
            got = int_matmul_cuda(x, ws[0], scale, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, int_matmul_plain(x, ws[0], scale, **kw)):
                raise AssertionError(f"int_matmul {site} M={M}: kernel != plain")
            it = iter(range(10**9))
            ms = graph_ms(lambda: int_matmul_cuda(x, ws[next(it) % n], scale, **kw), 2 * n)
            b_ms = (K * N + x.element_size() * M * K + 8 * N + 4 * M * N) / HBM_BYTES_PER_S * 1e3
            out[f"{site} M={M} K={K} N={N}"] = {"ms": ms, "bound_ms": b_ms}
            print(f"int_matmul {site} ({kind}) M={M} K={K} N={N}: {ms:.5f} ms, bound "
                  f"{b_ms:.5f} ms ({b_ms / ms:.1%})", flush=True)
            del ws
    return out


def paged_inputs(dev, B, MB, lengths, copies, seed, H=9, KV=3, Dh=64, bs=16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    NB = B * MB + 1
    perm = torch.randperm(NB - 1, generator=gen, device=dev).to(torch.int32) + 1
    bt = perm[: B * MB].reshape(B, MB).clone()
    used = (lengths[:, None] + bs - 1) // bs
    bt[torch.arange(MB, device=dev)[None, :] >= used] = 0
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(torch.bfloat16)
    pools = [(torch.randn((NB, bs, KV, Dh), generator=gen, device=dev),
              torch.randn((NB, bs, KV, Dh), generator=gen, device=dev)) for _ in range(copies)]
    return q, pools, bt


def time_paged_attention(dev) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain
    from repro_torch.nn.attention import _kv_quantize, _pack_nibbles

    out = {}
    smoke = torch.tensor([0, 1, 17, 33, 64, 65, 80, 96], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    served = torch.randint(1536, 2049, (32,), generator=gen, device=dev, dtype=torch.int32)
    for case, B, MB, lengths, copies in (("smoke", 8, 6, smoke, 1),
                                         ("2048 context", 32, 128, served, 3)):
        q, pools, bt = paged_inputs(dev, B, MB, lengths, copies, seed=23)
        H, Dh, KV = q.shape[1], q.shape[2], pools[0][0].shape[2]
        S = MB * pools[0][0].shape[1]
        toks = int(lengths.sum())
        for kind in ("bf16", "int8", "int4"):
            args = []
            for kp, vp in pools:
                if kind == "bf16":
                    args.append((kp.bfloat16(), vp.bfloat16(), None, None))
                else:
                    bits = 8 if kind == "int8" else 4
                    (kc, ksc), (vc, vsc) = (_kv_quantize(p, bits=bits) for p in (kp, vp))
                    if bits == 4:
                        kc, vc = _pack_nibbles(kc), _pack_nibbles(vc)
                    args.append((kc, vc, ksc, vsc))
            kp0, vp0, ks0, vs0 = args[0]
            got = paged_attention_cuda(q, kp0, vp0, bt, lengths, ks0, vs0)
            torch.cuda.synchronize()
            err = (got.float() - paged_attention_plain(q, kp0, vp0, bt, lengths, ks0, vs0)
                   .float()).abs().max().item()
            if not err <= 2.0**-6:
                raise AssertionError(f"paged_attention {case} {kind}: max err {err}")
            it = iter(range(10**9))

            def call():
                kp, vp, ks, vs = args[next(it) % copies]
                return paged_attention_cuda(q, kp, vp, bt, lengths, ks, vs)

            ms = graph_ms(call, 30)
            # yardstick: SDPA on the (dequantized) gathered bf16 view, the gather not timed
            if kind == "bf16":
                kd, vd = kp0.float(), vp0.float()
            else:
                from repro_torch.nn.attention import _unpack_nibbles
                kd, vd = ((_unpack_nibbles(c) if kind == "int4" else c).float() * s[..., None]
                          for c, s in ((kp0, ks0), (vp0, vs0)))
            G = H // KV
            kg, vg = (d[bt.long()].reshape(B, S, KV, Dh).transpose(1, 2).to(torch.bfloat16)
                      .repeat_interleave(G, dim=1).contiguous() for d in (kd, vd))
            mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
            qs = q[:, :, None, :]
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask),
                              30)
            row_bytes = kp0.shape[-1] * kp0.element_size()
            n_bytes = toks * KV * 2 * (row_bytes + (4 if ks0 is not None else 0))
            b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            out[f"{case} {kind}"] = {"ms": ms, "sdpa_ms": lib_ms, "bound_ms": b_ms,
                                     "max_abs_err": err}
            print(f"paged_attention {case} {kind} B={B} MB={MB} keys={toks}: {ms:.5f} ms, SDPA on "
                  f"the gathered view {lib_ms:.5f} ms, bound {b_ms:.5f} ms ({b_ms / ms:.1%}), "
                  f"max err {err:.3g}", flush=True)
            del args, kg, vg
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--rows", default="1,8,16")
    ap.add_argument("--split-k", type=int, default=None,
                    help="force int_matmul's decode K splits (trees with split_k)")
    ap.add_argument("--split-kv", type=int, default=None,
                    help="force paged_attention's table runs (trees with split_kv)")
    ap.add_argument("--only", choices=("int_matmul", "paged_attention"), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_decode_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{args.tag}: {args.src}; {smi}", flush=True)
    _build.build_all(("int_matmul", "paged_attention"))
    import importlib

    for module, choice, value in (("int_matmul", "split_k", args.split_k),
                                  ("paged_attention", "split_kv", args.split_kv)):
        if value is not None:  # the wrapper's split choice replaced by a constant
            setattr(importlib.import_module(f"repro_torch.kernels.{module}"), choice,
                    lambda *shape, n=value: n)
    rows = [int(r) for r in args.rows.split(",")]
    tiny = torch.zeros(1, device=dev)
    floor_ms = graph_ms(lambda: tiny.add_(1.0), 30)
    print(f"launch floor: a one-element PyTorch add in the same graph timing {floor_ms:.5f} ms",
          flush=True)
    res = {"tag": args.tag, "card": smi, "launch_floor_ms": floor_ms}
    if args.only in (None, "int_matmul"):
        res["int_matmul"] = time_int_matmul(dev, rows)
    if args.only in (None, "paged_attention"):
        res["paged_attention"] = time_paged_attention(dev)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
