"""Time the decode kernels of one source tree on a CUDA card: ``int_matmul``
at the decoders' few-row shapes, ``paged_attention`` at the smoke shape and
at a served 2048-token context, ``paged_mla_attention`` at the smoke shape
and at DeepSeek-V3's 4K pre-training context, ``a2q_quantize`` at every
matrix shape ``chip_smoke.py`` deploys, and ``rwkv6_scan`` at rwkv6-7b's
decode, prefill and long-prompt shapes (``chip_smoke.py`` phase 3's), each
held to its plain version first.

    python3 tools/time_decode_kernels.py [--src DIR] [--tag NAME] [--only KERNEL]

``--src`` is the ``src`` directory of the tree to time (default: this
checkout's), so two commits can be timed in one process-per-tree call on one
card: unpack the other commit with ``git archive`` under ``build/`` and run
the script once on each tree, in turns.  Only the wrappers' public
arguments are used, which every version of the port shares.  Prints one
line per shape and, last, a JSON object of every time under ``--tag``.

Times: CUDA graphs of back-to-back calls timed with CUDA events.  Weights
and pools rotate over enough copies that the calls stream them from HBM
(more than the 50 MB L2), as a model whose layers each hold their own do
(``a2q_quantize``'s at most ``DEPLOY_COPIES``: the smallest vision matrices
stay in the L2).  ``a2q_quantize``'s line "deploy kernel ms a run" sums
count x ms over the 1,598 matrices of ``DEPLOY_SHAPES``, beside the same
sum of the byte bounds.
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


# (site, K, C, matrices a chip_smoke.py run deploys at that shape): 1,598
# deploys of smollm-135m (210), deepseek-v3 cut to 3 dense + 1 MoE layer
# (801), rwkv6-7b (225), hubert-xlarge (289) and the four vision networks (73)
DEPLOY_SHAPES = [
    ("smollm wq/wo", 576, 576, 60), ("smollm wk/wv", 576, 192, 60),
    ("smollm w_in/w_gate", 576, 1536, 60), ("smollm w_out", 1536, 576, 30),
    ("deepseek expert w_in/w_gate", 7168, 2048, 514), ("deepseek expert w_out", 2048, 7168, 257),
    ("deepseek dense w_in/w_gate", 7168, 18432, 6), ("deepseek dense w_out", 18432, 7168, 3),
    ("deepseek wq_a", 7168, 1536, 4), ("deepseek wq_b", 1536, 24576, 4),
    ("deepseek wkv_a", 7168, 576, 4), ("deepseek wkv_b", 512, 32768, 4),
    ("deepseek wo", 16384, 7168, 4), ("deepseek head", 7168, 129280, 1),
    ("rwkv6 tm 4096x4096", 4096, 4096, 160), ("rwkv6 cm.wk", 4096, 14336, 32),
    ("rwkv6 cm.wv", 14336, 4096, 32), ("rwkv6 head", 4096, 65536, 1),
    ("hubert attn", 1280, 1280, 192), ("hubert w_in", 1280, 5120, 48),
    ("hubert w_out", 5120, 1280, 48), ("hubert head", 1280, 504, 1),
    # the vision networks' conv and linear leaves at full width (chip_smoke.py
    # phase 4i: MobileNetV1 and ResNet18 at width 1.0, ESPCN, UNet at base 32),
    # each HWIO leaf as its (K = kh*kw*c_in/groups, C_out) matrix; site = first user
    ("mobilenetv1 stem", 27, 32, 1), ("mobilenetv1 dw / unet stem", 9, 32, 2),
    ("mobilenetv1 pw", 32, 64, 1), ("mobilenetv1 dw", 9, 64, 1),
    ("mobilenetv1 pw / resnet18 sc", 64, 128, 2), ("mobilenetv1 dw", 9, 128, 2),
    ("mobilenetv1 pw / resnet18 sc", 128, 128, 2), ("mobilenetv1 pw / resnet18 sc", 128, 256, 2),
    ("mobilenetv1 dw", 9, 256, 2), ("mobilenetv1 pw / resnet18 sc", 256, 256, 2),
    ("mobilenetv1 pw / resnet18 sc", 256, 512, 2), ("mobilenetv1 dw", 9, 512, 6),
    ("mobilenetv1 pw / resnet18 sc", 512, 512, 6), ("mobilenetv1 pw", 512, 1024, 1),
    ("mobilenetv1 dw", 9, 1024, 1), ("mobilenetv1 pw", 1024, 1024, 1),
    ("mobilenetv1 head", 1024, 10, 1), ("resnet18 stem", 27, 64, 1),
    ("resnet18 c1/c2 / espcn c2 / unet", 576, 64, 7), ("resnet18 sc", 64, 64, 2),
    ("resnet18 c1 / unet", 576, 128, 2), ("resnet18 c1/c2 / unet", 1152, 128, 8),
    ("resnet18 c1", 1152, 256, 1), ("resnet18 c1/c2", 2304, 256, 3),
    ("resnet18 c1", 2304, 512, 1), ("resnet18 c1/c2", 4608, 512, 3),
    ("resnet18 head", 512, 10, 1), ("espcn c1", 25, 64, 1),
    ("espcn c3 / unet", 576, 32, 2), ("espcn out / unet out", 288, 1, 2),
    ("unet enc c1", 288, 64, 1), ("unet dec c1", 1152, 64, 1), ("unet dec c2 / up", 288, 32, 2),
]
# rotated copies of a deploy shape's operands at most: the smallest matrices
# would need tens of thousands to exceed the L2, and stay in it at this many
DEPLOY_COPIES = 256


def time_a2q_quantize(dev) -> dict:
    """Every deploy shape, codes only as ``deploy_linear`` calls it, on the
    A2Q initializer's (v, t, d) (P=16, 8-bit signed inputs), held to the
    plain quantizer first (l1 and codes equal)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.a2q import _effective_gs
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda, a2q_quantize_plain
    from repro_torch.nn.linear import init_linear

    quant = get_arch("hubert-xlarge").quant
    gen = torch.Generator(device=dev).manual_seed(24)
    out, run_ms, run_bound = {}, 0.0, 0.0
    for site, K, C, count in DEPLOY_SHAPES:
        n = min(copies_for(4 * K * C), DEPLOY_COPIES)
        args = []
        for _ in range(n):
            p = init_linear(gen, K, C, quant)
            gs, s = _effective_gs(p, quant.acc_bits, quant.act_bits, True)
            args.append((p["v"], gs, s))
            del p
        v, gs, s = args[0]
        _, q, l1 = a2q_quantize_cuda(v, gs, s, n=-128, p=127, dequantize=False)
        torch.cuda.synchronize()
        _, q_p, l1_p = a2q_quantize_plain(v, gs, s, n=-128, p=127, dequantize=False)
        if not (torch.equal(q, q_p) and torch.equal(l1, l1_p)):
            raise AssertionError(f"a2q_quantize {site} K={K} C={C}: kernel != plain")
        del q, l1, q_p, l1_p
        it = iter(range(10**9))
        ms = graph_ms(lambda: a2q_quantize_cuda(*args[next(it) % n], n=-128, p=127,
                                                dequantize=False), 2 * n)
        b_ms = (5 * K * C + 12 * C) / HBM_BYTES_PER_S * 1e3
        run_ms += count * ms
        run_bound += count * b_ms
        out[f"{site} K={K} C={C}"] = {"count": count, "ms": ms, "bound_ms": b_ms}
        print(f"a2q_quantize {site} K={K} C={C} (x{count} a run): {ms:.5f} ms, bound "
              f"{b_ms:.5f} ms ({b_ms / ms:.1%})", flush=True)
        del args, v, gs, s
        torch.cuda.empty_cache()
    out["deploy kernel ms a run"] = {"ms": run_ms, "bound_ms": run_bound}
    print(f"a2q_quantize deploy kernel ms a run ({sum(c for *_, c in DEPLOY_SHAPES):,} matrices): "
          f"{run_ms:.3f} ms, bound "
          f"{run_bound:.3f} ms ({run_bound / run_ms:.1%})", flush=True)
    return out


MLA_TOL = 2e-5


def time_paged_mla_attention(dev) -> dict:
    """The absorbed MLA decode at deepseek-v3's widths (H=128, R=512, P=64,
    bs=16) with the act-quant replay at 8 bits, on bf16, int8 and int4
    pools: the smoke shape (B=8, <= 96 keys) and the 4K context DeepSeek-V3
    was pre-trained at (B=8, lengths from the seed in [3072, 4096]); SDPA
    on the (dequantized) gathered view as the library time."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_mla_attention import (
        paged_mla_attention_cuda,
        paged_mla_attention_plain,
    )
    from repro_torch.nn.attention import _kv_quantize, _pack_nibbles, _unpack_nibbles

    H, R, P, bs = 128, 512, 64, 16
    scale = (128 + 64) ** -0.5
    kw = {"aq_scale": torch.tensor([0.02], device=dev), "act_bits": 8}
    gen = torch.Generator(device=dev).manual_seed(25)
    smoke = torch.tensor([0, 1, 17, 33, 64, 65, 80, 96], dtype=torch.int32, device=dev)
    served = torch.randint(3072, 4097, (8,), generator=gen, device=dev, dtype=torch.int32)
    out = {}
    for case, MB, lengths in (("smoke", 6, smoke), ("4K context", 256, served)):
        B = lengths.numel()
        NB = B * MB + 1
        perm = torch.randperm(NB - 1, generator=gen, device=dev).to(torch.int32) + 1
        bt = perm[: B * MB].reshape(B, MB).clone()
        used = (lengths[:, None] + bs - 1) // bs
        bt[torch.arange(MB, device=dev)[None, :] >= used] = 0
        q_lat = torch.randn((B, H, R), generator=gen, device=dev)
        q_pe = torch.randn((B, H, P), generator=gen, device=dev)
        copies = copies_for(NB * bs * (R + P) * 2)
        pools = [(torch.randn((NB, bs, R), generator=gen, device=dev),
                  torch.randn((NB, bs, P), generator=gen, device=dev)) for _ in range(copies)]
        toks = int(lengths.sum())
        S = MB * bs
        for kind in ("bf16", "int8", "int4"):
            args = []
            for ckv, kpe in pools:
                if kind == "bf16":
                    args.append((ckv.bfloat16(), kpe.bfloat16(), None, None))
                else:
                    bits = 8 if kind == "int8" else 4
                    (cc, cs), (kc, ks) = (_kv_quantize(t, bits=bits) for t in (ckv, kpe))
                    if bits == 4:
                        cc, kc = _pack_nibbles(cc), _pack_nibbles(kc)
                    args.append((cc, kc, cs, ks))
            ckv0, kpe0, cs0, ks0 = args[0]
            got = paged_mla_attention_cuda(q_lat, q_pe, ckv0, kpe0, bt, lengths, cs0, ks0,
                                           scale=scale, **kw)
            torch.cuda.synchronize()
            want = paged_mla_attention_plain(q_lat, q_pe, ckv0, kpe0, bt, lengths, cs0, ks0,
                                             scale=scale, **kw)
            err = (got - want).abs().max().item()
            if not err <= MLA_TOL:
                raise AssertionError(f"paged_mla_attention {case} {kind}: max err {err}")
            it = iter(range(10**9))

            def call():
                c, k, cs, ks = args[next(it) % copies]
                return paged_mla_attention_cuda(q_lat, q_pe, c, k, bt, lengths, cs, ks,
                                                scale=scale, **kw)

            ms = graph_ms(call, 30)
            if kind == "bf16":
                ckv_d, kpe_d = ckv0.float(), kpe0.float()
            else:
                ckv_d, kpe_d = ((_unpack_nibbles(c) if kind == "int4" else c).float()
                                * sc[..., None] for c, sc in ((ckv0, cs0), (kpe0, ks0)))
            ckv_g = ckv_d[bt.long()].reshape(B, 1, S, R).bfloat16()
            kpe_g = kpe_d[bt.long()].reshape(B, 1, S, P).bfloat16()
            qs = torch.cat([q_lat, q_pe], dim=-1)[:, :, None, :].bfloat16()
            kg = torch.cat([ckv_g, kpe_g], dim=-1).contiguous()
            vg = ckv_g.contiguous()
            mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                qs, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True), 5)
            elt = ckv0.element_size()
            n_bytes = (toks * (ckv0.shape[-1] + kpe0.shape[-1]) * elt
                       + (toks * 8 if cs0 is not None else 0) + 4 * B * H * (2 * R + P))
            b_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            b_ops = 2 * H * toks * (R + P + R) / 989e12 * 1e3  # the bf16 tensor-core peak
            b_ms = max(b_bytes, b_ops)
            out[f"{case} {kind}"] = {"ms": ms, "sdpa_ms": lib_ms, "bound_ms": b_ms,
                                     "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                                     "max_abs_err": err}
            print(f"paged_mla_attention {case} {kind} B={B} MB={MB} keys={toks} act_bits=8: "
                  f"{ms:.5f} ms, SDPA on the gathered view {lib_ms:.5f} ms, bound {b_ms:.5f} ms "
                  f"({b_ms / ms:.1%}), max err {err:.3g}", flush=True)
            del args, kg, vg, ckv_g, kpe_g
        del pools
        torch.cuda.empty_cache()
    return out


# (case, B, T, y dtype, decay floored at e^-8, carried state): chip_smoke.py's
# phase-3 shapes of rwkv6-7b's recurrence (H=64, D=64, bf16 r/k/v)
RWKV_CASES = [("decode", 8, 1, torch.float32, False, True),
              ("prefill T=32", 1, 32, torch.bfloat16, False, True),
              ("chunk T=64, floored", 1, 64, torch.bfloat16, True, False),
              ("engine chunk T=512, floored", 1, 512, torch.bfloat16, True, True),
              ("engine chunk T=1024, floored", 1, 1024, torch.bfloat16, True, True),
              ("prompt T=4096, cacheless, floored", 1, 4096, torch.bfloat16, True, False),
              ("cacheless 8 x 64, floored", 8, 64, torch.bfloat16, True, False)]


def time_rwkv6_scan(dev) -> dict:
    """rwkv6_scan through the wrapper's public arguments (every version of the
    port takes them) at ``RWKV_CASES``: held to the plain version (1e-5 of
    the largest |y| with fp32 y, 2^-7 with bf16 y, 1e-5 of the largest |S|),
    then timed; the bound is the bytes (each input read once, each output
    written once) at 3.35 TB/s."""
    import math

    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda, rwkv6_scan_plain

    out = {}
    H, D = 64, 64
    for case, B, T, out_dtype, floor, carried in RWKV_CASES:
        gen = torch.Generator(device=dev).manual_seed(T + B)
        heads = lambda t: t.reshape(B, T, H, D).transpose(1, 2)  # noqa: E731
        r, k, v = (heads(torch.randn((B, T, H * D), generator=gen, device=dev).bfloat16())
                   for _ in range(3))
        w = heads(torch.exp(-torch.exp(
            torch.randn((B, T, H * D), generator=gen, device=dev) - 0.6)))
        if floor:
            w[..., ::7] = 1e-5
        u = torch.randn((H, D), generator=gen, device=dev) * 0.5
        s0 = torch.randn((B, H, D, D), generator=gen, device=dev)
        kw = dict(out_dtype=out_dtype, min_w=math.exp(-8.0) if floor else None)
        init = s0 if carried else None
        state = s0.clone() if carried else None
        y, s = rwkv6_scan_cuda(r, k, v, w, u, state, state_out=state, **kw)
        torch.cuda.synchronize()
        y_p, s_p = rwkv6_scan_plain(r, k, v, w, u, init, **kw)
        err_y = (y.float() - y_p.float()).abs().max().item()
        err_s = (s - s_p).abs().max().item()
        rel = 1e-5 if out_dtype == torch.float32 else 2.0**-7
        if not (err_y <= rel * y_p.float().abs().max().item()
                and err_s <= 1e-5 * s_p.abs().max().item()):
            raise AssertionError(f"rwkv6_scan {case}: y err {err_y}, state err {err_s}")
        ms = graph_ms(lambda: rwkv6_scan_cuda(r, k, v, w, u, state, state_out=state, **kw),
                      30 if T < 512 else 5)
        n = B * H * T * D
        n_bytes = 10 * n + out_dtype.itemsize * n + 4 * H * D + \
            4 * B * H * D * D * (2 if carried else 1)
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        out[case] = {"ms": ms, "bound_ms": b_ms, "max_abs_err": err_y}
        print(f"rwkv6_scan {case} B={B} H={H} T={T} D={D}: {ms:.5f} ms, bound {b_ms:.5f} ms "
              f"({b_ms / ms:.1%}), y err {err_y:.3g}, state err {err_s:.3g}", flush=True)
        del r, k, v, w, y, y_p
    return out


KERNELS = ("int_matmul", "paged_attention", "paged_mla_attention", "a2q_quantize", "rwkv6_scan")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--rows", default="1,8,16")
    ap.add_argument("--split-k", type=int, default=None,
                    help="force int_matmul's decode K splits (trees with split_k)")
    ap.add_argument("--split-kv", type=int, default=None,
                    help="force paged_attention's table runs (trees with split_kv)")
    ap.add_argument("--only", default=None,
                    help=f"comma-separated subset of {','.join(KERNELS)}")
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
    only = KERNELS if args.only is None else tuple(args.only.split(","))
    if not set(only) <= set(KERNELS):
        ap.error(f"--only takes a subset of {','.join(KERNELS)}")
    _build.build_all(only)
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
    if "int_matmul" in only:
        res["int_matmul"] = time_int_matmul(dev, rows)
    if "paged_attention" in only:
        res["paged_attention"] = time_paged_attention(dev)
    if "paged_mla_attention" in only:
        res["paged_mla_attention"] = time_paged_mla_attention(dev)
    if "a2q_quantize" in only:
        res["a2q_quantize"] = time_a2q_quantize(dev)
    if "rwkv6_scan" in only:
        res["rwkv6_scan"] = time_rwkv6_scan(dev)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
