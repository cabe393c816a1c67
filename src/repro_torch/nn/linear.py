"""QuantLinear / QuantConv — every matmul-bearing layer of the port's models.

The paper's technique is a first-class mode of this layer, as in
``repro.nn.linear``:

* ``mode='none'`` — float weights,
* ``mode='qat'``  — baseline quantization-aware training (paper Sec. 2.1),
* ``mode='a2q'``  — accumulator-aware quantization (paper Sec. 4): l1
  weight-normalized ``(v, t, d)``, norm cap from the accumulator width P,
  round-toward-zero.

Hidden layers use (M, N, P) from :class:`QuantConfig`; ``boundary=True``
layers stay at 8 bits.  Weights are ``(d_in, d_out)``: output channels
(accumulators) on the last axis; a conv's are HWIO ``(kh, kw, c_in/groups,
c_out)``, so the same per-column quantizers apply with ``K = kh*kw*c_in/g``.

Deployment: ``deploy_linear`` turns a trained layer into ``{q8, s8}`` —
int8 weights whose l1 norm provably fits the P-bit accumulator; an A2Q layer
is quantized by ``kernels/ops.a2q_quantize`` (the fused kernel on the
card).  With ``int_forward=True`` a deployed layer runs ``act_quant(x) ->
int8 @ int8 -> int32 -> scaled output`` through the fused W8A8 kernel
(``kernels/ops.int_matmul``), with the int16 carry when ``acc_bits <= 16``.

Int8-out chaining (``int_chain=True``): at a chain break (a residual add, a
norm, the attention core, a gated MLP's ``silu(gate) * up`` — every edge of
the gated models the port serves) the consumer folds its act-quant into the
kernel's prologue (``aq_scale``), so no deployed linear pays a standalone
act-quant.  An :class:`IntAct` (int8 codes with their scale) is consumed
directly.  A producer that requantizes into its consumer's quantizer
(``out_aq`` from :func:`chain_out_aq`: rwkv6's channel-mix ``cm.wk ->
relu^2 -> cm.wv``, the non-gated MLP's ``w_in -> gelu -> w_out``) runs the
kernel's requant epilogue and returns an :class:`IntAct` (``chained``).

Inside an ``acc_probe_scope`` every fused call samples the worst partial-sum
magnitude its actual integer operands can produce (``_probe_acc``), the
runtime twin of the A2Q bound; ``obs/headroom.py`` drives it.

Every ``int_forward`` call records its disposition (``folded`` for the
prologue or an ``IntAct`` input, ``standalone`` for the fused path with its
own act-quant, ``fallback`` for the dequant path) into the active
``chain_report_scope``.  The port runs eagerly, so the report lists every
call of the last forward (one entry per layer per site), where the reference
lists the call sites of a compiled program.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import QuantConfig
from repro_torch.dist.sharding import even_shards, local_as
from repro_torch.core.a2q import a2q_penalty, apply_a2q, init_a2q
from repro_torch.core.quantizers import (
    act_quant_int,
    apply_act_quant,
    apply_weight_qat,
    init_act_quant,
    init_weight_qat,
    weight_qat_int,
)
from repro_torch.nn.module import kaiming

__all__ = [
    "init_linear",
    "apply_linear",
    "deploy_linear",
    "linear_penalty",
    "init_conv",
    "apply_conv",
    "IntAct",
    "chain_out_aq",
    "chain_report_scope",
    "acc_probe_scope",
]


class IntAct(NamedTuple):
    """A chained integer activation, ``(codes, scale, bits, signed)``:
    ``codes`` int8 with the layer-output shape, unsigned 8-bit codes stored
    symmetrized (``true_code - 128``); ``scale`` the activation scale they
    were quantized with (the consumer's ``exp2(aq.log2_scale)``)."""

    codes: torch.Tensor
    scale: torch.Tensor
    bits: int
    signed: bool


def _int_act_to_fp(a: IntAct, dtype) -> torch.Tensor:
    """Re-materialize an IntAct to floating point (chain-repair fallback)."""
    q = a.codes.to(torch.float32)
    if not a.signed and a.bits == 8:
        q = q + 128.0
    return (q * a.scale).to(dtype)


_ACTIVE_REPORT: list = []
_WARNED: set = set()


@contextlib.contextmanager
def chain_report_scope(report: dict):
    """Collect ``int_forward`` dispositions into ``report`` (cleared on
    entry): ``folded`` — the act-quant ran inside the fused kernel (the
    prologue, or an ``IntAct`` input); ``standalone`` — a deployed layer ran
    the fused kernel after its own act-quant dispatch (must be empty under
    ``int_chain``); ``fallback`` — the fused path was unavailable and the
    layer took the dequant path; ``chained`` — the layer requantized in its
    epilogue and handed int8 codes to the next linear (recorded besides the
    layer's ``folded`` or ``standalone`` entry)."""
    report.clear()
    report.update({"folded": [], "chained": [], "standalone": [], "fallback": []})
    _ACTIVE_REPORT.append(report)
    try:
        yield report
    finally:
        _ACTIVE_REPORT.pop()


def _record(kind: str, site: str):
    if _ACTIVE_REPORT:
        _ACTIVE_REPORT[-1][kind].append(site)


# --- accumulator-headroom probe --------------------------------------------
#
# The A2Q guarantee is proved statically from the deployed weights' l1 norms;
# this probe makes it observable: inside an acc_probe_scope each fused-path
# call samples the worst partial-sum magnitude its actual integer operands
# could produce and records it against the layer's accumulator bound.

_ACTIVE_ACC_PROBE: list = []


@contextlib.contextmanager
def acc_probe_scope(samples: list):
    """Sample observed accumulator magnitudes from the fused W8A8 path.

    Inside the scope, every eager ``_apply_linear_int8`` call appends one
    record per call::

        {"site", "acc_max", "acc_bits", "bound", "spill_int16",
         "in_bits", "in_signed"}

    ``acc_max`` is ``max(|x_codes| @ |q8|)`` over output channels in int64
    on the host — an upper bound on the magnitude of *any* partial sum, in
    any accumulation order, for the actual integer operands (the runtime
    twin of the paper's Eq. 11 check, which bounds the same quantity by
    ``||w||_1 * 2**(N - 1_signed)`` over all inputs).  The port's layer
    stacks are a Python loop, so every deployed call of a forward records
    (the reference's scanned stacks trace abstract operands and record only
    their unstacked sites).  The codes are read back to the host inside the
    scope only; outside it the probe does nothing, and it skips while a CUDA
    graph is being captured (a read-back cannot be captured)."""
    samples.clear()
    _ACTIVE_ACC_PROBE.append(samples)
    try:
        yield samples
    finally:
        _ACTIVE_ACC_PROBE.pop()


def _probing(x: torch.Tensor) -> bool:
    """A probe scope is open and ``x`` can be read back (no CUDA graph is
    being captured)."""
    return bool(_ACTIVE_ACC_PROBE) and not (x.is_cuda and torch.cuda.is_current_stream_capturing())


def _probe_acc(site, codes, q8, *, in_bits, in_signed, acc_bits, spill_int16,
               symmetrized=False):
    if not _probing(codes):
        return
    xc = codes.detach().to("cpu", torch.int64)
    if symmetrized:
        xc = xc + 128  # stored codes are true - 128 (unsigned-8 ride-along)
    xc = xc.abs().reshape(-1, xc.shape[-1])
    wq = q8.detach().to("cpu", torch.int64).abs()
    acc_max = int((xc @ wq).max()) if xc.numel() and wq.numel() else 0
    _ACTIVE_ACC_PROBE[-1].append({
        "site": site,
        "acc_max": acc_max,
        "acc_bits": int(acc_bits),
        "bound": 2 ** (int(acc_bits) - 1) - 1,
        "spill_int16": bool(spill_int16),
        "in_bits": int(in_bits),
        "in_signed": bool(in_signed),
    })


def _warn_fallback_once(site: str, reason: str):
    key = (site, reason)
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(
            f"int_forward fallback at {site or '<unlabeled linear>'}: {reason} "
            "(dequant path; counted in the chain report)",
            stacklevel=3,
        )


def _bits(cfg: QuantConfig, boundary: bool) -> tuple[int, int]:
    if boundary:
        return cfg.boundary_bits, cfg.boundary_bits
    return cfg.weight_bits, cfg.act_bits


def init_linear(
    gen: torch.Generator,
    d_in: int,
    d_out: int,
    cfg: QuantConfig,
    *,
    use_bias: bool = False,
    boundary: bool = False,
    input_signed: bool = True,
    w_std: Optional[float] = None,
    act_absmax: float = 6.0,
) -> dict:
    """Weights are stored ``(d_in, d_out)``; tensors land on ``gen.device``."""
    if w_std is None:
        w = kaiming(gen, (d_in, d_out), fan_in=d_in)
    else:
        w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * w_std
    M, N = _bits(cfg, boundary)
    p: dict = {}
    if cfg.mode == "none":
        p["w"] = w
    elif cfg.mode == "qat":
        p["w"] = w
        p["wq"] = init_weight_qat(w, M)
        p["aq"] = init_act_quant(N, input_signed, init_absmax=act_absmax, device=w.device)
    elif cfg.mode == "a2q":
        p.update(init_a2q(w, M, cfg.acc_bits, N, input_signed))
        p["aq"] = init_act_quant(N, input_signed, init_absmax=act_absmax, device=w.device)
    else:
        raise ValueError(cfg.mode)
    if use_bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=w.device)
    return p


def _quant_weights(params: dict, cfg: QuantConfig, boundary: bool, input_signed: bool):
    M, N = _bits(cfg, boundary)
    if "fq" in params:  # fake-quant weights computed ahead for a whole stack (training)
        return params["fq"]
    if "q8" in params:  # deployed int8 storage; s8 is per output channel
        return params["q8"].to(torch.float32) * params["s8"][..., None, :]
    if cfg.mode == "none":
        return params["w"]
    if cfg.mode == "qat":
        return apply_weight_qat({"log2_scale": params["wq"]["log2_scale"]}, params["w"], M)
    if cfg.mode == "a2q":
        return apply_a2q({"v": params["v"], "t": params["t"], "d": params["d"]},
                         M, cfg.acc_bits, N, input_signed)
    raise ValueError(cfg.mode)


def chain_out_aq(consumer: dict, cfg: QuantConfig, *, boundary: bool = False,
                 input_signed: bool = True, act_fn: Optional[str] = None) -> Optional[dict]:
    """The consumer's activation-quantizer descriptor if a producer could
    requantize into it (a deployed 2-D consumer with ``N <= 8``), else
    ``None`` (a chain break).  ``act_fn`` names the elementwise activation
    between the two linears."""
    N = _bits(cfg, boundary)[1]
    if "q8" not in consumer or "aq" not in consumer or N > 8 or consumer["q8"].ndim != 2:
        return None
    return {"log2_scale": consumer["aq"]["log2_scale"], "bits": N, "signed": input_signed,
            "act_fn": act_fn}


def _apply_linear_int8(params: dict, x, cfg: QuantConfig, *, boundary: bool,
                       input_signed: bool, compute_dtype, int_chain: bool = False,
                       out_aq: Optional[dict] = None, site: str = ""):
    """Fused W8A8 forward: the activation scale folds into the per-channel
    weight scale, so the kernel's epilogue is one per-column fp32 rescale
    (+ bias); the int16 carry engages when A2Q guarantees ``acc_bits <=
    16``.  Where the act-quant runs:

    * ``x`` an :class:`IntAct` — the codes feed the kernel (``folded``);
    * ``int_chain`` with an fp ``x`` — in the kernel's prologue (``folded``),
      bit for bit the standalone act-quant's codes;
    * else on its own ahead of the kernel (``standalone``), unsigned 8-bit
      codes symmetrized into the int8 operand.

    With ``out_aq`` (the consumer's quantizer) the epilogue requantizes into
    it and the call returns an :class:`IntAct` (``chained``).  On DTensors
    (a sharded forward) it runs on each rank's rows and output columns
    (``_apply_linear_int8_sharded``)."""
    from repro_torch.kernels import ops

    if any(isinstance(t, DTensor) for t in (x, params["q8"])):
        return _apply_linear_int8_sharded(params, x, cfg, boundary=boundary,
                                          input_signed=input_signed,
                                          compute_dtype=compute_dtype, int_chain=int_chain,
                                          out_aq=out_aq, site=site)
    M, N = _bits(cfg, boundary)
    a2q = cfg.mode == "a2q"
    kw = dict(acc_bits=cfg.acc_bits if a2q else 32, mode="exact",
              spill_int16=a2q and cfg.acc_bits <= 16, bias=params.get("b"))
    if out_aq is not None:
        out_scale = torch.exp2(out_aq["log2_scale"].to(torch.float32))
        kw.update(out_scale=out_scale, out_bits=out_aq["bits"], out_signed=out_aq["signed"],
                  act_fn=out_aq["act_fn"], cast_dtype=compute_dtype)
    s8 = params["s8"].to(torch.float32)
    if isinstance(x, IntAct):
        _record("folded", site)
        _probe_acc(site, x.codes, params["q8"], in_bits=x.bits, in_signed=x.signed,
                   acc_bits=kw["acc_bits"], spill_int16=kw["spill_int16"],
                   symmetrized=not x.signed and x.bits == 8)
        K = x.codes.shape[-1]
        lead = x.codes.shape[:-1]
        y = ops.int_matmul(x.codes.reshape(-1, K), params["q8"], scale=x.scale * s8,
                           in_bits=x.bits, in_signed=x.signed, **kw)
    elif int_chain:
        _record("folded", site)
        x_scale = torch.exp2(params["aq"]["log2_scale"].to(torch.float32))
        if _probing(x):
            # replay the prologue's quantization on the fp32 upcast (bf16
            # widens exactly), so the probe sees the codes the kernel folds
            xq_p, _ = act_quant_int({"log2_scale": params["aq"]["log2_scale"]},
                                    x.to(torch.float32), N, signed=input_signed)
            _probe_acc(site, xq_p, params["q8"], in_bits=N, in_signed=input_signed,
                       acc_bits=kw["acc_bits"], spill_int16=kw["spill_int16"])
        K = x.shape[-1]
        lead = x.shape[:-1]
        # bf16 goes in as it is: the prologue widens it exactly
        xf = x if x.dtype == torch.bfloat16 else x.to(torch.float32)
        y = ops.int_matmul(xf.reshape(-1, K), params["q8"],
                           scale=x_scale * s8, aq_scale=x_scale, in_bits=N,
                           in_signed=input_signed, **kw)
    else:
        _record("standalone", site)
        xq, x_scale = act_quant_int({"log2_scale": params["aq"]["log2_scale"]},
                                    x.to(torch.float32), N, signed=input_signed)
        _probe_acc(site, xq, params["q8"], in_bits=N, in_signed=input_signed,
                   acc_bits=kw["acc_bits"], spill_int16=kw["spill_int16"])
        if not input_signed and N == 8:
            xq = xq - 128.0
        K = x.shape[-1]
        lead = x.shape[:-1]
        y = ops.int_matmul(xq.to(torch.int8).reshape(-1, K), params["q8"],
                           scale=x_scale * s8, in_bits=N, in_signed=input_signed, **kw)
    if out_aq is not None:
        _record("chained", site)
        return IntAct(codes=y.reshape(*lead, y.shape[-1]), scale=out_scale,
                      bits=out_aq["bits"], signed=out_aq["signed"])
    return y.reshape(*lead, y.shape[-1]).to(compute_dtype)


def _apply_linear_int8_sharded(params: dict, x, cfg: QuantConfig, *, out_aq, **kw):
    """The W8A8 forward on DTensors: an integer product cannot be summed
    from K-split partials through the epilogue, so each rank gathers the
    activation's K and the weight's K and runs the kernel on its own rows
    (the activation's batch split) and output columns (the weight's N split
    on the mesh dims the rows leave free); ``s8`` and the bias follow the
    columns.  The output is those rows and columns.  Not chained: an
    :class:`IntAct` does not cross ranks."""
    if isinstance(x, IntAct) or out_aq is not None:
        raise NotImplementedError("the chained integer path does not run on DTensors")
    q8 = params["q8"]
    mesh = (x if isinstance(x, DTensor) else q8).device_mesh
    whole = [Replicate()] * mesh.ndim
    xp = even_shards(x, range(x.dim() - 1)) if isinstance(x, DTensor) else whole
    wpl = q8.placements if isinstance(q8, DTensor) else whole
    wp = [Shard(1) if w == Shard(1) and r == Replicate() else Replicate()
          for w, r in zip(wpl, xp)]
    cols = [Shard(0) if p == Shard(1) else Replicate() for p in wp]
    lp = {"q8": local_as(q8, mesh, wp), "s8": local_as(params["s8"], mesh, cols),
          "aq": {"log2_scale": local_as(params["aq"]["log2_scale"], mesh, whole)}}
    if "b" in params:
        lp["b"] = local_as(params["b"], mesh, cols)
    y = _apply_linear_int8(lp, local_as(x, mesh, xp), cfg, out_aq=None, **kw)
    out = [Shard(y.dim() - 1) if c == Shard(0) else r for c, r in zip(cols, xp)]
    return DTensor.from_local(y, mesh, out, run_check=False)


def apply_linear(
    params: dict,
    x,
    cfg: QuantConfig,
    *,
    boundary: bool = False,
    input_signed: bool = True,
    compute_dtype=torch.bfloat16,
    int_forward: bool = False,
    int_chain: bool = False,
    out_aq: Optional[dict] = None,
    site: str = "",
) -> torch.Tensor:
    """``y = act_quant(x) @ quant(w) (+ b)`` in ``compute_dtype``.

    ``int_forward=True`` on a deployed layer (``q8``/``s8`` and an activation
    quantizer, ``N <= 8``, 2-D weights) runs the fused W8A8 integer path
    instead of dequant + ``compute_dtype`` matmul; ``int_chain=True`` folds
    the act-quant into the kernel's prologue, and ``x`` may be an
    :class:`IntAct`; with ``out_aq`` (from :func:`chain_out_aq`) the result
    is one too, requantized in the kernel's epilogue."""
    M, N = _bits(cfg, boundary)
    if int_forward and "q8" in params:
        if "aq" in params and N <= 8 and params["q8"].ndim == 2:
            return _apply_linear_int8(params, x, cfg, boundary=boundary,
                                      input_signed=input_signed, compute_dtype=compute_dtype,
                                      int_chain=int_chain, out_aq=out_aq, site=site)
        if "aq" not in params:
            reason = "no activation quantizer in the deployed params"
        elif N > 8:
            reason = f"act bits N={N} > 8"
        else:
            reason = f"stacked weight leaves (rank {params['q8'].ndim})"
        _warn_fallback_once(site, reason)
        _record("fallback", site)
    if isinstance(x, IntAct):
        # chain repair: the consumer cannot take codes — re-materialize fp
        _record("fallback", site)
        x = _int_act_to_fp(x, compute_dtype)
    if cfg.mode != "none" and "aq" in params:
        x = apply_act_quant({"log2_scale": params["aq"]["log2_scale"]}, x, N, signed=input_signed)
    w = _quant_weights(params, cfg, boundary, input_signed).to(compute_dtype)
    y = torch.matmul(x.to(compute_dtype), w)
    if "b" in params:
        y = y + params["b"].to(compute_dtype)
    return y


def linear_penalty(params: dict, cfg: QuantConfig, boundary: bool,
                   input_signed: bool) -> torch.Tensor:
    """This layer's ``R_l = sum_i max(t_i - T_i, 0)`` (zero unless a2q); any
    leading axes of ``t``/``d`` (a stack's layers, experts) are summed too."""
    if cfg.mode != "a2q" or "t" not in params:
        return torch.zeros((), dtype=torch.float32)
    _, N = _bits(cfg, boundary)
    return a2q_penalty(params, cfg.acc_bits, N, input_signed)


def deploy_linear(params: dict, cfg: QuantConfig, *, boundary: bool = False,
                  input_signed: bool = True) -> dict:
    """A2Q/QAT layer -> inference artifacts ``{q8 int8, s8 scale [, b, aq]}``,
    ``q8`` in the layer's own weight shape (a linear's ``(K, C)``, a conv's
    HWIO leaf whole: every axis but the last is the accumulator's ``K``;
    ``serve.engine.deploy_params`` walks stacked leaves).  The A2Q codes come
    from ``ops.a2q_quantize`` on the ``(K, C)`` view (``a2q_int_weights``'
    arithmetic; the fused kernel for CUDA tensors), the scale is ``2^d``."""
    from repro_torch.kernels import ops

    M, N = _bits(cfg, boundary)
    if cfg.mode == "a2q":
        v = params["v"]
        q, s = ops.a2q_quantize(v.reshape(-1, v.shape[-1]), params["t"], params["d"],
                                weight_bits=M, acc_bits=cfg.acc_bits, input_bits=N,
                                input_signed=input_signed)
        q = q.reshape(v.shape)
    elif cfg.mode == "qat":
        q, s = weight_qat_int({"log2_scale": params["wq"]["log2_scale"]}, params["w"], M)
    else:
        raise ValueError("deploy requires a quantized mode")
    out = {"q8": q.to(torch.int8), "s8": s.to(torch.float32)}
    if "b" in params:
        out["b"] = params["b"]
    if "aq" in params:
        out["aq"] = params["aq"]
    return out


# ---------------------------------------------------------------------------
# Conv (the vision networks: MobileNetV1 / ResNet18 / ESPCN / UNet)
# ---------------------------------------------------------------------------


def init_conv(
    gen: torch.Generator,
    c_in: int,
    c_out: int,
    kernel: tuple[int, int],
    cfg: QuantConfig,
    *,
    groups: int = 1,
    use_bias: bool = False,
    boundary: bool = False,
    input_signed: bool = False,  # the vision nets are ReLU nets: unsigned inputs
) -> dict:
    """HWIO weights ``(kh, kw, c_in/groups, c_out)``, channel axis last, so
    A2Q's per-output-channel reduction (one accumulator, ``K =
    kh*kw*c_in/groups``) applies unchanged; tensors land on ``gen.device``."""
    kh, kw = kernel
    w = kaiming(gen, (kh, kw, c_in // groups, c_out), fan_in=kh * kw * (c_in // groups))
    M, N = _bits(cfg, boundary)
    p: dict = {}
    if cfg.mode == "none":
        p["w"] = w
    elif cfg.mode == "qat":
        p["w"] = w
        p["wq"] = init_weight_qat(w, M)
        p["aq"] = init_act_quant(N, input_signed, device=w.device)
    elif cfg.mode == "a2q":
        p.update(init_a2q(w, M, cfg.acc_bits, N, input_signed))
        p["aq"] = init_act_quant(N, input_signed, device=w.device)
    else:
        raise ValueError(cfg.mode)
    if use_bias:
        p["b"] = torch.zeros((c_out,), dtype=torch.float32, device=w.device)
    return p


def _same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis, ``(before, after)``: the
    output keeps ``ceil(size / stride)`` positions and the odd pad goes
    after (a stride-2 3x3 conv on an even size pads ``(0, 1)``, where
    PyTorch's ``padding=1`` pads ``(1, 1)``)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def apply_conv(
    params: dict,
    x: torch.Tensor,
    cfg: QuantConfig,
    *,
    stride: tuple[int, int] = (1, 1),
    padding: str = "SAME",
    groups: int = 1,
    boundary: bool = False,
    input_signed: bool = False,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """NHWC convolution with ``apply_linear``'s quant pipeline: the input's
    act-quant, then the layer's weights (fake-quant, or deployed ``q8 *
    s8``) permuted from HWIO to OIHW at the call; ``padding`` ``"SAME"``
    (as XLA pads) or ``"VALID"``.  The NHWC input goes to
    ``torch.nn.functional.conv2d`` as a channels-last NCHW view."""
    M, N = _bits(cfg, boundary)
    if cfg.mode != "none" and "aq" in params:
        x = apply_act_quant({"log2_scale": params["aq"]["log2_scale"]}, x, N, signed=input_signed)
    w = _quant_weights(params, cfg, boundary, input_signed).to(compute_dtype)
    kh, kw = w.shape[:2]
    x = x.to(compute_dtype).permute(0, 3, 1, 2)
    if padding == "SAME":
        (t, b), (lft, r) = (_same_padding(x.shape[2], kh, stride[0]),
                            _same_padding(x.shape[3], kw, stride[1]))
    elif padding == "VALID":
        t = b = lft = r = 0
    else:
        raise ValueError(f"apply_conv: padding {padding!r} is not 'SAME' or 'VALID'")
    if (t, lft) != (b, r):
        x = torch.nn.functional.pad(x, (lft, r, t, b))
        t = lft = 0
    y = torch.nn.functional.conv2d(x, w.permute(3, 2, 0, 1), stride=tuple(stride),
                                   padding=(t, lft), groups=groups)
    y = y.permute(0, 2, 3, 1)
    if "b" in params:
        y = y + params["b"].to(compute_dtype)
    return y
