"""The paper's four benchmark networks (Sec. 5.1, App. B) and the App. A
linear classifier, port of ``repro.models.vision``, with QuantConv /
QuantLinear so float, baseline-QAT and A2Q train as in the paper:

* MobileNetV1 (CIFAR10 variant: stride-2 first conv, stride-2 final pool)
* ResNet18    (CIFAR10 variant: 3x3 s1 stem, no maxpool, conv shortcuts)
* ESPCN       (3x SISR, sub-pixel conv replaced by NNRC as in App. B.2)
* UNet        (3 enc/3 dec, NNRC upsampling, adds instead of concats)

Activations are NHWC and conv weights HWIO, the reference's layouts; the
trees are the reference's, lists included (``blocks``, ``enc``, ``dec``).
All hidden activations are ReLU -> unsigned activation quantizers; first and
last layers stay 8-bit (App. B).  ``deploy_vision`` (the port's own: the
reference deploys no vision tree) turns a trained tree into ``{q8, s8}``
layers through ``deploy_linear``, so each conv's codes come from the
``a2q_quantize`` kernel on the card.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import QuantConfig
from repro_torch.core.a2q import a2q_int_weights, init_a2q
from repro_torch.core.lut import LayerGeometry
from repro_torch.core.quantizers import init_weight_qat
from repro_torch.nn.linear import apply_conv, apply_linear, deploy_linear, init_conv, init_linear
from repro_torch.nn.module import tree_map, tree_to
from repro_torch.optim.optimizers import Optimizer
from repro_torch.nn.transformer import tree_a2q_penalty

__all__ = [
    "init_mobilenet_v1",
    "apply_mobilenet_v1",
    "init_resnet18",
    "apply_resnet18",
    "init_espcn",
    "apply_espcn",
    "init_unet",
    "apply_unet",
    "init_linear_classifier",
    "apply_linear_classifier",
    "vision_penalty",
    "requantize_from_float",
    "layer_geometries",
    "deploy_vision",
    "BOUNDARY_LAYERS",
    "vision_loss",
    "build_vision_train_step",
    "VISION_MODELS",
]

relu = torch.relu


def _bn_init(c, device):
    return {"scale": torch.ones((c,), dtype=torch.float32, device=device),
            "bias": torch.zeros((c,), dtype=torch.float32, device=device)}


def _bn(p, x):
    """Batch-stat normalization + affine, over N, H and W with the population
    variance (``jnp.var``'s ddof 0), as the reference normalizes."""
    mu = x.mean(dim=(0, 1, 2))
    var = x.var(dim=(0, 1, 2), correction=0)
    xn = (x - mu) * torch.rsqrt(var + 1e-5)
    return xn * p["scale"] + p["bias"]


# ---------------------------------------------------------------------------
# 1-layer binary-MNIST classifier (Fig. 2 / App. A motivating example)
# ---------------------------------------------------------------------------


def init_linear_classifier(gen: torch.Generator, q: QuantConfig, d_in: int = 784,
                           n_out: int = 2, device="cuda") -> dict:
    # K=784, 1-bit unsigned inputs, 8-bit weights: the paper's exact setup.
    # act_absmax=1: the inputs are already {0,1}, the 1-bit quantizer is identity.
    return tree_to({"fc": init_linear(gen, d_in, n_out, q, input_signed=False,
                                      use_bias=False, act_absmax=1.0)}, resolve_device(device))


def apply_linear_classifier(params, x, q: QuantConfig):
    return apply_linear(params["fc"], x, q, input_signed=False, compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# MobileNetV1 (App. B.1)
# ---------------------------------------------------------------------------

# (channels, depthwise stride) for each of the 13 separable blocks, CIFAR variant
_MBN_CFG = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1)]


def init_mobilenet_v1(gen: torch.Generator, q: QuantConfig, n_classes: int = 10,
                      width: float = 1.0, device="cuda") -> dict:
    """Drawn from ``gen`` on its device, placed on ``device``."""
    w = lambda c: max(int(c * width), 8)
    g = gen.device
    p: dict = {"stem": init_conv(gen, 3, w(32), (3, 3), q, boundary=True),
               "stem_bn": _bn_init(w(32), g), "blocks": []}
    c_in = w(32)
    for c_out, _ in _MBN_CFG:
        c_out = w(c_out)
        p["blocks"].append({
            "dw": init_conv(gen, c_in, c_in, (3, 3), q, groups=c_in),
            "dw_bn": _bn_init(c_in, g),
            "pw": init_conv(gen, c_in, c_out, (1, 1), q),
            "pw_bn": _bn_init(c_out, g),
        })
        c_in = c_out
    p["head"] = init_linear(gen, c_in, n_classes, q, boundary=True, input_signed=False,
                            use_bias=True)
    return tree_to(p, resolve_device(device))


def apply_mobilenet_v1(params, x, q: QuantConfig):
    x = relu(_bn(params["stem_bn"], apply_conv(params["stem"], x, q, stride=(2, 2), boundary=True)))
    for b, (_, stride) in zip(params["blocks"], _MBN_CFG):
        x = relu(_bn(b["dw_bn"], apply_conv(b["dw"], x, q, stride=(stride, stride),
                                            groups=x.shape[-1])))
        x = relu(_bn(b["pw_bn"], apply_conv(b["pw"], x, q)))
    x = x.mean(dim=(1, 2))  # stride-2 global pool on 32x32 ends at 1x1
    return apply_linear(params["head"], x, q, boundary=True, input_signed=False,
                        compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# ResNet18 (App. B.1: 3x3 s1 stem, conv shortcuts)
# ---------------------------------------------------------------------------


_RESNET_STRIDES = (1, 1, 2, 1, 2, 1, 2, 1)  # first block of groups 2-4 downsamples


def _init_basic(gen, c_in, c_out, q):
    g = gen.device
    return {
        "c1": init_conv(gen, c_in, c_out, (3, 3), q), "bn1": _bn_init(c_out, g),
        "c2": init_conv(gen, c_out, c_out, (3, 3), q), "bn2": _bn_init(c_out, g),
        "sc": init_conv(gen, c_in, c_out, (1, 1), q), "bn_sc": _bn_init(c_out, g),
    }


def init_resnet18(gen: torch.Generator, q: QuantConfig, n_classes: int = 10,
                  width: float = 1.0, device="cuda") -> dict:
    """Drawn from ``gen`` on its device, placed on ``device``."""
    w = lambda c: max(int(c * width), 8)
    p = {"stem": init_conv(gen, 3, w(64), (3, 3), q, boundary=True),
         "stem_bn": _bn_init(w(64), gen.device), "blocks": []}
    c_in = w(64)
    for c_out, blocks in [(w(64), 2), (w(128), 2), (w(256), 2), (w(512), 2)]:
        for _ in range(blocks):
            p["blocks"].append(_init_basic(gen, c_in, c_out, q))
            c_in = c_out
    p["head"] = init_linear(gen, c_in, n_classes, q, boundary=True, input_signed=False,
                            use_bias=True)
    return tree_to(p, resolve_device(device))


def apply_resnet18(params, x, q: QuantConfig):
    x = relu(_bn(params["stem_bn"], apply_conv(params["stem"], x, q, boundary=True)))
    for b, stride in zip(params["blocks"], _RESNET_STRIDES):
        s = (stride, stride)
        h = relu(_bn(b["bn1"], apply_conv(b["c1"], x, q, stride=s)))
        h = _bn(b["bn2"], apply_conv(b["c2"], h, q))
        sc = _bn(b["bn_sc"], apply_conv(b["sc"], x, q, stride=s))
        x = relu(h + sc)
    x = x.mean(dim=(1, 2))
    return apply_linear(params["head"], x, q, boundary=True, input_signed=False,
                        compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# ESPCN / UNet (App. B.2) — NNRC = nearest-neighbor resize + conv
# ---------------------------------------------------------------------------


def _nn_resize(x, factor: int):
    """``jax.image.resize(..., "nearest")`` by a whole factor: each pixel
    repeated ``factor`` times along H and W."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def _max_pool_same(x):
    """2x2 stride-2 max pool over NHWC with XLA's ``"SAME"`` padding (``-inf``
    after an odd edge), as ``lax.reduce_window`` pools."""
    H, W = x.shape[1:3]
    x = x.permute(0, 3, 1, 2)
    if H % 2 or W % 2:
        x = torch.nn.functional.pad(x, (0, W % 2, 0, H % 2), value=float("-inf"))
    return torch.nn.functional.max_pool2d(x, 2, 2).permute(0, 2, 3, 1)


def init_espcn(gen: torch.Generator, q: QuantConfig, upscale: int = 3, device="cuda") -> dict:
    """Drawn from ``gen`` on its device, placed on ``device``."""
    return tree_to({
        "c1": init_conv(gen, 1, 64, (5, 5), q, boundary=True),
        "c2": init_conv(gen, 64, 64, (3, 3), q),
        "c3": init_conv(gen, 64, 32, (3, 3), q),
        "out": init_conv(gen, 32, 1, (3, 3), q, boundary=True),
    }, resolve_device(device))


def apply_espcn(params, x, q: QuantConfig, upscale: int = 3):
    x = relu(apply_conv(params["c1"], x, q, boundary=True))
    x = relu(apply_conv(params["c2"], x, q))
    x = relu(apply_conv(params["c3"], x, q))
    x = _nn_resize(x, upscale)
    return apply_conv(params["out"], x, q, boundary=True)


def init_unet(gen: torch.Generator, q: QuantConfig, base: int = 32, upscale: int = 3,
              device="cuda") -> dict:
    """Drawn from ``gen`` on its device, placed on ``device``."""
    c = [base, base * 2, base * 4]
    p = {"stem": init_conv(gen, 1, c[0], (3, 3), q, boundary=True), "enc": [], "dec": []}
    for cin, cout in [(c[0], c[1]), (c[1], c[2]), (c[2], c[2])]:
        p["enc"].append({"c1": init_conv(gen, cin, cout, (3, 3), q),
                         "c2": init_conv(gen, cout, cout, (3, 3), q)})
    # decoder outputs must match the skip channels: skips are (c0, c1, c2)
    for cin, cout in [(c[2], c[2]), (c[2], c[1]), (c[1], c[0])]:
        p["dec"].append({"c1": init_conv(gen, cin, cout, (3, 3), q),
                         "c2": init_conv(gen, cout, cout, (3, 3), q)})
    p["up"] = init_conv(gen, c[0], c[0], (3, 3), q)
    p["out"] = init_conv(gen, c[0], 1, (3, 3), q, boundary=True)
    return tree_to(p, resolve_device(device))


def apply_unet(params, x, q: QuantConfig, upscale: int = 3):
    x = relu(apply_conv(params["stem"], x, q, boundary=True))
    skips = []
    for e in params["enc"]:
        skips.append(x)
        x = _max_pool_same(x)
        x = relu(apply_conv(e["c1"], x, q))
        x = relu(apply_conv(e["c2"], x, q))
    for d, skip in zip(params["dec"], reversed(skips)):
        x = _nn_resize(x, 2)
        x = relu(apply_conv(d["c1"], x, q))
        x = relu(apply_conv(d["c2"], x, q))
        x = x + skip  # adds instead of concats (App. B.2)
    x = _nn_resize(x, upscale)
    x = relu(apply_conv(params["up"], x, q))
    return apply_conv(params["out"], x, q, boundary=True)


def vision_penalty(params, q: QuantConfig) -> torch.Tensor:
    """``tree_a2q_penalty``, as the reference's: it walks dicts only, so it
    skips every layer inside a list (MobileNetV1's and ResNet18's
    ``blocks``, UNet's ``enc``/``dec``), and caps the layers it reaches at
    the hidden width with signed inputs.  ``apply_a2q`` clamps ``t`` at the
    true cap whatever the penalty, so the guarantee holds; only the
    regularizer is weaker."""
    return tree_a2q_penalty(params, q)


def requantize_from_float(quant_tree, float_tree, q: QuantConfig):
    """Initialize a quantized model from trained float weights (paper App. B:
    'We initialize all models from floating-point counterparts pre-trained to
    convergence').  Walks the freshly-initialized quantized tree (which has
    the right aq/structure) and replaces every weight-derived leaf group with
    one calibrated from the float model's trained ``w``."""

    def walk(qt, ft):
        if isinstance(qt, dict):
            if "v" in qt and "t" in qt and "d" in qt:
                a = init_a2q(ft["w"], q.weight_bits, q.acc_bits, q.act_bits, False)
                out = {**qt, **a}
                if "b" in ft:
                    out["b"] = ft["b"]
                return out
            if "w" in qt and "wq" in qt:
                wq = init_weight_qat(ft["w"], q.weight_bits)
                out = {**qt, "w": ft["w"], "wq": {"log2_scale": wq["log2_scale"]}}
                if "b" in ft:
                    out["b"] = ft["b"]
                return out
            return {k: walk(v, ft[k]) for k, v in qt.items()}
        if isinstance(qt, list):
            return [walk(a, b) for a, b in zip(qt, ft)]
        # plain leaves (bn scales, biases) copy the trained float values
        return ft if ft is not None else qt

    return walk(quant_tree, float_tree)


VISION_MODELS = {
    "mobilenetv1": (init_mobilenet_v1, apply_mobilenet_v1),
    "resnet18": (init_resnet18, apply_resnet18),
    "espcn": (init_espcn, apply_espcn),
    "unet": (init_unet, apply_unet),
}

# the top-level layers each network applies with boundary=True (8 bits);
# "linear" is the App. A classifier
BOUNDARY_LAYERS = {"mobilenetv1": ("stem", "head"), "resnet18": ("stem", "head"),
                   "espcn": ("c1", "out"), "unet": ("stem", "out"), "linear": ()}


def deploy_vision(params, q: QuantConfig, model: str):
    """Every conv and linear layer of a ``model`` tree (a ``VISION_MODELS``
    key, or ``"linear"``) -> ``deploy_linear``'s ``{q8, s8, aq[, b]}`` at
    the widths its apply uses (the network's first and last layers at 8
    bits, every input unsigned), in tree order; the batch-norm leaves pass
    through.  The deployed tree runs through the same ``apply_*`` (``q8 *
    s8`` weights)."""
    boundary = BOUNDARY_LAYERS[model]

    def walk(node, top):
        if isinstance(node, dict):
            if {"v", "t", "d"} <= set(node) or {"w", "wq"} <= set(node):
                return deploy_linear(node, q, boundary=top in boundary, input_signed=False)
            return {k: walk(v, k if top is None else "") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, "") for v in node]
        return node

    return walk(params, None)


def vision_loss(params, model: str, batch: dict, q: QuantConfig) -> torch.Tensor:
    """The training loss of the repo's vision runs: cross-entropy on
    ``batch["x"]``/``["y"]`` for the classifiers (the benchmarks'
    ``train_classifier``), mean squared error on ``batch["lr"]``/``["hr"]``
    for ESPCN and UNet, plus ``q.reg_lambda * vision_penalty`` (0 unless
    A2Q)."""
    apply = apply_linear_classifier if model == "linear" else VISION_MODELS[model][1]
    if "y" in batch:
        logits = apply(params, batch["x"], q)
        loss = -torch.log_softmax(logits, -1).gather(-1, batch["y"].long()[:, None]).mean()
    else:
        loss = torch.mean((apply(params, batch["lr"], q) - batch["hr"]) ** 2)
    return loss + q.reg_lambda * vision_penalty(params, q)


def build_vision_train_step(model: str, q: QuantConfig, optimizer: Optimizer, lr: float):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``: one
    ``vision_loss`` gradient and optimizer update at a constant ``lr``.  The
    params are differentiated as detached copies that require grad, so the
    returned tensors never do (a deploy of them reaches the kernels);
    ``loss`` is a 0-dim device tensor."""

    def step(params, opt_state, batch):
        with torch.enable_grad():
            live = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss = vision_loss(live, model, batch, q)
            leaves = []
            tree_map(leaves.append, live)  # in tree_map's order, for the rebuild below
            got = iter(torch.autograd.grad(loss, leaves, materialize_grads=True))
        grads = tree_map(lambda _: next(got), live)
        with torch.no_grad():
            params, opt_state = optimizer.update(grads, opt_state, params, lr)
        return params, opt_state, loss.detach()

    return step


def layer_geometries(params, q: QuantConfig,
                     input_hw: tuple[int, int] = (32, 32)) -> list[LayerGeometry]:
    """Rough per-layer geometry extraction for the LUT cost model: walks conv/
    linear param subtrees (dict values in their order, lists in index
    order), derives (K, C_out, MACs) from weight shapes.  MAC spatial factors
    assume the CIFAR/BSD pipeline resolution.  An A2Q layer's sparsity is
    its codes' share of zeros at the hidden widths with unsigned inputs, as
    the reference counts it."""
    geoms = []

    def walk(node):
        if isinstance(node, dict):
            keyset = set(node.keys())
            if ("v" in keyset and "t" in keyset) or "w" in keyset:
                wshape = (node["v"] if "v" in node else node["w"]).shape
                if len(wshape) == 4:
                    kh, kw, ci, co = wshape
                    k = kh * kw * ci
                    spatial = input_hw[0] * input_hw[1]
                else:
                    k, co = wshape
                    spatial = 1
                sparsity = 0.0
                if "v" in node:
                    qi, _ = a2q_int_weights(
                        {"v": node["v"], "t": node["t"], "d": node["d"]},
                        q.weight_bits, q.acc_bits, q.act_bits, False,
                    )
                    sparsity = int((qi == 0).sum()) / qi.numel()
                geoms.append(LayerGeometry(
                    k=int(k), c_out=int(co), macs=int(k * co * spatial),
                    weight_bits=q.weight_bits, input_bits=q.act_bits,
                    output_bits=q.act_bits, acc_bits=q.acc_bits, sparsity=sparsity,
                ))
            else:
                for v in node.values():
                    walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    with torch.no_grad():
        walk(params)
    return geoms
