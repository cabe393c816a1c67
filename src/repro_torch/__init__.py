"""A2Q (accumulator-aware quantization) in PyTorch for one NVIDIA H100.

The PyTorch port of ``repro``: the same configs, parameter trees and serving
semantics, with the TPU's Pallas kernels replaced by CUDA kernels written for
Hopper (``repro_torch/csrc``).  Entry points run on ``device="cuda"`` unless
the caller asks for the CPU; on the CPU every kernel wrapper runs its plain
PyTorch version instead.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a usable card
    raises instead of quietly running on the CPU.

    Resolving a CUDA device also turns TF32 off for fp32 matmuls and
    convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` set to False), so fp32 work on the
    card keeps full fp32 precision, as the reference computes it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
