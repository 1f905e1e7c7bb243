"""Device selection and the fp32 parity settings.

Every entry point of the port takes ``device=`` and defaults to ``"cuda"``.
There is no silent CPU fallback: asking for CUDA on a machine without a GPU
raises, and the CPU runs only when the caller passes ``device="cpu"`` (as
the tests do).

Parity mode is fp32 with TF32 off.  PyTorch's float32 matmuls already run
in full fp32 by default, but cuDNN convolutions default to TF32
(``torch.backends.cudnn.allow_tf32 = True``), which keeps ~3 decimal digits
and breaks parity with the reference's ``Precision.HIGHEST`` contractions.
Both switches are set explicitly whenever a CUDA device is resolved.
"""
from __future__ import annotations

import torch


def set_parity_mode() -> None:
    """fp32 everywhere: no TF32 in cuBLAS matmuls or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """-> torch.device; raises for CUDA when no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but torch.cuda is not "
                "available; pass device='cpu' to run on the CPU")
        set_parity_mode()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


def as_rows(x, device="cuda") -> torch.Tensor:
    """(N, ...) numpy or tensor -> (N, d) float32 tensor.  A tensor stays on
    its own device; numpy goes to `device` (resolved by the rule above)."""
    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    return x.reshape(x.shape[0], -1)


def synchronize(device: torch.device) -> None:
    """Stage-boundary sync: waits for queued CUDA work; no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
