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

With TF32 off, cuDNN's first heuristic pick for the conv VAE's float32
backward passes is its legacy ``dgrad_engine``/``wgrad_alg0_engine``,
which run the same work at a fraction of the implicit-GEMM forward's rate.
``measured_conv_engines`` lets cuDNN time its leading candidate engines
once per conv shape and layout instead, for a float32 fit in one process,
without touching precision.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch


def set_parity_mode() -> None:
    """fp32 everywhere: no TF32 in cuBLAS matmuls or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# Candidate engines cuDNN times for each conv pass, in its heuristics'
# order.  At the conv VAE's float32 shapes at batch 64 on an H100 (cuDNN
# 9.2), timing all ten of torch's default gave 14.71-14.88 ms a step and
# 7 s of first calls; four gave 14.74-14.82 ms and 0.9 s; three gave
# 15.92-16.02 ms, the heuristic pick's time (PERF.md §6).  The winner
# is the fourth candidate, so after a cuDNN upgrade time the step under
# three, four and ten again before keeping this number.
TIMED_ENGINES = 4


@contextlib.contextmanager
def measured_conv_engines(compute_dtype: Optional[str] = "float32",
                          mesh=None) -> Iterator[None]:
    """cuDNN chooses each convolution pass's engine by timing its first
    ``TIMED_ENGINES`` candidates (``torch.backends.cudnn.benchmark``), once
    per shape and layout.  torch keeps one plan a shape, dtype, layout,
    ``deterministic`` and TF32 setting for the process, whatever this flag
    was when it was chosen: a shape that already ran keeps its plan, and a
    plan timed here serves that shape after the scope too.  Only for a
    float32 fit (`compute_dtype` None or "float32") in one process
    (`mesh` None) whose caller left ``deterministic`` off: that is the
    traffic measured to gain.  Elsewhere it sets nothing, and a shape not
    timed before in the process runs cuDNN's heuristic pick: a
    deterministic caller wants the engines it repeats on, bf16 has exact
    goldens certified on those engines, and on a mesh ranks that share a
    data index compute the replicated layers' gradients apart and must not
    time their way to different engines.  TF32 stays as the caller set it;
    the two flags set here are restored on exit, on an exception too.
    Flags only: on the CPU it changes nothing."""
    cudnn = torch.backends.cudnn
    if compute_dtype not in (None, "float32") or mesh is not None \
            or cudnn.deterministic:
        yield
        return
    saved = cudnn.benchmark, cudnn.benchmark_limit
    cudnn.benchmark, cudnn.benchmark_limit = True, TIMED_ENGINES
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.benchmark_limit = saved


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
