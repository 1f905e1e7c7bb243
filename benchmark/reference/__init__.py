"""The plain reference: PyTorch and NumPy only, nothing of the port.
Float32 with TF32 off (``set_tf32(False)``); the control turns TF32 on."""
import torch


def set_tf32(on: bool) -> None:
    """TF32 in cuBLAS matmuls and cuDNN convolutions, on or off."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
