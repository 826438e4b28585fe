"""PyTorch/CUDA port of dmm_net_tpu (differentiable mask matching for video
object segmentation), written for one NVIDIA H100.

The port keeps the JAX package's module names and public layouts (frames
(B, H, W, 3) uint8, masks (B, K, h, w), X (B, M, N), labels (B, H, W) uint8,
decoder state (B, M, H/32, W/32, F)) and runs NCHW inside. It imports
nothing of the JAX package: the modules it needs are copied here.

Numerics: float32 convolutions and matrix products run in full float32 on
the card. cuDNN would otherwise run float32 convolutions in TF32 (about
three decimal digits), which the float32 parity checks cannot absorb, so
both switches are set here, once, for the whole package:

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

The bfloat16 presets are unaffected: their convolutions run in bf16.
"""

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is requested (or defaulted) but missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
