"""The device the port's entry points run on.

Every entry point (``DeepBedMap``, ``models.build_generator``,
``inference.continent.predict_continent``) defaults to ``"cuda"``: the card is
what the port is for. On a machine without CUDA such a call raises instead of
carrying on on the CPU; the CPU is used only when the caller asks for it with
``device="cpu"`` (as the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is
    no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def disable_tf32() -> None:
    """Turn TF32 off for cuDNN convs and cuBLAS matmuls, which PyTorch runs in
    TF32 by default. The hand-written kernels compute in 3xTF32 to match the
    fp32 reference; the library convs around them (input block, pre/post-
    residual and upsample convs, the tail's offset convs) must run in fp32 as
    well, or the DEMs differ from the reference's. The library leaves this
    process-wide setting to its caller; the port's programs (the CLI,
    ``serve.serve_forever``) call this first."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
