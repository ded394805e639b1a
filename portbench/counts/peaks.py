"""Published dense peaks of one NVIDIA H100 SXM 80GB (HBM3), at its full
700 W power limit (NVIDIA's data sheet; no sparsity). A card set to a lower
limit runs slower under load: every result names the card's power limit
beside the shares computed from these."""

TENSOR_CORE_FLOPS = {"tf32": 495e12, "bf16": 989e12, "fp16": 989e12, "fp8": 1979e12}
# the tensor-core route of a layer whose multiplicands are in this precision
# (fp32 layers: their products at fp32 accuracy run fastest on the TF32 path)
ROUTE = {"fp32": "tf32", "tf32": "tf32", "bf16": "bf16", "fp16": "fp16", "fp8": "fp8"}
HBM_BYTES_PER_S = 3.35e12
BYTES = {"fp32": 4, "tf32": 4, "bf16": 2, "fp16": 2, "fp8": 1}


def peak_flops(precision: str) -> float:
    """The tensor-core peak a layer of ``precision`` multiplicands is held to."""
    return TENSOR_CORE_FLOPS[ROUTE[precision]]
