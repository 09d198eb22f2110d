"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, no
sparsity), at its full power limit of 700 W. A card set below it runs
slower, so every share of these carries the card's limit beside it."""

DEVICE = "NVIDIA H100 SXM (80 GB HBM3), 700 W"
MATMUL_OPS_PER_S = {"bfloat16": 989e12,   # dense bf16 tensor cores
                    "float16": 989e12,
                    "float32": 67e12}     # CUDA cores (TF32 off)
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops, nbytes, dtype_name):
    """The least time the card could take: the larger of operations over
    the peak rate for ``dtype_name`` and bytes over HBM bandwidth."""
    return max(ops / MATMUL_OPS_PER_S[dtype_name], nbytes / HBM_BYTES_PER_S)
