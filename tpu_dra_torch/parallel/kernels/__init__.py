"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.  CUDA sources live in ``csrc/`` and are built at first
use (`_build`)."""

from tpu_dra_torch.parallel.kernels.flash_attn import (
    flash_attention_forward,
    flash_attention_plain,
)
from tpu_dra_torch.parallel.kernels.paged_attn import (
    paged_attention,
    paged_attention_plain,
)

__all__ = [
    "flash_attention_forward",
    "flash_attention_plain",
    "paged_attention",
    "paged_attention_plain",
]
