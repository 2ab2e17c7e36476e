from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
