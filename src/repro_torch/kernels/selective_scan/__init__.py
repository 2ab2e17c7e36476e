from repro_torch.kernels.selective_scan.ops import (  # noqa: F401
    selective_scan,
    selective_scan_cuda,
)
from repro_torch.kernels.selective_scan.ref import (  # noqa: F401
    selective_scan_ref,
)
