from repro_torch.kernels.sum_tree.ops import (  # noqa: F401
    sumtree_find_batch,
    sumtree_update,
)
from repro_torch.kernels.sum_tree.ref import SumTree, sumtree_build  # noqa: F401
