from repro_torch.optim.adam import AdamState, adam, apply_updates  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm, global_norm  # noqa: F401
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    cosine_decay,
    linear_warmup_cosine,
)
from repro_torch.optim.sgd import SgdState, sgd  # noqa: F401
