from repro_torch.optim.adam import AdamState, adam, apply_updates  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm, global_norm  # noqa: F401
