from repro_torch import registry
from repro_torch.envs import cartpole, cheetah, pendulum
from repro_torch.envs.base import (  # noqa: F401
    Env,
    auto_reset,
    auto_reset_batch,
    select_reset_batch,
)
from repro_torch.envs.vector import VectorEnv  # noqa: F401

registry.register("env", "pendulum", pendulum.make)
registry.register("env", "cartpole", cartpole.make)
registry.register("env", "cheetah", cheetah.make)


def make(name: str, **kwargs) -> Env:
    """Build a registered env; ``kwargs`` go to its ``make``."""
    return registry.make("env", name, **kwargs)
