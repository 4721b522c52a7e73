"""Environments: batched on-device envs + wrappers.

``make(name, num_envs)`` builds the canonical wrapped/vectorized stack
for a named environment. Ported so far: ``CartPole-v1`` and
``PongTPU-v0``.
"""

from actor_critic_algs_on_tensorflow_tpu_torch.envs.cartpole import (  # noqa: F401
    CartPole,
    CartPoleParams,
)
from actor_critic_algs_on_tensorflow_tpu_torch.envs.core import (  # noqa: F401
    Box,
    Discrete,
    Env,
)
from actor_critic_algs_on_tensorflow_tpu_torch.envs.pong import (  # noqa: F401
    PongParams,
    PongTPU,
)
from actor_critic_algs_on_tensorflow_tpu_torch.envs.wrappers import (  # noqa: F401
    AutoReset,
    EpisodeStats,
    FrameStack,
    VecEnv,
    Wrapper,
)

_REGISTRY = {
    "CartPole-v1": CartPole,
    "PongTPU-v0": PongTPU,
}


def make(name: str, num_envs: int = 1, *, frame_stack: int = 0, params=None):
    """Build ``VecEnv(EpisodeStats(AutoReset([FrameStack(env)])))``.

    Returns ``(vec_env, params)``.
    """
    if name not in _REGISTRY:
        raise KeyError(
            f"env {name!r} is not yet ported to the PyTorch package; "
            f"ported: {sorted(_REGISTRY)}"
        )
    env = _REGISTRY[name]()
    if params is None:
        params = env.default_params()
    if frame_stack and frame_stack > 1:
        env = FrameStack(env, frame_stack)
    return VecEnv(EpisodeStats(AutoReset(env)), num_envs), params
