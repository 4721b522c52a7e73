"""Ops: the backward linear scan (CUDA kernel), GAE, distributions, losses."""

from actor_critic_algs_on_tensorflow_tpu_torch.ops.distributions import (  # noqa: F401
    Categorical,
    DiagGaussian,
)
from actor_critic_algs_on_tensorflow_tpu_torch.ops.gae import (  # noqa: F401
    discounted_returns,
    gae_advantages,
)
from actor_critic_algs_on_tensorflow_tpu_torch.ops.linear_scan import (  # noqa: F401
    linear_backward_scan,
    linear_backward_scan_reference,
)
from actor_critic_algs_on_tensorflow_tpu_torch.ops.losses import (  # noqa: F401
    PPOStats,
    clipped_value_loss,
    normalize_advantages,
    ppo_clip_loss,
    value_loss,
)
