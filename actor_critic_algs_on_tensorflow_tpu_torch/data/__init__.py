"""On-policy trajectory containers and minibatch helpers."""

from actor_critic_algs_on_tensorflow_tpu_torch.data.rollout import (  # noqa: F401
    Trajectory,
    env_block_starts,
    flatten_time_batch,
    minibatch_iter_indices,
    take_minibatch,
)
