"""Policy/value networks: MLP and Nature-CNN torsos, discrete actor-critic."""

from actor_critic_algs_on_tensorflow_tpu_torch.models.networks import (  # noqa: F401
    DiscreteActorCritic,
    MLPTorso,
    NatureCNN,
)
