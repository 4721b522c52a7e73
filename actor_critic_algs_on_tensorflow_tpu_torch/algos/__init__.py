"""Algorithms: PPO (feed-forward) and the shared on-policy machinery."""
