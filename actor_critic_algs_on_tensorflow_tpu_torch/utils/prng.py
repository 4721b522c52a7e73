"""Seeded ``torch.Generator`` discipline.

Counterpart of the JAX package's ``utils/prng.py``. JAX keeps one root
key per run and folds integer coordinates into it; here a run keeps one
integer seed, :func:`fold` derives a new seed from it and some integer
coordinates (iteration, purpose), and :func:`generator` makes a
generator on the device that draws from it. The derivation is a pure
function of its integers, so a run is reproducible across restarts.
Torch's Philox never draws JAX's threefry numbers: the two packages
agree in distribution, not in bits.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold(seed: int, *data: int) -> int:
    """Fold one or more integers into a seed; returns a 63-bit seed."""
    x = _splitmix64(int(seed) & _MASK64)
    for d in data:
        x = _splitmix64(x ^ (int(d) & _MASK64))
    return x >> 1


def generator(seed: int, device: torch.device | str = "cpu") -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g
