"""The all-finite guard reached by ``algos.common.guard_metrics``.

Counterpart of ``all_finite`` in the JAX package's ``utils/health.py``.
The snapshot ring, trajectory validator and divergence detector wait
for a later slice.
"""

from __future__ import annotations

from typing import Any, Iterator

import torch


def tensor_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """Every tensor in a nest of tuples, lists, dicts and modules."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)


def all_finite(tree: Any) -> torch.Tensor:
    """Scalar ``bool`` tensor: every floating tensor of ``tree`` is finite.

    One reduction per tensor and one ``all`` over them, on the tensors'
    device: no host sync. Integer and bool tensors are finite by
    construction and skipped.
    """
    bits = [
        torch.isfinite(x.detach()).all()
        for x in tensor_leaves(tree)
        if x.is_floating_point()
    ]
    if not bits:
        return torch.tensor(True)
    return torch.stack(bits).all()
