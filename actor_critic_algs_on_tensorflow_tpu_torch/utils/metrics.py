"""Metric fetch and formatting reached by ``algos.common.run_loop``.

Counterpart of ``device_get_metrics`` and ``format_metrics`` in the JAX
package's ``utils/metrics.py``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


def fetch_metrics(metrics: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """One host transfer for the whole dict of 0-dim metric tensors."""
    stacked = torch.stack(
        [v.detach().reshape(()).to(torch.float64) for v in metrics.values()]
    )
    return dict(zip(metrics.keys(), stacked.cpu().tolist()))


def format_metrics(step: int, metrics: Mapping[str, float]) -> str:
    parts = [f"step={step}"]
    for k in sorted(metrics):
        v = metrics[k]
        parts.append(f"{k}={v:.4g}")
    return " ".join(parts)
