"""Weight transplant from the JAX package's Flax params to the port.

``from_flax`` turns a ``DiscreteActorCritic`` Flax param tree, given as
nested dicts of numpy arrays, into a ``state_dict`` for the port's
``models.DiscreteActorCritic``:

  * Dense ``kernel [in, out]`` becomes Linear ``weight [out, in]``;
  * Conv ``kernel [kh, kw, in, out]`` (HWIO) becomes ``[out, in, kh, kw]``
    (OIHW);
  * biases are copied as they are.

The Nature-CNN flatten needs no row permutation: the port flattens its
conv output in NHWC order, as Flax does (see ``models.NatureCNN``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_TORSOS = {"NatureCNN_0": "torso", "MLPTorso_0": "torso"}
_HEADS = {"Dense_0": "logits", "Dense_1": "value"}


def _layer(name: str, leaf: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(leaf["kernel"], dtype=np.float32)
    if kernel.ndim == 4:
        weight = kernel.transpose(3, 2, 0, 1)
    elif kernel.ndim == 2:
        weight = kernel.T
    else:
        raise ValueError(f"{name}: kernel of rank {kernel.ndim}")
    return {
        f"{name}.weight": torch.tensor(weight),
        f"{name}.bias": torch.tensor(np.asarray(leaf["bias"], np.float32)),
    }


def _torso_layer(flax_name: str) -> str:
    kind, index = flax_name.rsplit("_", 1)
    if kind == "Conv":
        return f"convs.{index}"
    if kind == "Dense":
        return f"layers.{index}"
    raise ValueError(f"unexpected torso layer {flax_name!r}")


def from_flax(params_numpy: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for ``models.DiscreteActorCritic`` from Flax params.

    Accepts the tree as ``model.init`` returns it (``{"params": ...}``)
    or its inner ``params`` dict. For the Nature-CNN torso the dense
    layer after the convs is ``torso.dense``.
    """
    tree = params_numpy.get("params", params_numpy)
    out: Dict[str, torch.Tensor] = {}
    for key, sub in tree.items():
        if key in _HEADS:
            out.update(_layer(_HEADS[key], sub))
        elif key in _TORSOS:
            cnn = key == "NatureCNN_0"
            for layer_name, leaf in sub.items():
                if cnn and layer_name == "Dense_0":
                    target = "torso.dense"
                else:
                    target = f"torso.{_torso_layer(layer_name)}"
                out.update(_layer(target, leaf))
        else:
            raise ValueError(f"no transplant rule for Flax module {key!r}")
    return out
