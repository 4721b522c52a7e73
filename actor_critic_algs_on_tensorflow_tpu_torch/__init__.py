"""PyTorch/CUDA port of ``actor_critic_algs_on_tensorflow_tpu``.

The JAX package stays the reference; this package keeps its subpackage
layout and module names (``ops/``, ``envs/``, ``models/``, ``data/``,
``algos/``, ``utils/``, ``cli/``) so each module's counterpart is found
at the same relative path. It imports ``torch`` and ``numpy`` only.

Its entry points run on ``cuda`` unless the caller passes
``device="cpu"``. The one TPU kernel of the reference, the backward
linear recurrence of ``ops/pallas_scan.py``, is a hand-written CUDA
kernel here (``csrc/linear_backward_scan.cu``), built with ``nvcc`` at
first use into the package's ``build/`` directory.
"""

__version__ = "0.1.0"
