"""PyTorch/CUDA port of the exact NN-DTW search system in ``repro`` and of
its LM serving substrate.

Mirrors the JAX package's layout (``core/``, ``kernels/``, ``search/``,
``data/``, ``configs/``, ``models/``, ``serve/``) so that every module
here has one counterpart there.  The
package imports ``torch`` and never ``jax``; its CUDA kernels
(``csrc/*.cu``) are built with ``nvcc`` at first use, so importing it needs
neither a card nor a compiler.

Device rule: the entry points run on the card unless the caller asks for
the CPU.  ``build_index(..., device=None)`` means ``"cuda"`` and raises on
a machine with no card; ``nn_search``, ``classify`` and ``brute_force``
run on the index's device.  On a CPU tensor each kernel wrapper in
``kernels/ops.py`` runs the kernel's plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.  The LM entry points
(``models.LM``, ``serve.greedy_decode``) run where their parameters
live: ``LM.init`` and ``models.lm_params_from_numpy`` default to CUDA.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
