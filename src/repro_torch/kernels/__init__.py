"""Hand-written CUDA kernels of the search path and of the LM substrate,
their plain PyTorch versions (``ref``) and the device dispatch
(``ops``).

The seven ``*_op`` dispatchers of ``ops`` are re-exported here, as
``repro.kernels`` does, but loaded on first access: importing this
package loads no kernel module (the kernels build at first launch, on a
machine with ``nvcc``).
"""

__all__ = [
    "dtw_band_op",
    "envelope_op",
    "flash_attention_op",
    "lb_enhanced_op",
    "lb_enhanced_pairwise_op",
    "lb_keogh_op",
    "mamba_scan_op",
]


def __getattr__(name: str):
    if name in __all__:
        from repro_torch.kernels import ops

        return getattr(ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + __all__)
