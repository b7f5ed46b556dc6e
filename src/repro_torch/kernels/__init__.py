"""Hand-written CUDA kernels of the search path and of the LM substrate,
their plain PyTorch versions (``ref``) and the device dispatch
(``ops``)."""
