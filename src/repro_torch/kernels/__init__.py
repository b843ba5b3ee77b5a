"""Hand-written Hopper kernels of the serving path, one package each
(kernel.py: the CUDA binding and launch counter; ref.py: the plain PyTorch
version; ops.py: CUDA tensors to the kernel, CPU tensors to the plain
version).  ``build.py`` compiles ``csrc/`` on first use."""
