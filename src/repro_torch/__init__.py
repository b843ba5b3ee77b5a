"""PyTorch + CUDA port of the BitDistill serving path (the JAX package
``repro`` is the reference).

Module paths and names mirror ``repro`` so each port module's counterpart is
found by path: ``repro_torch/nn/attention.py::Attention.decode_chunk`` is
``repro/nn/attention.py::Attention.decode_chunk``.  The package imports
torch and numpy only — never jax, never ``repro``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; asking for ``cuda``
without a card raises (see :func:`repro_torch.nn.module.resolve_device`).
"""
