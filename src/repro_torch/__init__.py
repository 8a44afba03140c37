"""PyTorch/CUDA port of the MoE serving system.

A second package beside the JAX reference ``repro``, with the same module
layout (``configs/``, ``models/``, ``kernels/``, ``serving/``, ``launch/``)
so every ported file sits at the relative path of the file it is checked
against. It imports ``torch`` and numpy only: nothing of JAX and nothing of
the JAX package (it keeps its own copies of what it needs).

The two TPU kernels of the serving hot path (``moe_gmm`` and
``decode_attn``) are hand-written CUDA C++ for Hopper (``kernels/csrc``),
built with ``nvcc`` at first use and bound with ``ctypes``. Their wrappers
take a plain PyTorch version for CPU tensors only; on a CUDA tensor they
launch the kernel or raise.

Entry points (``Model``, ``ContinuousEngine``, ``launch/serve.py``) run on
the card (``device="cuda"``) unless the caller asks for ``device="cpu"``.
"""
