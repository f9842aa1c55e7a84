"""BeyondFF on PyTorch and CUDA: the port of the JAX package ``beyondff_tpu``
to an NVIDIA H100.

The package mirrors the JAX package's layout (``config``, ``core``,
``kernels``, ``models``, ``pipeline``, ``utils``); every TPU kernel on a
ported path is a CUDA kernel written by hand for Hopper under ``csrc/``,
built at first use (``kernels/_build.py``). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
