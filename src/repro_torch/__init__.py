"""PyTorch/CUDA port of the ROCKET reproduction, for one NVIDIA H100.

The package mirrors the layout of the JAX package (``configs``, ``core``,
``kernels``, ``models``, ``serve``, ``launch``) so each module's counterpart
is easy to find.  It imports ``torch`` and ``numpy`` only: the numpy-only
runtime modules it needs (configs, policy, copy engine, dispatcher,
tracing) are copies, never imports of the JAX package.

Entry points take ``device=`` and default to ``"cuda"``; asking for CUDA on
a host without it raises instead of falling back to the CPU.
"""
