"""Hand-written CUDA kernels of the port, their plain PyTorch versions, and
the wrappers (:mod:`repro_torch.kernels.ops`) that pick between them by the
tensor's device."""
