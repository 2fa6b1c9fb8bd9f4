"""ROCKET core runtime of the port: policy, latency model, copy engine,
buffer pools, request dispatcher, and the torch host→device transfer
engine (:mod:`repro_torch.core.engine`).  Import the submodules directly.
"""
