"""The CoRaiS decision path in PyTorch: instances, policy, objective, decode
and the unified decision entry points (counterpart of ``repro.core``)."""
