"""PyTorch/CUDA port of the Unicron reproduction (``repro`` is the JAX
reference).  Modules mirror ``repro``'s layout one for one; the port
imports torch, numpy and the standard library only.
"""
