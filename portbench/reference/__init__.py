"""The plain reference of each configuration family, written from the
published equations in plain PyTorch: no kernel, no cache, no batching trick
of the program under test. It imports nothing of the program (nor ``jax``).

A family module (``dense_knn.py``, ``sparse_qm9.py``) gives
``param_shapes(cfg)``, the named parameters with their shapes and how the
benchmark draws them, and the forward and train readings that the harness
compares with the program's. Parameters are plain tensors in a dict keyed by
the published names, weights stored (in, out).
"""
