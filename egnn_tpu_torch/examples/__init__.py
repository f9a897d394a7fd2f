"""The port's trainers, run as modules: ``python -m
egnn_tpu_torch.examples.denoise`` and ``python -m
egnn_tpu_torch.examples.molecule_regression``."""
