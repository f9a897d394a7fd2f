"""egnn_tpu_torch — the PyTorch/CUDA port of egnn_tpu, for NVIDIA Hopper.

The same E(n)-equivariant graph networks as the JAX package ``egnn_tpu``
(the reference egnn-pytorch's dense path, Satorras, Hoogeboom, Welling 2021,
arXiv:2102.09844), written in PyTorch, with the TPU's Pallas kernels
replaced by kernels written by hand for the H100 (``csrc/``). Entry points
run on CUDA unless given ``device="cpu"``; on the CPU every kernel is
replaced by its plain PyTorch version.

Ported so far: the serving forward of ``EGNNNetwork`` with kNN
neighbourhoods at any n (the exact full-band selection up to 16384 nodes,
the j-tiled exact selection and the packed-key candidates with their exact
refine beyond), and its denoising train step (``egnn_tpu_torch.training``:
``masked_mse``, ``make_fused_adam``, ``make_adam``, ``TrainState``,
``make_denoise_train_step``, as in ``egnn_tpu.training``); see ROADMAP.md
for what is still to be ported.
"""

from .models.egnn import EGNN, EGNN_Network, EGNNNetwork

__version__ = "0.1.0"

__all__ = ["EGNN", "EGNNNetwork", "EGNN_Network"]
