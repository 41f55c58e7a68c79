"""PyTorch/CUDA port of the multi-level training and serving system.

The JAX package ``repro`` is the reference; this package mirrors its layout
module for module (``repro_torch/layers/attention.py`` is the counterpart of
``repro/layers/attention.py``) and replaces each Pallas TPU kernel with a
hand-written CUDA kernel for Hopper (``csrc/``).  Parameters are the same
nested dict of tensors, with the same leaf names and stacked ``layers`` axis,
so weights cross between the packages through :mod:`repro_torch.bridge`.

Ported so far: paged greedy serving of decoder LMs with attention mixers and
dense FFNs (``launch/serve.py``), on the flash-prefill and paged-decode
kernels; the paper's multi-level training (``core/vcycle.py``) of decoder
LMs, BERT encoders and DeiT, its five comparison baselines
(``core/baselines.py``) and the energy model (``core/flops.py``).
"""
