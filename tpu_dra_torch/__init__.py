"""tpu_dra_torch — the compute stack of `tpu_dra` ported to PyTorch and CUDA.

The JAX package `tpu_dra` stays the reference.  This package mirrors its
file paths (``tpu_dra_torch/parallel/decode.py`` is the counterpart of
``tpu_dra/parallel/decode.py``) and imports nothing from it, nor JAX: a
GPU host needs neither.  Every TPU kernel on a ported path is a kernel
written by hand for Hopper, with a plain PyTorch version beside it.

Ported so far: greedy paged serving of the dense burn-in LM on one
device —

- ``tpu_dra_torch.parallel.burnin``  — config, params and the dense forward;
- ``tpu_dra_torch.parallel.weights`` — the JAX param tree as torch tensors;
- ``tpu_dra_torch.parallel.decode``  — the KV-cache decode step;
- ``tpu_dra_torch.parallel.paged``   — the paged block pool and its prefill;
- ``tpu_dra_torch.parallel.kernels`` — the paged-attention CUDA kernel;
- ``tpu_dra_torch.parallel.serve``   — the continuous-batching engine.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; asking for CUDA where there is none raises.
"""
