"""tpu_dra_torch — the compute stack of `tpu_dra` ported to PyTorch and CUDA.

The JAX package `tpu_dra` stays the reference.  This package mirrors its
file paths (``tpu_dra_torch/parallel/decode.py`` is the counterpart of
``tpu_dra/parallel/decode.py``) and imports nothing from it, nor JAX: a
GPU host needs neither.  Every TPU kernel on a ported path is a kernel
written by hand for Hopper, with a plain PyTorch version beside it.

Ported so far: greedy paged serving of the dense burn-in LM (bf16, or
int8 weights and an int8 KV pool), and training of its dense, flash and
rope families, on one device —

- ``tpu_dra_torch.parallel.burnin``  — config, params, forward, training step;
- ``tpu_dra_torch.parallel.weights`` — the JAX param tree and training state
  as torch tensors;
- ``tpu_dra_torch.parallel.quant``   — int8 weights and their dequantization;
- ``tpu_dra_torch.parallel.decode``  — the KV-cache decode step;
- ``tpu_dra_torch.parallel.paged``   — the paged block pool and its prefill;
- ``tpu_dra_torch.parallel.serve``   — the continuous-batching engine;
- ``tpu_dra_torch.parallel.ring``    — the reference attention (the oracle);
- ``tpu_dra_torch.parallel.flash``   — flash attention with its gradient;
- ``tpu_dra_torch.parallel.kernels`` — the paged-attention (bf16 and int8
  pools) and flash-attention CUDA kernels;
- ``tpu_dra_torch.parallel.mfu``     — sizing, flop counts and MFU;
- ``tpu_dra_torch.models``           — the workload families' training.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; asking for CUDA where there is none raises.
"""
