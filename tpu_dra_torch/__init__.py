"""tpu_dra_torch — the compute stack of `tpu_dra` ported to PyTorch and CUDA.

The JAX package `tpu_dra` stays the reference.  This package mirrors its
file paths (``tpu_dra_torch/parallel/decode.py`` is the counterpart of
``tpu_dra/parallel/decode.py``) and imports nothing from it, nor JAX: a
GPU host needs neither.  Every TPU kernel on a ported path is a kernel
written by hand for Hopper, with a plain PyTorch version beside it.

Ported so far, on one device: serving of the burn-in LM, greedy or
sampled (bf16, or int8 weights and an int8 KV cache; the paged layout,
one engine or a prefill and a decode tier, or the rows layout, which
the MoE family serves on), and training of its dense, flash, rope and
MoE families —

- ``tpu_dra_torch.parallel.burnin``  — config, params, forward, training step;
- ``tpu_dra_torch.parallel.weights`` — the JAX param tree and training state
  as torch tensors;
- ``tpu_dra_torch.parallel.quant``   — int8 weights and their dequantization;
- ``tpu_dra_torch.parallel.moe``     — the switch-routed expert MLP;
- ``tpu_dra_torch.parallel.decode``  — the KV-cache decode step and the
  generation factories;
- ``tpu_dra_torch.parallel.paged``   — the paged block pool and its prefill;
- ``tpu_dra_torch.parallel.prng``    — JAX's Threefry keys and draws, bit for bit;
- ``tpu_dra_torch.parallel.speculative`` — speculative decoding;
- ``tpu_dra_torch.parallel.serve``   — the continuous-batching engine (paged
  or rows), its warm restart and the surface a fleet calls;
- ``tpu_dra_torch.parallel.prefixcache``, ``swap`` — the shared-prefix
  cache and the host swap tier;
- ``tpu_dra_torch.parallel.disagg``  — the disaggregated prefill/decode server;
- ``tpu_dra_torch.fleet.digest``     — the prefix digest a replica publishes;
- ``tpu_dra_torch.parallel.ring``    — the reference attention (the oracle);
- ``tpu_dra_torch.parallel.flash``   — flash attention with its gradient;
- ``tpu_dra_torch.parallel.kernels`` — the paged-attention (bf16 and int8
  pools) and flash-attention CUDA kernels;
- ``tpu_dra_torch.parallel.mfu``     — sizing, flop counts and MFU;
- ``tpu_dra_torch.models``           — the workload families' training and
  serving acceptance.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; asking for CUDA where there is none raises.
"""
