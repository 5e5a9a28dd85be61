"""tpu_dra_torch.parallel — single-device serving and training in PyTorch.

Counterpart of `tpu_dra.parallel` for the modules ported so far; each file
here is held against the JAX file of the same name by the
``tests/test_torch_*.py`` parity tests.
"""
