"""The API types the port's compute stack reads: its own copy of the
jax-free parts of `tpu_dra.api` it needs (`topology.Topology`)."""
