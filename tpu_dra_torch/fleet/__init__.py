"""The fleet side of the port: the prefix digest a replica publishes
(`digest.py`), the port's own copy of `tpu_dra.fleet.digest`."""
