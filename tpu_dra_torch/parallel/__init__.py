"""tpu_dra_torch.parallel — serving, training and slice validation in PyTorch.

Counterpart of `tpu_dra.parallel` for the modules ported so far; each file
here is held against the JAX file of the same name by the
``tests/test_torch_*.py`` parity tests.  Exported here, as the reference
exports them: the meshes over a slice's ranks (`mesh`), the collective
checks (`collectives`), the slice burn-in (`validate`), the burn-in
trainer (`burnin`) and its stream-fed loop (`data`).
"""

from tpu_dra_torch.parallel.mesh import (
    logical_mesh,
    slice_mesh,
    topology_from_env,
)
from tpu_dra_torch.parallel.collectives import (
    CollectiveReport,
    all_gather_check,
    hierarchical_psum,
    hierarchical_psum_check,
    psum_bandwidth,
    psum_check,
    ring_check,
)
from tpu_dra_torch.parallel.validate import SliceReport, validate_slice
from tpu_dra_torch.parallel.burnin import BurninConfig, TrainReport, train
from tpu_dra_torch.parallel.data import (
    prefetch_to_device,
    synthetic_stream,
    train_on_stream,
)

__all__ = [
    "BurninConfig",
    "CollectiveReport",
    "SliceReport",
    "TrainReport",
    "all_gather_check",
    "hierarchical_psum",
    "hierarchical_psum_check",
    "logical_mesh",
    "prefetch_to_device",
    "psum_bandwidth",
    "psum_check",
    "ring_check",
    "slice_mesh",
    "synthetic_stream",
    "topology_from_env",
    "train",
    "train_on_stream",
    "validate_slice",
]
