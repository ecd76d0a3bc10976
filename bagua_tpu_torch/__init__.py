"""bagua_tpu_torch: the PyTorch/CUDA port of bagua_tpu.

The same data-parallel engine, algorithms and bucketed exchange, on
rank-stacked PyTorch tensors, with the JAX package's Pallas kernels written
by hand in CUDA for Hopper (``kernels/csrc``).  It imports neither JAX nor
``bagua_tpu``.
"""

from bagua_tpu_torch.version import __version__  # noqa: F401
from bagua_tpu_torch.defs import ReduceOp  # noqa: F401
from bagua_tpu_torch.communication import (  # noqa: F401
    BaguaProcessGroup,
    allgather,
    allreduce,
    alltoall,
    get_default_group,
    init_process_group,
    reduce_scatter,
)
