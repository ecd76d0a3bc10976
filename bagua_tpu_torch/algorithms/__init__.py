"""Algorithm registry (the port of ``bagua_tpu/algorithms/__init__.py``)."""

from bagua_tpu_torch.algorithms.base import (  # noqa: F401
    Algorithm,
    AlgorithmImpl,
    GlobalAlgorithmRegistry,
    StepContext,
)
from bagua_tpu_torch.algorithms.bytegrad import (  # noqa: F401
    ByteGradAlgorithm,
    ByteGradAlgorithmImpl,
)
from bagua_tpu_torch.algorithms.gradient_allreduce import (  # noqa: F401
    GradientAllReduceAlgorithm,
    GradientAllReduceAlgorithmImpl,
)

GlobalAlgorithmRegistry.register(
    "gradient_allreduce",
    GradientAllReduceAlgorithm,
    "centralized synchronous full-precision gradient allreduce",
)
GlobalAlgorithmRegistry.register(
    "bytegrad",
    ByteGradAlgorithm,
    "centralized synchronous 8-bit compressed gradient allreduce",
)
