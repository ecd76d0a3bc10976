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


def _zero_factory(**kwargs):
    # Imported lazily: bagua_tpu_torch.sharded.algorithm imports this
    # package's modules, so an eager import here would be circular.
    from bagua_tpu_torch.sharded.algorithm import ZeroAlgorithm

    return ZeroAlgorithm(**kwargs)


GlobalAlgorithmRegistry.register(
    "zero",
    _zero_factory,
    "ZeRO-sharded exchange: reduce-scatter grads, shard-only optimizer "
    "update, deferred all-gather into the next step",
)


def build_algorithm(name: str, lr: float = 1e-3, qadam_warmup_steps: int = 10, **kwargs) -> Algorithm:
    """Construct any registered algorithm by name, as the JAX package's
    ``build_algorithm`` does for benches and tests.  ``lr`` and ``qadam_warmup_steps``
    configure QAdam's bundled optimizer there; QAdam is not ported, so
    ``"qadam"`` raises the registry's KeyError and they are not read."""
    return Algorithm.init(name, **kwargs)
