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
from bagua_tpu_torch.algorithms.decentralized import (  # noqa: F401
    DecentralizedAlgorithm,
    DecentralizedAlgorithmImpl,
    LowPrecisionDecentralizedAlgorithm,
    LowPrecisionDecentralizedAlgorithmImpl,
)
from bagua_tpu_torch.algorithms.gradient_allreduce import (  # noqa: F401
    GradientAllReduceAlgorithm,
    GradientAllReduceAlgorithmImpl,
)
from bagua_tpu_torch.algorithms.q_adam import (  # noqa: F401
    QAdamAlgorithm,
    QAdamAlgorithmImpl,
    QAdamOptimizer,
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

GlobalAlgorithmRegistry.register(
    "decentralized",
    DecentralizedAlgorithm,
    "decentralized synchronous full-precision peer weight averaging",
)
GlobalAlgorithmRegistry.register(
    "low_precision_decentralized",
    LowPrecisionDecentralizedAlgorithm,
    "decentralized synchronous 8-bit compressed ring weight exchange",
)
GlobalAlgorithmRegistry.register(
    "qadam",
    QAdamAlgorithm,
    "centralized synchronous quantized-momentum Adam",
)


class NoCommAlgorithm(Algorithm):
    """No communication: every stage is the identity.  For an optimizer
    that owns its communication, or to debug one rank's math inside the
    distributed engine: the ranks train apart."""

    def reify(self, process_group) -> AlgorithmImpl:
        return AlgorithmImpl(process_group)


GlobalAlgorithmRegistry.register(
    "none",
    NoCommAlgorithm,
    "no communication (optimizer-owned comm, or debugging)",
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
    ``build_algorithm`` does for benches and tests: ``"qadam"`` gets a
    ``QAdamOptimizer(lr=lr, warmup_steps=qadam_warmup_steps)`` unless
    ``q_adam_optimizer`` is given; no other algorithm reads the two."""
    if name == "qadam" and "q_adam_optimizer" not in kwargs:
        kwargs["q_adam_optimizer"] = QAdamOptimizer(lr=lr, warmup_steps=qadam_warmup_steps)
    return Algorithm.init(name, **kwargs)
