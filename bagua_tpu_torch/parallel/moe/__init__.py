"""Expert-parallel Mixture of Experts (the port of ``bagua_tpu/parallel/moe``)."""

from bagua_tpu_torch.parallel.moe.routing import (  # noqa: F401
    Routing,
    expert_capacity,
    route_top1,
    route_top2,
)
from bagua_tpu_torch.parallel.moe.layer import (  # noqa: F401
    Experts,
    ExpertParallelFFN,
    MoE,
    Router,
)
from bagua_tpu_torch.parallel.moe.utils import is_moe_param  # noqa: F401
