"""Hyperparameter (autotune) service.

A copy of the JAX package's service (the analog of the reference's ``bagua/service/`` tier): a rank-0 HTTP
service searching over communication hyperparameters (bucket size,
hierarchical reduction) to maximize reported training speed.  The reference
uses Flask + gevent + scikit-optimize; this build uses the Python stdlib
HTTP server and a small numpy Gaussian-process Bayesian optimizer, keeping
the same REST API surface (``register_tensors`` / ``report_metrics`` /
``ask_hyperparameters`` / ``report_tensor_execution_order`` /
``health_check``, reference ``service/autotune_service.py:154-298``).
"""

from bagua_tpu_torch.service.autotune_service import (  # noqa: F401
    AutotuneService,
    start_autotune_server,
)
from bagua_tpu_torch.service.autotune_client import (  # noqa: F401
    AutotuneClient,
    get_hyperparameters_service_client,
)
from bagua_tpu_torch.service.bayesian_optimizer import (  # noqa: F401
    IntParam,
    BoolParam,
    BayesianOptimizer,
)
from bagua_tpu_torch.service.planner import (  # noqa: F401
    AlphaBeta,
    BucketPlanner,
    CostModel,
    PlanResult,
    WireSample,
    fit_alpha_beta,
)
