"""Model zoo used by the tests and the chip smoke run."""

from bagua_tpu_torch.models.mlp import init_mlp, mlp_apply  # noqa: F401
