"""Shared type definitions: the wire dtype names, the ``ReduceOp`` enum,
the tensor declarations exchanged with the bucket planner and the
hyperparameter record the autotune service proposes (the port of
``bagua_tpu/defs.py``, whose records are pydantic models; here they are
dataclasses with ``to_dict``/``from_dict``, and the JSON they make is the
pydantic models' ``model_dump``, key for key and in the same order)."""

import dataclasses
import enum
from typing import Any, Dict, List, Optional


class DType(str, enum.Enum):
    F32 = "f32"
    F16 = "f16"
    BF16 = "bf16"
    U8 = "u8"
    I32 = "i32"
    I64 = "i64"


class ReduceOp(enum.IntEnum):
    """Reduction ops for explicit collectives (values mirror the reference)."""

    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    BOR = 4
    BAND = 5
    BXOR = 6
    AVG = 10


@dataclasses.dataclass(frozen=True)
class TensorDeclaration:
    """One communicable tensor, as registered with the bucket planner."""

    name: str
    num_elements: int
    dtype: str  # DType value

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "num_elements": self.num_elements, "dtype": self.dtype}


def dtype_itemsize(dtype: str) -> int:
    return {
        DType.F32.value: 4,
        DType.F16.value: 2,
        DType.BF16.value: 2,
        DType.U8.value: 1,
        DType.I32.value: 4,
        DType.I64.value: 8,
    }[dtype]


def _optional(kind, value):
    return None if value is None else kind(value)


@dataclasses.dataclass
class BaguaHyperparameter:
    """The tunable hyperparameters the autotune service optimizes: the
    bucket assignment (a list of buckets, each a list of tensor
    declarations), the bucket size in bytes, and whether the reduction is
    hierarchical (intra axis first).

    ``wire_bf16`` (exchange gradients in bfloat16, for algorithms with a
    ``wire_dtype``) and ``overlap`` (exchange each bucket from inside the
    backward pass) are tri-state: None means the service is not tuning the
    dimension and the client must leave a user-configured value alone.
    ``predicted_exposed_ms`` is the planner's predicted exposed
    communication time of the assignment (None without measured spans),
    informational: it rides the telemetry's re-bucket record.

    Fields are coerced on construction as the pydantic model coerces them
    (bucket dicts to :class:`TensorDeclaration`, numpy scalars to Python
    numbers), so the JSON of :meth:`to_dict` is the JAX service's."""

    buckets: List[List[TensorDeclaration]] = dataclasses.field(default_factory=list)
    bucket_size: int = 10 * 1024 ** 2
    is_hierarchical_reduce: bool = False
    wire_bf16: Optional[bool] = None
    overlap: Optional[bool] = None
    predicted_exposed_ms: Optional[float] = None

    def __post_init__(self):
        self.buckets = [
            [td if isinstance(td, TensorDeclaration) else TensorDeclaration(**td) for td in bucket]
            for bucket in self.buckets
        ]
        self.bucket_size = int(self.bucket_size)
        self.is_hierarchical_reduce = bool(self.is_hierarchical_reduce)
        self.wire_bf16 = _optional(bool, self.wire_bf16)
        self.overlap = _optional(bool, self.overlap)
        self.predicted_exposed_ms = _optional(float, self.predicted_exposed_ms)

    def to_dict(self) -> Dict[str, Any]:
        """The record as JSON-ready types (pydantic's ``model_dump``)."""
        return {
            "buckets": [[td.to_dict() for td in bucket] for bucket in self.buckets],
            "bucket_size": self.bucket_size,
            "is_hierarchical_reduce": self.is_hierarchical_reduce,
            "wire_bf16": self.wire_bf16,
            "overlap": self.overlap,
            "predicted_exposed_ms": self.predicted_exposed_ms,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BaguaHyperparameter":
        """The record from :meth:`to_dict`'s form; unknown keys are ignored,
        as the pydantic model ignores them."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def update(self, param_dict: Dict) -> "BaguaHyperparameter":
        """Set the fields ``param_dict`` names (others are ignored)."""
        merged = self.to_dict()
        merged.update({k: v for k, v in param_dict.items() if k in merged})
        fresh = self.from_dict(merged)
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(fresh, f.name))
        return self
