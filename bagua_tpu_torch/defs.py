"""Shared type definitions: the wire dtype names, the ``ReduceOp`` enum and
the tensor declarations exchanged with the bucket planner (the port of
``bagua_tpu/defs.py``)."""

import dataclasses
import enum


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


def dtype_itemsize(dtype: str) -> int:
    return {
        DType.F32.value: 4,
        DType.F16.value: 2,
        DType.BF16.value: 2,
        DType.U8.value: 1,
        DType.I32.value: 4,
        DType.I64.value: 8,
    }[dtype]
