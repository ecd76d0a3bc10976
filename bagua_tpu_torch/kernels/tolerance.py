"""The contracts that hold a kernel against its plain version where the
two need not agree bit for bit: flash attention's tolerances and the tile
GEMM's bound.  The codec and ring-hop kernels are held bitwise."""

import math

import torch

#: attention's contract is a tolerance (the JAX package's bounds for its
#: Pallas kernels, tests/test_parallel.py:291-293, 423): each output within
#: tol * max(1, |plain value|), bf16 or f16 outputs one rounding step (2^-8
#: of the value) more; inputs at unit variance, q pre-scaled
ATTENTION_TOLS = {
    "block_attention": (2e-4, 2e-4, 2e-5),  # o, l, m
    "flash_attention_bwd_dq": (3e-4,),
    "flash_attention_bwd_dkv": (3e-4, 3e-4),
}


def close(got: torch.Tensor, want: torch.Tensor, tol: float) -> bool:
    """Every element within ``tol * max(1, |want|)``, plus one rounding step
    of a bf16 or f16 ``got``."""
    g, w = got.double(), want.double()
    step = 2.0 ** -8 if got.dtype in (torch.bfloat16, torch.float16) else 0.0
    return bool(((g - w).abs() <= tol * w.abs().clamp(min=1.0) + step * w.abs()).all())


def matmul_tol(k: int) -> float:
    """The tile kernel's elementwise tolerance, relative to ``(|x| |w|)_ij``:
    with rounding errors of random sign, a K-term f32 dot product lies
    within about sqrt(K) 2^-24 of the exact one (Higham and Mary's
    probabilistic bound, lambda = 1; the worst case is K 2^-24), so two
    within 2 sqrt(K) 2^-24 of each other.  Inputs rounded to TF32 (2^-11)
    miss it at path (a)'s shapes."""
    return 2 * math.sqrt(k) * 2.0 ** -24


def matmul_share(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> float:
    """The largest share of ``matmul_tol(K) (|x| |w|)_ij`` that an element
    of ``got - want`` uses."""
    if not got.numel():
        return 0.0
    bound = matmul_tol(x.shape[-1]) * (x.abs() @ w.abs())
    return float(((got - want).abs() / bound.clamp(min=1e-30)).max())
