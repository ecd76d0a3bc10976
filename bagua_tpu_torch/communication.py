"""Process groups and collectives over rank-stacked tensors.

The port of ``bagua_tpu/communication.py``, keeping its single-controller
model: a :class:`BaguaProcessGroup` is a list of devices, one per rank, laid
out as an ``(inter, intra)`` grid with rank ``r = inter * intra_size +
intra``.  Every per-rank value is held *stacked*: one tensor whose leading
axis has one slice per rank.  A device may repeat, so ``[cuda:0] * 4`` is
four ranks on one card, as ``[cpu] * 8`` is the tests' eight.

The collectives are tensor operations on that leading axis, the stacked
counterparts of the reference's in-step collectives
(``communication.py:280-340``): each output slice is what that rank would
hold after the collective.  ``axis`` picks the ranks that communicate:
``None`` (all of them), ``"inter"`` (ranks sharing an intra index) or
``"intra"`` (ranks sharing an inter index).  Sums run over the peers left to
right, so every rank of a collective gets the very same bits.

All ranks of a group live on one device.  Ranks on several cards need one
process per card over NCCL, which this package does not have yet.
"""

from typing import Optional, Sequence, Tuple

import torch

from bagua_tpu_torch.defs import ReduceOp

INTER_AXIS = "inter"
INTRA_AXIS = "intra"
ALL_AXES = (INTER_AXIS, INTRA_AXIS)

_default_group: Optional["BaguaProcessGroup"] = None


def _normalize(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class BaguaProcessGroup:
    """A group of ranks arranged on an ``(inter, intra)`` grid.

    ``intra_size`` ranks form the fast inner axis (one host);
    ``inter_size = size // intra_size`` forms the slower outer axis.  By
    default every rank is on the inner axis."""

    def __init__(self, devices: Sequence, intra_size: Optional[int] = None):
        devices = [_normalize(d) for d in devices]
        if not devices:
            raise ValueError("a process group needs at least one device")
        if len(set(devices)) != 1:
            raise NotImplementedError(
                f"ranks on several devices ({sorted(set(map(str, devices)))}) need one "
                "process per device over NCCL, which is not ported yet; give every "
                "rank the same device"
            )
        n = len(devices)
        if intra_size is None:
            intra_size = n
        if n % intra_size != 0:
            raise ValueError(f"group size {n} not divisible by intra_size {intra_size}")
        self.devices = devices
        self.intra_size = intra_size
        self.inter_size = n // intra_size

    @property
    def device(self) -> torch.device:
        """The device every rank's slice lives on."""
        return self.devices[0]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def exchange_size(self) -> int:
        """Ranks in the gradient-exchange ring."""
        return self.size

    def __repr__(self) -> str:
        return (
            f"BaguaProcessGroup(size={self.size}, inter={self.inter_size}, "
            f"intra={self.intra_size}, device={self.device})"
        )


def init_process_group(
    devices: Optional[Sequence] = None, intra_size: Optional[int] = None
) -> BaguaProcessGroup:
    """Initialize the default process group.  Without ``devices`` it takes
    the visible CUDA devices and raises where there are none; pass
    ``[torch.device("cpu")] * n`` to run n ranks on the CPU."""
    global _default_group
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_process_group: no CUDA device is visible; pass "
                "devices=[torch.device('cpu')] * n to run on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    _default_group = BaguaProcessGroup(devices, intra_size=intra_size)
    return _default_group


def get_default_group() -> BaguaProcessGroup:
    if _default_group is None:
        init_process_group()
    return _default_group  # type: ignore


# ---------------------------------------------------------------------------
# Stacked collectives
# ---------------------------------------------------------------------------


def _axes(axis) -> Tuple[str, ...]:
    if axis is None:
        return ALL_AXES
    if isinstance(axis, str):
        return (axis,)
    return tuple(axis)


def axis_size(group: BaguaProcessGroup, axis=None) -> int:
    sizes = {INTER_AXIS: group.inter_size, INTRA_AXIS: group.intra_size}
    n = 1
    for a in _axes(axis):
        n *= sizes[a]
    return n


def _grouped(x: torch.Tensor, group: BaguaProcessGroup, axis) -> torch.Tensor:
    """View the stacked ``(size, ...)`` tensor as ``(G, n, ...)``: G
    independent collectives of n members each, members in rank order."""
    axes = _axes(axis)
    rest = x.shape[1:]
    if x.shape[0] != group.size:
        raise ValueError(f"leading dim {x.shape[0]} != group size {group.size}")
    grid = x.reshape(group.inter_size, group.intra_size, *rest)
    if axes == ALL_AXES:
        return x.reshape(1, group.size, *rest)
    if axes == (INTER_AXIS,):
        return grid.transpose(0, 1)
    if axes == (INTRA_AXIS,):
        return grid
    raise ValueError(f"unsupported collective axes {axes}")


def _ungrouped(y: torch.Tensor, group: BaguaProcessGroup, axis) -> torch.Tensor:
    """Inverse of :func:`_grouped` (the result is contiguous)."""
    if _axes(axis) == (INTER_AXIS,):
        y = y.transpose(0, 1)
    return y.reshape(group.size, *y.shape[2:]).contiguous()


def rank_id(group: BaguaProcessGroup, axis=None) -> torch.Tensor:
    """Each rank's member index within its collective over ``axis``: an
    int64 tensor of shape ``(size,)`` on the group's device (the stacked
    counterpart of the JAX package's per-rank ``rank_id``)."""
    n = axis_size(group, axis)
    ids = torch.arange(n, device=group.device).expand(group.size // n, n)
    return _ungrouped(ids, group, axis)


def ppermute_shift(
    x: torch.Tensor, shift: int, comm: Optional[BaguaProcessGroup] = None, axis=None
) -> torch.Tensor:
    """Ring shift: within each collective over ``axis``, the member with
    index i receives member (i - shift) mod n's slice."""
    group = comm or get_default_group()
    return _ungrouped(torch.roll(_grouped(x, group, axis), shift, dims=1), group, axis)


def ppermute_apply(
    x: torch.Tensor, perm, comm: Optional[BaguaProcessGroup] = None, axis=None
) -> torch.Tensor:
    """An explicit permutation within each collective over ``axis``: for
    every ``(src, dst)`` pair of member indices, member dst receives member
    src's slice.  Members that no pair names as a destination receive
    zeros, as ``lax.ppermute`` gives them; a member may be the source and
    the destination of one pair each at most."""
    group = comm or get_default_group()
    g = _grouped(x, group, axis)
    n = g.shape[1]
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute_apply: {perm} names a source or a destination twice")
    if not all(0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute_apply: {perm} names a member outside 0..{n - 1}")
    # one gather (each slice copied once), then zeros where no pair arrives
    source = dict(zip(dsts, srcs))
    out = g[:, [source.get(d, d) for d in range(n)]]
    out[:, [d for d in range(n) if d not in source]] = 0
    return _ungrouped(out, group, axis)


def broadcast_inplace(
    x: torch.Tensor, src_rank: int = 0, comm: Optional[BaguaProcessGroup] = None, axis=None
) -> torch.Tensor:
    """Every member of each collective over ``axis`` receives member
    ``src_rank``'s slice, as the JAX package computes it: a sum over the
    members of each slice masked to zeros but at ``src_rank``, so a NaN on
    another member does not reach the result, and a -0 at the source sums
    to +0."""
    group = comm or get_default_group()
    me = rank_id(group, axis).reshape(group.size, *([1] * (x.dim() - 1)))
    masked = torch.where(me == src_rank, x, torch.zeros_like(x))
    return allreduce(masked, ReduceOp.SUM, group, axis)


def allreduce(
    send: torch.Tensor, op: ReduceOp = ReduceOp.AVG,
    comm: Optional[BaguaProcessGroup] = None, axis=None,
) -> torch.Tensor:
    """Allreduce of each rank's slice over ``axis`` (SUM or AVG)."""
    group = comm or get_default_group()
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise NotImplementedError(f"allreduce supports SUM and AVG, not {op.name}")
    g = _grouped(send, group, axis)
    red = g[:, 0]
    for i in range(1, g.shape[1]):
        red = red + g[:, i]
    if op == ReduceOp.AVG:
        red = red / torch.full_like(red, g.shape[1])
    return _ungrouped(red.unsqueeze(1).expand_as(g), group, axis)


def reduce_scatter(
    send: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
    comm: Optional[BaguaProcessGroup] = None, axis=None,
) -> torch.Tensor:
    """Reduce-scatter of each rank's slice over ``axis`` (SUM or AVG): the
    member with index i gets the reduced values of the i-th of n equal
    chunks of the slice's first dim.  Sums and divides as :func:`allreduce`
    does, so each chunk is bitwise that chunk of the allreduce."""
    group = comm or get_default_group()
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise NotImplementedError(f"reduce_scatter supports SUM and AVG, not {op.name}")
    g = _grouped(send, group, axis)
    G, n, m = g.shape[:3]
    if m % n:
        raise ValueError(f"reduce_scatter: dim {m} does not divide into {n} chunks")
    red = g[:, 0]
    for i in range(1, n):
        red = red + g[:, i]
    if op == ReduceOp.AVG:
        red = red / torch.full_like(red, n)
    return _ungrouped(red.reshape(G, n, m // n, *g.shape[3:]), group, axis)


def hierarchical_allreduce(
    send: torch.Tensor, op: ReduceOp = ReduceOp.AVG,
    comm: Optional[BaguaProcessGroup] = None,
) -> torch.Tensor:
    """Intra-axis reduce, then inter-axis reduce (the reference's
    hierarchical communicator); AVG divides once, by the group size."""
    group = comm or get_default_group()
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise NotImplementedError(f"hierarchical_allreduce supports SUM and AVG, not {op.name}")
    x = allreduce(send, ReduceOp.SUM, group, INTRA_AXIS)
    x = allreduce(x, ReduceOp.SUM, group, INTER_AXIS)
    return x / torch.full_like(x, group.size) if op == ReduceOp.AVG else x


def alltoall(
    send: torch.Tensor, comm: Optional[BaguaProcessGroup] = None, axis=None
) -> torch.Tensor:
    """Each rank's slice is split along its first dim into n chunks; chunk j
    goes to member j, and each rank's output is the chunks it received, in
    member order."""
    group = comm or get_default_group()
    g = _grouped(send, group, axis)
    G, n, m = g.shape[:3]
    if m % n:
        raise ValueError(f"alltoall: dim {m} does not divide into {n} chunks")
    chunks = g.reshape(G, n, n, m // n, *g.shape[3:])  # (G, src, dst, ...)
    return _ungrouped(chunks.transpose(1, 2).reshape(g.shape), group, axis)


def allgather(
    send: torch.Tensor, comm: Optional[BaguaProcessGroup] = None, axis=None
) -> torch.Tensor:
    """Each rank's output is every member's slice, concatenated along the
    first dim."""
    group = comm or get_default_group()
    g = _grouped(send, group, axis)
    G, n = g.shape[:2]
    full = g.reshape(G, 1, n * g.shape[2], *g.shape[3:])
    return _ungrouped(full.expand(G, n, *full.shape[2:]), group, axis)
