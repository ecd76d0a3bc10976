"""Process groups and collectives over rank-stacked tensors.

The port of ``bagua_tpu/communication.py``, keeping its single-controller
model: a :class:`BaguaProcessGroup` is a list of devices, one per rank,
laid out on a mesh of named axes.  The legacy group is the two-axis mesh
``("inter", "intra")`` with rank ``r = inter * intra_size + intra``; a
:class:`~bagua_tpu_torch.mesh.MeshSpec` names the axes and their roles
instead (``{"dp": 4, "tp": 2}``), ranks row-major over them.  Every
per-rank value is held *stacked*: one tensor whose leading axis has one
slice per rank.  A device may repeat, so ``[cuda:0] * 4`` is four ranks on
one card, as ``[cpu] * 8`` is the tests' eight.

The collectives are tensor operations on that leading axis, the stacked
counterparts of the reference's in-step collectives
(``communication.py:280-340``): each output slice is what that rank would
hold after the collective.  ``axis`` picks the ranks that communicate: one
axis name or several (member index row-major over them, in the order
given, as the JAX package's ``rank_id``), or None.  None resolves to the
ambient axes of :func:`default_axes` where one is entered (the engine
enters the group's data axes around each step it runs, as the JAX engine
does inside its ``shard_map``), else to every axis of the group.
Reductions fold the peers left to right, so every rank of a collective
gets the very same bits.

The reference's eager user API (``broadcast``, ``reduce``, ``scatter``,
``gather``, ``reducescatter``, ``barrier``, ``broadcast_object``) closes the
module, over every rank of a group, on the same stacked tensors.

Inside :class:`~bagua_tpu_torch.analysis.collective_ir.capture_collectives`
each collective also records one descriptor of the JAX primitive it stands
for (the static verifier's CollectiveIR); outside one it pays a
thread-local read.

All ranks of a group live on one device.  Ranks on several cards need one
process per card over NCCL, which this package does not have yet.
"""

import contextlib
import contextvars
from typing import List, Optional, Sequence, Tuple

import torch

from bagua_tpu_torch.analysis import collective_ir as _ir
from bagua_tpu_torch.defs import ReduceOp
from bagua_tpu_torch.mesh import MeshSpec

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
    """A group of ranks arranged on a named mesh.

    Without a ``mesh_spec`` this is the legacy 2-D ``(inter, intra)`` mesh:
    ``intra_size`` ranks form the fast inner axis (one host);
    ``inter_size = size // intra_size`` forms the slower outer axis, every
    rank on the inner axis by default, and every axis carries the
    data-parallel exchange.

    With a :class:`~bagua_tpu_torch.mesh.MeshSpec` the mesh axes are the
    spec's named axes (e.g. ``dp x tp``): the engine's bucketed exchange
    rides the spec's *data* axes only, while *model* axes (tp/sp/ep/pp) are
    left to the model's own collectives.  ``intra_size`` is then the group
    size and ``inter_size`` 1, as the JAX package sets them."""

    def __init__(self, devices: Sequence, intra_size: Optional[int] = None,
                 mesh_spec: Optional[MeshSpec] = None):
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
        self.devices = devices
        self.mesh_spec = mesh_spec
        if mesh_spec is not None:
            if intra_size is not None:
                raise ValueError(
                    "pass either intra_size (legacy inter/intra mesh) or "
                    "mesh_spec (named mesh), not both"
                )
            mesh_spec.device_array(devices)  # raises unless n == spec.size
            self.intra_size, self.inter_size = n, 1
            return
        if intra_size is None:
            intra_size = n
        if n % intra_size != 0:
            raise ValueError(f"group size {n} not divisible by intra_size {intra_size}")
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
    def all_axes(self) -> Tuple[str, ...]:
        """Every mesh axis name, in mesh order."""
        return self.mesh_spec.names if self.mesh_spec is not None else ALL_AXES

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The axes the batch shards over and the gradient exchange rides."""
        return self.mesh_spec.data_axes if self.mesh_spec is not None else ALL_AXES

    @property
    def model_axes(self) -> Tuple[str, ...]:
        return self.mesh_spec.model_axes if self.mesh_spec is not None else ()

    @property
    def shape(self) -> Tuple[int, ...]:
        """The mesh's axis sizes, in :attr:`all_axes` order."""
        return self.mesh_spec.shape if self.mesh_spec is not None else (self.inter_size, self.intra_size)

    @property
    def exchange_size(self) -> int:
        """Ranks in the gradient-exchange ring: the product of the data
        axes (``size`` unless model axes are present; then the exchange
        communicates only among ranks sharing a model-axis coordinate)."""
        return self.mesh_spec.exchange_size if self.mesh_spec is not None else self.size

    def __repr__(self) -> str:
        if self.mesh_spec is not None:
            return f"BaguaProcessGroup(size={self.size}, mesh={self.mesh_spec!r}, device={self.device})"
        return (
            f"BaguaProcessGroup(size={self.size}, inter={self.inter_size}, "
            f"intra={self.intra_size}, device={self.device})"
        )


def init_process_group(
    devices: Optional[Sequence] = None, intra_size: Optional[int] = None,
    mesh_spec: Optional[MeshSpec] = None,
) -> BaguaProcessGroup:
    """Initialize the default process group.  Without ``devices`` it takes
    the visible CUDA devices and raises where there are none; pass
    ``[torch.device("cpu")] * n`` to run n ranks on the CPU.

    With a ``mesh_spec`` and no ``devices`` the group is ``spec.size`` ranks
    on the current CUDA device (the JAX package takes the first
    ``spec.size`` devices; the port keeps every rank of a group on one
    device)."""
    global _default_group
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_process_group: no CUDA device is visible; pass "
                "devices=[torch.device('cpu')] * n to run on the CPU"
            )
        if mesh_spec is not None:
            devices = [torch.device("cuda", torch.cuda.current_device())] * mesh_spec.size
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    _default_group = BaguaProcessGroup(devices, intra_size=intra_size, mesh_spec=mesh_spec)
    return _default_group


def is_initialized() -> bool:
    return _default_group is not None


def get_default_group() -> BaguaProcessGroup:
    if _default_group is None:
        init_process_group()
    return _default_group  # type: ignore


def new_group(ranks: Optional[Sequence[int]] = None, intra_size: Optional[int] = None,
              mesh_spec: Optional[MeshSpec] = None) -> BaguaProcessGroup:
    """A group of the default group's ranks ``ranks`` (all of them by
    default), in that order (reference ``communication.py:217``), on the
    legacy mesh or on ``mesh_spec``."""
    base = get_default_group()
    devices = base.devices if ranks is None else [base.devices[r] for r in ranks]
    return BaguaProcessGroup(devices, intra_size=intra_size, mesh_spec=mesh_spec)


def local_ranks(group: Optional[BaguaProcessGroup] = None) -> List[int]:
    """The ranks whose slices this process passes to the collectives: every
    rank, since one controller holds them all."""
    return list(range((group or get_default_group()).size))


# ---------------------------------------------------------------------------
# Stacked collectives
# ---------------------------------------------------------------------------

#: the axes an ``axis=None`` collective resolves to where set
_DEFAULT_AXES: contextvars.ContextVar = contextvars.ContextVar("bagua_default_axes", default=None)


@contextlib.contextmanager
def default_axes(axes: Sequence[str]):
    """Make ``axes`` the resolution of ``axis=None`` collectives within (on
    this thread: a hook that autograd runs on its own thread enters it
    again)."""
    token = _DEFAULT_AXES.set(tuple(axes))
    try:
        yield
    finally:
        _DEFAULT_AXES.reset(token)


def _axes(axis, group: Optional[BaguaProcessGroup] = None) -> Tuple[str, ...]:
    """``axis`` as a tuple of axis names: None is the ambient
    :func:`default_axes`, else every axis of ``group`` (the legacy pair
    without one)."""
    if axis is None:
        ambient = _DEFAULT_AXES.get()
        if ambient is not None:
            return ambient
        return group.all_axes if group is not None else ALL_AXES
    if isinstance(axis, str):
        return (axis,)
    return tuple(axis)


def _resolve(group: BaguaProcessGroup, axis) -> Tuple[str, ...]:
    """``axis`` resolved on ``group``; an axis the group does not declare
    raises ValueError naming the declared ones."""
    axes = _axes(axis, group)
    declared = group.all_axes
    unknown = [a for a in axes if a not in declared]
    if unknown or len(set(axes)) != len(axes):
        raise ValueError(f"collective axes {axes} are not distinct axes of the group: "
                         f"its declared mesh axes are {declared}")
    return axes


def axis_size(group: BaguaProcessGroup, axis=None) -> int:
    sizes = dict(zip(group.all_axes, group.shape))
    n = 1
    for a in _resolve(group, axis):
        n *= sizes[a]
    return n


def _layout(group: BaguaProcessGroup, axis):
    """How :func:`_grouped` views the mesh for ``axis``: the permutation of
    the mesh's dims that puts the collective's axes last (in the order
    ``axis`` names them) and the other axes first (in mesh order), and the
    permuted shape."""
    axes = _resolve(group, axis)
    names = group.all_axes
    order = [i for i, a in enumerate(names) if a not in axes] + [names.index(a) for a in axes]
    return order, [group.shape[i] for i in order]


def _grouped(x: torch.Tensor, group: BaguaProcessGroup, axis) -> torch.Tensor:
    """View the stacked ``(size, ...)`` tensor as ``(G, n, ...)``: G
    independent collectives of n members each, member index row-major over
    the collective's axes in the order given."""
    if x.shape[0] != group.size:
        raise ValueError(f"leading dim {x.shape[0]} != group size {group.size}")
    order, _ = _layout(group, axis)
    rest = x.shape[1:]
    n = axis_size(group, axis)
    if order == sorted(order):  # the collective's axes are already innermost
        return x.reshape(group.size // n, n, *rest)
    grid = x.reshape(*group.shape, *rest).permute(*order, *range(len(order), len(order) + len(rest)))
    return grid.reshape(group.size // n, n, *rest)


def _ungrouped(y: torch.Tensor, group: BaguaProcessGroup, axis) -> torch.Tensor:
    """Inverse of :func:`_grouped` (the result is contiguous)."""
    order, shape = _layout(group, axis)
    rest = y.shape[2:]
    if order != sorted(order):
        inverse = [order.index(i) for i in range(len(order))]
        y = y.reshape(*shape, *rest).permute(*inverse, *range(len(order), len(order) + len(rest)))
    return y.reshape(group.size, *rest).contiguous()


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
    if _ir._tls.capture is not None:
        _ir.record_collective("ppermute", (x,), group, _resolve(group, axis))
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
    if _ir._tls.capture is not None:
        _ir.record_collective("ppermute", (x,), group, _resolve(group, axis))
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


#: the elementwise folds of the reductions that gather the peers (the
#: JAX package's PRODUCT and bitwise ops; MAX and MIN fold the same way)
_FOLDS = {
    ReduceOp.SUM: torch.add,
    ReduceOp.AVG: torch.add,
    ReduceOp.PRODUCT: torch.mul,
    ReduceOp.MAX: torch.maximum,
    ReduceOp.MIN: torch.minimum,
    ReduceOp.BOR: torch.bitwise_or,
    ReduceOp.BAND: torch.bitwise_and,
    ReduceOp.BXOR: torch.bitwise_xor,
}


def _reduce_members(g: torch.Tensor, op: ReduceOp) -> torch.Tensor:
    """The grouped ``(G, n, ...)`` stack reduced over its members, ``(G,
    ...)``: folded left to right in member order, so every member of a
    collective gets the same bits; AVG divides the sum by n once."""
    fold = _FOLDS[op]
    red = g[:, 0]
    for i in range(1, g.shape[1]):
        red = fold(red, g[:, i])
    if op == ReduceOp.AVG:
        red = red / torch.full_like(red, g.shape[1])
    return red


#: the JAX primitive each reduction runs as (PRODUCT and the bitwise ops
#: gather the members and fold them)
_REDUCE_PRIMITIVE = {ReduceOp.SUM: "psum", ReduceOp.AVG: "psum", ReduceOp.MAX: "pmax", ReduceOp.MIN: "pmin"}


def _allreduce(send: torch.Tensor, op: ReduceOp, group: BaguaProcessGroup, axis) -> torch.Tensor:
    g = _grouped(send, group, axis)
    red = _reduce_members(g, op)
    return _ungrouped(red.unsqueeze(1).expand_as(g), group, axis)


def allreduce(
    send: torch.Tensor, op: ReduceOp = ReduceOp.AVG,
    comm: Optional[BaguaProcessGroup] = None, axis=None,
) -> torch.Tensor:
    """Allreduce of each rank's slice over ``axis``, with any
    :class:`ReduceOp`: SUM and AVG (the JAX package's ``psum`` and
    ``pmean``), MAX and MIN (``pmax``, ``pmin``), PRODUCT, and BOR, BAND
    and BXOR on integer or bool tensors, each folded over the members left
    to right (``communication.py:280-308``)."""
    return allreduce_many([send], op, comm, axis)[0]


def allreduce_many(
    sends: Sequence[torch.Tensor], op: ReduceOp = ReduceOp.AVG,
    comm: Optional[BaguaProcessGroup] = None, axis=None,
) -> List[torch.Tensor]:
    """:func:`allreduce` of each tensor of ``sends``, as ONE collective: the
    JAX package's variadic ``lax.psum`` over a tuple of leaves, one
    primitive whose operand bytes are the leaves' sum.  Each result is
    bitwise :func:`allreduce` of its tensor."""
    group = comm or get_default_group()
    op = ReduceOp(op)
    if _ir._tls.capture is not None and sends:
        _ir.record_collective(_REDUCE_PRIMITIVE.get(op, "all_gather"), tuple(sends), group, _resolve(group, axis))
    return [_allreduce(s, op, group, axis) for s in sends]


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
        # the JAX package's reduce_scatter refuses the rest too
        raise NotImplementedError(f"reduce_scatter supports SUM and AVG, not {op.name}")
    if _ir._tls.capture is not None:
        _ir.record_collective("reduce_scatter", (send,), group, _resolve(group, axis))
    g = _grouped(send, group, axis)
    G, n, m = g.shape[:3]
    if m % n:
        raise ValueError(f"reduce_scatter: dim {m} does not divide into {n} chunks")
    red = _reduce_members(g, op)
    return _ungrouped(red.reshape(G, n, m // n, *g.shape[3:]), group, axis)


def hierarchical_allreduce(
    send: torch.Tensor, op: ReduceOp = ReduceOp.AVG,
    comm: Optional[BaguaProcessGroup] = None,
) -> torch.Tensor:
    """Intra-axis reduce, then inter-axis reduce (the reference's
    hierarchical communicator).  AVG sums both phases and divides once, by
    the group size; every other op composes across the phases."""
    return hierarchical_allreduce_many([send], op, comm)[0]


def hierarchical_allreduce_many(
    sends: Sequence[torch.Tensor], op: ReduceOp = ReduceOp.AVG,
    comm: Optional[BaguaProcessGroup] = None,
) -> List[torch.Tensor]:
    """:func:`hierarchical_allreduce` of each tensor of ``sends``, each leg
    one variadic collective (:func:`allreduce_many`)."""
    group = comm or get_default_group()
    op = ReduceOp(op)
    phase = ReduceOp.SUM if op == ReduceOp.AVG else op
    xs = allreduce_many(sends, phase, group, INTRA_AXIS)
    xs = allreduce_many(xs, phase, group, INTER_AXIS)
    return [x / torch.full_like(x, group.size) for x in xs] if op == ReduceOp.AVG else xs


def alltoall(
    send: torch.Tensor, comm: Optional[BaguaProcessGroup] = None, axis=None
) -> torch.Tensor:
    """Each rank's slice is split along its first dim into n chunks; chunk j
    goes to member j, and each rank's output is the chunks it received, in
    member order."""
    group = comm or get_default_group()
    if _ir._tls.capture is not None:
        _ir.record_collective("all_to_all", (send,), group, _resolve(group, axis))
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
    if _ir._tls.capture is not None:
        _ir.record_collective("all_gather", (send,), group, _resolve(group, axis))
    g = _grouped(send, group, axis)
    G, n = g.shape[:2]
    full = g.reshape(G, 1, n * g.shape[2], *g.shape[3:])
    return _ungrouped(full.expand(G, n, *full.shape[2:]), group, axis)


def alltoall_v_inplace(
    x: torch.Tensor, send_counts: torch.Tensor, comm: Optional[BaguaProcessGroup] = None, axis=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Variable-count all-to-all in the static-shape idiom of the JAX
    package (``communication.py:342-366``).  ``x (size, n, capacity, ...)``:
    each rank's chunk j, padded to ``capacity`` rows, goes to member j of
    its collective over ``axis``, and its first ``send_counts[r, j]`` rows
    are the ones that count; ``send_counts (size, n)`` is data and may
    differ by rank.  Returns ``(recv, recv_counts)``: ``recv[r, j]`` is the
    padded chunk rank r received from member j, valid up to
    ``recv_counts[r, j]`` rows."""
    group = comm or get_default_group()
    n = axis_size(group, axis)
    if x.dim() < 3 or x.shape[1] != n:
        raise ValueError(f"alltoall_v_inplace: x {tuple(x.shape)} needs (size, {n}, capacity, ...)")
    if tuple(send_counts.shape) != (group.size, n):
        raise ValueError(f"alltoall_v_inplace: send_counts {tuple(send_counts.shape)} "
                         f"!= ({group.size}, {n})")
    recv = alltoall(x.reshape(group.size, n * x.shape[2], *x.shape[3:]), group, axis)
    return recv.reshape(x.shape), alltoall(send_counts, group, axis)


# ---------------------------------------------------------------------------
# The eager user API under the reference's names (``bagua_tpu/communication.py
# :439-646``): collectives over every rank of a group, rank-stacked
# ---------------------------------------------------------------------------


def reducescatter(
    send: torch.Tensor, op: ReduceOp = ReduceOp.SUM, comm: Optional[BaguaProcessGroup] = None
) -> torch.Tensor:
    """Rank r gets the r-th of ``size`` chunks of the reduced slices
    (reference ``communication.py:1219``): :func:`reduce_scatter` over
    every rank."""
    group = comm or get_default_group()
    return reduce_scatter(send, op, group, group.all_axes)


def broadcast(send: torch.Tensor, src: int = 0, comm: Optional[BaguaProcessGroup] = None) -> torch.Tensor:
    """Every rank gets rank ``src``'s slice (reference
    ``communication.py:573``), as :func:`broadcast_inplace` computes it."""
    group = comm or get_default_group()
    return broadcast_inplace(send, src, group, group.all_axes)


def _at_rank(group: BaguaProcessGroup, rank: int, ndim: int) -> torch.Tensor:
    """``(size, 1, ...)`` bool: True on ``rank``'s slice."""
    return (rank_id(group, group.all_axes) == rank).reshape(group.size, *([1] * (ndim - 1)))


def reduce(
    send: torch.Tensor, dst: int = 0, op: ReduceOp = ReduceOp.AVG,
    comm: Optional[BaguaProcessGroup] = None,
) -> torch.Tensor:
    """Rank ``dst`` gets the reduction of every slice; the other ranks keep
    their own (reference ``communication.py:958``)."""
    group = comm or get_default_group()
    return torch.where(_at_rank(group, dst, send.dim()), allreduce(send, op, group, group.all_axes), send)


def scatter(send: torch.Tensor, src: int = 0, comm: Optional[BaguaProcessGroup] = None) -> torch.Tensor:
    """Rank ``src``'s slice cut into ``size`` chunks along its first dim;
    rank i gets chunk i (reference ``communication.py:1155``)."""
    group = comm or get_default_group()
    n, m = group.size, send.shape[1]
    if m % n:
        raise ValueError(f"scatter: dim {m} does not divide into {n} chunks")
    full = broadcast_inplace(send, src, group, group.all_axes)
    chunks = full.reshape(n, n, m // n, *send.shape[2:])
    return chunks[torch.arange(n, device=send.device), rank_id(group, group.all_axes)]


def gather(send: torch.Tensor, dst: int = 0, comm: Optional[BaguaProcessGroup] = None) -> torch.Tensor:
    """Rank ``dst`` gets every slice, concatenated along the first dim; the
    other ranks get zeros, as the JAX package gives them (reference
    ``communication.py:1081`` leaves their buffers as they were)."""
    group = comm or get_default_group()
    full = allgather(send, group, group.all_axes)
    return torch.where(_at_rank(group, dst, full.dim()), full, torch.zeros_like(full))


def barrier(comm: Optional[BaguaProcessGroup] = None) -> None:
    """Returns once every collective issued on the group has finished: on
    a card, a synchronize of the group's device (reference
    ``communication.py:1377-1401``); on the CPU every call has already
    run."""
    group = comm or get_default_group()
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s object on every rank (reference
    ``communication.py:668``).  One controller holds every rank, so each
    rank's object is already this one, as the JAX package returns it in a
    single process."""
    return obj
