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

All ranks a process holds live on one device.  A group may span OS
processes (:func:`init_process_group` with a ``coordinator_address``, or
:func:`bagua_tpu_torch.distributed.init_from_env` under the launcher): W
processes of ``k`` ranks each, rank ``r = p * k + i`` at row ``i`` of
process ``p``'s stack, ``size = W * k``.  Every collective then takes the
process's local ``(k, ...)`` stack and returns exactly the rows ``[p * k,
(p + 1) * k)`` the single-controller group computes for the whole ``(size,
...)`` stack, bit for bit: the bytes cross processes through
``torch.distributed`` (gloo for CPU tensors, NCCL for CUDA ones), and every
fold runs locally in the stacked code's member order, never in a
library's sum.  Such a group issues its ``torch.distributed`` calls even
at W = 1, so one card drives the NCCL path.  Two exchanges carry every
collective:

* **routing** (one ``all_to_all_single`` of the pieces each process
  needs): the data movers (``ppermute_shift``, ``ppermute_apply``,
  ``alltoall``, ``allgather``) fetch exactly the rows or chunks their
  local outputs read, the native collective's bytes; a reduction whose
  members are few fetches them and folds locally;
* **the element transpose** (two ``all_to_all_single``): each process
  takes chunk ``j`` of every rank's flattened elements to process ``j``,
  runs the stacked reduction on the ``(size, chunk)`` columns it holds and
  sends the results back, ``2 (W - 1) / W`` of the local stack's bytes
  each way in all, a ring reduce-scatter and all-gather's.

A reduction takes whichever of the two moves fewer bytes out of the
busiest process, a choice the layout alone fixes, so every process makes
the same one.

Gradients: on either kind of group, a collective whose input takes a
gradient is recorded by autograd as one function whose backward is the
transposed collective over the same axes (a shift's is the shift back, a
permutation's its inverse, an all-to-all's the all-to-all back, an
allgather's the SUM reduce-scatter, a SUM or AVG allreduce's the SUM
allreduce, divided by n under AVG, a reduce-scatter's the allgather).  Its
sums fold left to right in member order and its cotangents come out
contiguous, on the single controller as across processes, so a gang's
gradients are bitwise the single controller's rows.  MAX, MIN, PRODUCT and
the bitwise reductions differentiate through autograd's own rules on the
single controller and raise, across processes, on an input that requires
grad.  Each collective's docstring states the bytes a process
sends to others ("wire"): S is one rank's slice, n the members of a
collective, and "native" the same collective with one rank a process (one
process a card), as NCCL runs it.
"""

import contextlib
import contextvars
import functools
import math
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bagua_tpu_torch.analysis import collective_ir as _ir
from bagua_tpu_torch.defs import ReduceOp
from bagua_tpu_torch.mesh import MeshSpec

INTER_AXIS = "inter"
INTRA_AXIS = "intra"
ALL_AXES = (INTER_AXIS, INTRA_AXIS)

#: the command that starts one worker process a card
LAUNCH_COMMAND = "python -m bagua_tpu_torch.distributed.run --nproc_per_node <cards> <script>"

_default_group: Optional["BaguaProcessGroup"] = None


def _normalize(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class BaguaProcessGroup:
    """A group of ranks arranged on a named mesh.

    Without a ``mesh_spec`` this is the legacy 2-D ``(inter, intra)`` mesh:
    ``intra_size`` ranks form the fast inner axis (one host; by default the
    ranks of one process);
    ``inter_size = size // intra_size`` forms the slower outer axis, every
    rank on the inner axis by default, and every axis carries the
    data-parallel exchange.

    With a :class:`~bagua_tpu_torch.mesh.MeshSpec` the mesh axes are the
    spec's named axes (e.g. ``dp x tp``): the engine's bucketed exchange
    rides the spec's *data* axes only, while *model* axes (tp/sp/ep/pp) are
    left to the model's own collectives.  ``intra_size`` is then the group
    size and ``inter_size`` 1, as the JAX package sets them.

    ``devices`` are the ranks this process holds, all on one device.  With
    ``distributed=True`` (``torch.distributed`` initialized) every process
    of the job passes its own ``k`` and the group has ``W * k`` ranks,
    process ``p`` holding ranks ``[p * k, (p + 1) * k)``; building one is a
    collective call (it makes the group's ``torch.distributed`` subgroups),
    so every process builds the same groups in the same order."""

    def __init__(self, devices: Sequence, intra_size: Optional[int] = None,
                 mesh_spec: Optional[MeshSpec] = None, distributed: bool = False,
                 processes: Optional[Sequence[int]] = None):
        devices = [_normalize(d) for d in devices]
        if not devices:
            raise ValueError("a process group needs at least one device")
        if len(set(devices)) != 1:
            raise NotImplementedError(
                f"ranks on several devices ({sorted(set(map(str, devices)))}) need one process "
                f"per device: start them with `{LAUNCH_COMMAND}` and build the group in each "
                "worker with bagua_tpu_torch.distributed.init_from_env()"
            )
        self.devices = devices
        self.mesh_spec = mesh_spec
        self.process_count, self.process_index = 1, 0
        #: the ``torch.distributed`` ranks of the processes holding the
        #: group's ranks, in group order (None: a single controller)
        self.processes: Optional[Tuple[int, ...]] = None
        if distributed:
            import torch.distributed as dist

            if not dist.is_initialized():
                raise RuntimeError("distributed=True needs torch.distributed initialized: call "
                                   "init_process_group(..., coordinator_address=...) first")
            me = dist.get_rank()
            self.processes = tuple(range(dist.get_world_size())) if processes is None else tuple(processes)
            self.process_count = len(self.processes)
            self.process_index = self.processes.index(me) if me in self.processes else -1
        n = len(devices) * self.process_count
        if mesh_spec is not None:
            if intra_size is not None:
                raise ValueError(
                    "pass either intra_size (legacy inter/intra mesh) or "
                    "mesh_spec (named mesh), not both"
                )
            mesh_spec.device_array(devices * self.process_count)  # raises unless n == spec.size
            self.intra_size, self.inter_size = n, 1
        else:
            if intra_size is None:
                intra_size = len(devices)
            if n % intra_size != 0:
                raise ValueError(f"group size {n} not divisible by intra_size {intra_size}")
            self.intra_size = intra_size
            self.inter_size = n // intra_size
        self._tables: Dict[tuple, object] = {}
        self._backing = _Backing(self) if distributed else None

    @property
    def device(self) -> torch.device:
        """The device every rank's slice of this process lives on."""
        return self.devices[0]

    @property
    def size(self) -> int:
        """Ranks in the group, over every process."""
        return len(self.devices) * self.process_count

    @property
    def local_size(self) -> int:
        """Ranks this process holds: the length of the stacks it passes."""
        return len(self.devices)

    @property
    def distributed(self) -> bool:
        """Whether the collectives go through ``torch.distributed``."""
        return self._backing is not None

    @property
    def spans_processes(self) -> bool:
        """True when the group's ranks live in more than one OS process."""
        return self.process_count > 1

    @property
    def member(self) -> bool:
        """False on a process that holds none of a sub-group's ranks
        (:func:`new_group`): its collectives raise."""
        return self.process_index >= 0

    @property
    def local_rows(self) -> range:
        """This process's ranks."""
        k = self.local_size
        return range(self.process_index * k, (self.process_index + 1) * k)

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

    def fork(self) -> "BaguaProcessGroup":
        """The same ranks on fresh ``torch.distributed`` communicators, for
        a thread whose collectives must not interleave with this group's
        (a collective call on every process)."""
        if not self.distributed:
            return self
        return BaguaProcessGroup(self.devices, None if self.mesh_spec is not None else self.intra_size,
                                 self.mesh_spec, distributed=True, processes=self.processes)

    @functools.cached_property
    def stacked(self) -> "BaguaProcessGroup":
        """The single-controller group of the same mesh, every rank on this
        process's device: the element transpose runs it on its columns."""
        if not self.distributed:
            return self
        return BaguaProcessGroup([self.device] * self.size,
                                 None if self.mesh_spec is not None else self.intra_size, self.mesh_spec)

    def __repr__(self) -> str:
        span = (f", process={self.process_index}/{self.process_count}, local={self.local_size}"
                if self.distributed else "")
        if self.mesh_spec is not None:
            return f"BaguaProcessGroup(size={self.size}, mesh={self.mesh_spec!r}, device={self.device}{span})"
        return (
            f"BaguaProcessGroup(size={self.size}, inter={self.inter_size}, "
            f"intra={self.intra_size}, device={self.device}{span})"
        )


def _members(group: BaguaProcessGroup, axes: Tuple[str, ...]) -> np.ndarray:
    """``(G, n)``: the ranks of each collective over ``axes``, member order
    (what :func:`_grouped` gives an ``arange`` of the ranks)."""
    names = group.all_axes
    order = [i for i, a in enumerate(names) if a not in axes] + [names.index(a) for a in axes]
    n = math.prod(group.shape[names.index(a)] for a in axes)
    return np.arange(group.size).reshape(group.shape).transpose(order).reshape(-1, n)


class _Backing:
    """The ``torch.distributed`` side of a group that spans processes: its
    communicators and the one exchange every collective goes through.

    Built in the same order on every process of the job, members of the
    group or not: a communicator of the group's processes, then for the
    whole mesh and for each axis, the process blocks whose ranks meet in a
    collective over it (the reference's global, inter and intra
    communicators on the legacy mesh); a block set equal to every process
    of the group shares the first communicator.  Processes are numbered
    within the group (``group.processes[q]`` is process q's
    ``torch.distributed`` rank)."""

    def __init__(self, group: BaguaProcessGroup):
        import torch.distributed as dist

        self.group = group
        everyone = tuple(range(group.process_count))
        #: bytes this process's collectives sent to each process (itself
        #: included), since the group was built
        self.sent: Dict[int, int] = {}
        self.world = (dist.new_group([group.processes[q] for q in everyone]), everyone)
        self.comms: Dict[frozenset, tuple] = {}
        made: Dict[tuple, tuple] = {}
        for axes in [group.all_axes] + [(a,) for a in group.all_axes]:
            key = frozenset(axes)
            if key in self.comms:
                continue
            blocks = self.blocks(axes)
            if blocks == (everyone,):
                self.comms[key] = self.world
                continue
            if blocks not in made:
                mine = None
                for b in blocks:  # every process makes every block's group, in order
                    pg = dist.new_group([group.processes[q] for q in b])
                    if group.process_index in b:
                        mine = (pg, b)
                made[blocks] = mine
            self.comms[key] = made[blocks]

    def blocks(self, axes) -> Tuple[Tuple[int, ...], ...]:
        """The processes joined by the collectives over ``axes``: the
        connected sets of the processes each collective's ranks live in."""
        k, W = self.group.local_size, self.group.process_count
        parent = list(range(W))

        def find(p):
            while parent[p] != p:
                parent[p] = parent[parent[p]]
                p = parent[p]
            return p

        for row in _members(self.group, tuple(axes)) // k:
            for q in row[1:]:
                parent[find(int(q))] = find(int(row[0]))
        out: Dict[int, List[int]] = {}
        for p in range(W):
            out.setdefault(find(p), []).append(p)
        return tuple(sorted(tuple(b) for b in out.values()))

    def comm(self, axes) -> tuple:
        """``(torch.distributed group, its processes)`` for a collective
        over ``axes``: the block's communicator where one was built, else
        (and for ``axes=None``) the global one."""
        return self.world if axes is None else self.comms.get(frozenset(axes), self.world)

    def exchange(self, axes, sends: Dict[int, torch.Tensor], recv_bytes: Dict[int, int]) -> Dict[int, torch.Tensor]:
        """One ``all_to_all_single`` of uint8 payloads among the processes
        of ``axes``' communicator: ``sends[q]`` goes to process q,
        ``recv_bytes[q]`` come from it (absent: nothing).  Returns the
        received payloads by process."""
        import torch.distributed as dist

        _check_member(self.group)
        pg, block = self.comm(axes)
        device = self.group.device
        parts = [sends.get(q) for q in block]
        in_splits = [0 if t is None else t.numel() for t in parts]
        out_splits = [int(recv_bytes.get(q, 0)) for q in block]
        nonempty = [t.reshape(-1) for t in parts if t is not None and t.numel()]
        if len(nonempty) == 1:
            send = nonempty[0]
        else:
            send = torch.cat(nonempty) if nonempty else torch.empty(0, dtype=torch.uint8, device=device)
        recv = torch.empty(sum(out_splits), dtype=torch.uint8, device=device)
        with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
            # equal splits go as None: the call then checks and records less
            dist.all_to_all_single(recv, send, group=pg,
                                   output_split_sizes=None if len(set(out_splits)) == 1 else out_splits,
                                   input_split_sizes=None if len(set(in_splits)) == 1 else in_splits)
        for q, n in zip(block, in_splits):
            self.sent[q] = self.sent.get(q, 0) + n
        return {q: t for q, t, s in zip(block, recv.split(out_splits), out_splits) if s}


def init_process_group(
    devices: Optional[Sequence] = None, intra_size: Optional[int] = None,
    mesh_spec: Optional[MeshSpec] = None, coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None, process_id: Optional[int] = None,
) -> BaguaProcessGroup:
    """Initialize the default process group.  Without ``devices`` it takes
    the visible CUDA device and raises where there is none; pass
    ``[torch.device("cpu")] * n`` to run n ranks on the CPU.

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` the group spans the job's processes (the JAX package's
    ``jax.distributed.initialize``): ``torch.distributed`` rendezvouses at
    ``tcp://<coordinator_address>``, over NCCL where the local device is a
    card and gloo on the CPU, and ``devices`` are this process's ranks (by
    default one, on the current card); every process passes as many.

    Without a coordinator, devices or mesh: one card is one rank; several
    visible cards raise, since each card needs a process of its own
    (``LAUNCH_COMMAND``).  With a ``mesh_spec`` and no ``devices`` the group
    is ``spec.size`` ranks on the current card (divided among the
    processes when a coordinator is given)."""
    global _default_group
    distributed = coordinator_address is not None
    if distributed:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_process_group: no CUDA device is visible; pass "
                "devices=[torch.device('cpu')] * n to run on the CPU"
            )
        here = torch.device("cuda", torch.cuda.current_device())
        if mesh_spec is not None:
            devices = [here] * mesh_share(mesh_spec, num_processes if distributed else 1)
        elif distributed or torch.cuda.device_count() == 1:
            devices = [here]
        else:
            raise RuntimeError(
                f"init_process_group: {torch.cuda.device_count()} cards are visible and a process "
                f"drives one; start a worker a card with `{LAUNCH_COMMAND}` and call "
                "bagua_tpu_torch.distributed.init_from_env() in each, or pass devices="
            )
    if distributed:
        import torch.distributed as dist

        device = _normalize(devices[0])
        if not dist.is_initialized():
            if device.type == "cuda":
                torch.cuda.set_device(device)
            dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                    init_method=f"tcp://{coordinator_address}",
                                    world_size=int(num_processes), rank=int(process_id))
        elif (dist.get_world_size(), dist.get_rank()) != (int(num_processes), int(process_id)):
            raise RuntimeError(f"torch.distributed is already up as process {dist.get_rank()} of "
                               f"{dist.get_world_size()}, not {process_id} of {num_processes}")
    _default_group = BaguaProcessGroup(devices, intra_size=intra_size, mesh_spec=mesh_spec,
                                       distributed=distributed)
    return _default_group


def mesh_share(mesh_spec: MeshSpec, processes: int) -> int:
    """The ranks of ``mesh_spec`` each of ``processes`` processes holds;
    raises ValueError where they do not divide evenly."""
    if mesh_spec.size % processes:
        raise ValueError(f"a mesh of {mesh_spec.size} ranks does not divide among {processes} processes")
    return mesh_spec.size // processes


def destroy_process_group() -> None:
    """Forget the default group and leave ``torch.distributed``'s job."""
    global _default_group
    _default_group = None
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


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
    legacy mesh or on ``mesh_spec``: rank i of the new group is
    ``ranks[i]``.

    On a group that spans processes every process calls it, with the same
    arguments, in the same order (it makes the new group's
    ``torch.distributed`` communicators).  ``ranks`` must list the ranks
    process by process, in increasing process order, every process that
    holds one holding equally many (:func:`subgroup_layout`); each member
    process then passes the stack of its own ranks of the new group, in
    the order listed.  A process that holds none gets a group whose
    collectives raise."""
    base = get_default_group()
    if base.distributed:
        if ranks is None:
            return BaguaProcessGroup(base.devices, intra_size=intra_size, mesh_spec=mesh_spec, distributed=True,
                                     processes=base.processes)
        members, k = subgroup_layout(base, ranks)
        return BaguaProcessGroup([base.device] * k, intra_size=intra_size, mesh_spec=mesh_spec, distributed=True,
                                 processes=[base.processes[q] for q in members])
    devices = base.devices if ranks is None else [base.devices[r] for r in ranks]
    return BaguaProcessGroup(devices, intra_size=intra_size, mesh_spec=mesh_spec)


def subgroup_layout(base: BaguaProcessGroup, ranks: Sequence[int]) -> Tuple[List[int], int]:
    """``(member processes, ranks a member process holds)`` of a group of
    ``ranks`` of the spanning ``base``; raises ValueError unless ``ranks``
    are distinct ranks of ``base`` listed process by process, in
    increasing process order, each member process holding equally many."""
    ranks = [int(r) for r in ranks]
    k = base.local_size
    rule = ("list distinct ranks process by process, in increasing process order, every process "
            f"that holds one holding equally many (process p holds ranks [p * {k}, (p + 1) * {k}))")
    if not ranks or len(set(ranks)) != len(ranks) or not all(0 <= r < base.size for r in ranks):
        raise ValueError(f"new_group({ranks}): not distinct ranks of a group of {base.size}: {rule}")
    owners = [r // k for r in ranks]
    members = sorted(set(owners))
    runs = [owners.count(q) for q in members]
    if owners != sorted(owners) or len(set(runs)) != 1:
        raise ValueError(f"new_group({ranks}): held by processes {owners}: {rule}")
    return members, runs[0]


def local_ranks(group: Optional[BaguaProcessGroup] = None) -> List[int]:
    """The ranks whose slices this process passes to the collectives, in
    the order of its stack's rows (every rank in a single-controller
    group)."""
    return list((group or get_default_group()).local_rows)


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
    if group.distributed:
        raise ValueError(f"{group!r} spans processes and has no whole stack here")
    order, shape = _layout(group, axis)
    rest = y.shape[2:]
    if order != sorted(order):
        inverse = [order.index(i) for i in range(len(order))]
        y = y.reshape(*shape, *rest).permute(*inverse, *range(len(order), len(order) + len(rest)))
    return y.reshape(group.size, *rest).contiguous()


def rank_id(group: BaguaProcessGroup, axis=None) -> torch.Tensor:
    """Each rank's member index within its collective over ``axis``: an
    int64 tensor of shape ``(size,)`` on the group's device (the stacked
    counterpart of the JAX package's per-rank ``rank_id``); on a group that
    spans processes ``(k,)``, this process's ranks' (no bytes move; the
    tensor is kept and shared, so do not write to it)."""
    if group.distributed:
        _check_member(group)
        axes = _resolve(group, axis)
        return _index(group, ("rank_id", axes), lambda: _member_index(group, axes)[list(group.local_rows)])
    n = axis_size(group, axis)
    ids = torch.arange(n, device=group.device).expand(group.size // n, n)
    return _ungrouped(ids, group, axis)


def ppermute_shift(
    x: torch.Tensor, shift: int, comm: Optional[BaguaProcessGroup] = None, axis=None
) -> torch.Tensor:
    """Ring shift: within each collective over ``axis``, the member with
    index i receives member (i - shift) mod n's slice.  Wire: each slice
    whose destination lives in another process, once: the native bytes."""
    group = comm or get_default_group()
    if _ir._tls.capture is not None:
        _ir.record_collective("ppermute", (x,), group, _resolve(group, axis))
    return _move(group, _resolve(group, axis), x, ("shift", int(shift) % axis_size(group, axis)))


def ppermute_apply(
    x: torch.Tensor, perm, comm: Optional[BaguaProcessGroup] = None, axis=None
) -> torch.Tensor:
    """An explicit permutation within each collective over ``axis``: for
    every ``(src, dst)`` pair of member indices, member dst receives member
    src's slice.  Members that no pair names as a destination receive
    zeros, as ``lax.ppermute`` gives them; a member may be the source and
    the destination of one pair each at most.  Wire: each paired slice
    whose destination lives in another process, once: the native bytes."""
    group = comm or get_default_group()
    if _ir._tls.capture is not None:
        _ir.record_collective("ppermute", (x,), group, _resolve(group, axis))
    n = axis_size(group, axis)
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute_apply: {perm} names a source or a destination twice")
    if not all(0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute_apply: {perm} names a member outside 0..{n - 1}")
    return _move(group, _resolve(group, axis), x, ("apply", tuple(perm)))


def broadcast_inplace(
    x: torch.Tensor, src_rank: int = 0, comm: Optional[BaguaProcessGroup] = None, axis=None
) -> torch.Tensor:
    """Every member of each collective over ``axis`` receives member
    ``src_rank``'s slice, as the JAX package computes it: a sum over the
    members of each slice masked to zeros but at ``src_rank``, so a NaN on
    another member does not reach the result, and a -0 at the source sums
    to +0.  Wire: the allreduce's (:func:`allreduce`)."""
    group = comm or get_default_group()
    me = rank_id(group, axis).reshape(-1, *([1] * (x.dim() - 1)))
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
    return _allreduce_by(send, functools.partial(_reduce_members, op=op), group, axis)


def _allreduce_by(send: torch.Tensor, reduce, group: BaguaProcessGroup, axis) -> torch.Tensor:
    """The stacked allreduce whose ``reduce`` maps the grouped ``(G, n,
    ...)`` stack to ``(G, ...)``."""
    g = _grouped(send, group, axis)
    red = reduce(g)
    return _ungrouped(red.unsqueeze(1).expand_as(g), group, axis)


def allreduce(
    send: torch.Tensor, op: ReduceOp = ReduceOp.AVG,
    comm: Optional[BaguaProcessGroup] = None, axis=None,
) -> torch.Tensor:
    """Allreduce of each rank's slice over ``axis``, with any
    :class:`ReduceOp`: SUM and AVG (the JAX package's ``psum`` and
    ``pmean``), MAX and MIN (``pmax``, ``pmin``), PRODUCT, and BOR, BAND
    and BXOR on integer or bool tensors, each folded over the members left
    to right (``communication.py:280-308``).  Wire, across processes: the
    fewer of the members' rows that other processes fold (none where a
    collective's members share a process) and the element transpose's 2 (W
    - 1) / W of the local stack, at most 2 (W - 1) / W k S: at one rank a
    process the native ring allreduce's 2 (W - 1) / W S."""
    return allreduce_many([send], op, comm, axis)[0]


def allreduce_many(
    sends: Sequence[torch.Tensor], op: ReduceOp = ReduceOp.AVG,
    comm: Optional[BaguaProcessGroup] = None, axis=None,
) -> List[torch.Tensor]:
    """:func:`allreduce` of each tensor of ``sends``, as ONE collective: the
    JAX package's variadic ``lax.psum`` over a tuple of leaves, one
    primitive whose operand bytes are the leaves' sum.  Each result is
    bitwise :func:`allreduce` of its tensor; wire: :func:`allreduce`'s of
    the tensors together, in one exchange."""
    group = comm or get_default_group()
    op = ReduceOp(op)
    if _ir._tls.capture is not None and sends:
        _ir.record_collective(_REDUCE_PRIMITIVE.get(op, "all_gather"), tuple(sends), group, _resolve(group, axis))
    if group.distributed:
        axes = _resolve(group, axis)
        if not sends:
            return []
        if _differentiable(*sends):
            if op not in (ReduceOp.SUM, ReduceOp.AVG):
                raise RuntimeError(f"allreduce {op.name} has no gradient on a group that spans processes; "
                                   "pass a tensor that does not require grad (detach it)")
            return list(_Reduce.apply(group, axes, op, *sends))
        return _span_reduce(group, sends, axes, functools.partial(_reduce_members, op=op))
    if op in (ReduceOp.SUM, ReduceOp.AVG) and _differentiable(*sends):
        return list(_Reduce.apply(group, _resolve(group, axis), op, *sends))
    return [_allreduce(s, op, group, axis) for s in sends]


def reduce_scatter(
    send: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
    comm: Optional[BaguaProcessGroup] = None, axis=None,
) -> torch.Tensor:
    """Reduce-scatter of each rank's slice over ``axis`` (SUM or AVG): the
    member with index i gets the reduced values of the i-th of n equal
    chunks of the slice's first dim.  Sums and divides as :func:`allreduce`
    does, so each chunk is bitwise that chunk of the allreduce.  Across
    processes it is that allreduce, keeping each rank's chunk; wire: the
    allreduce's, at one rank a process twice a native reduce-scatter's."""
    group = comm or get_default_group()
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        # the JAX package's reduce_scatter refuses the rest too
        raise NotImplementedError(f"reduce_scatter supports SUM and AVG, not {op.name}")
    if _ir._tls.capture is not None:
        _ir.record_collective("reduce_scatter", (send,), group, _resolve(group, axis))
    n, m = axis_size(group, axis), send.shape[1]
    if m % n:
        raise ValueError(f"reduce_scatter: dim {m} does not divide into {n} chunks")
    if _differentiable(send):
        return _ReduceScatter.apply(send, group, _resolve(group, axis), op)
    return _reduce_scatter_raw(group, send, _resolve(group, axis), op)


def _reduce_scatter_raw(group: BaguaProcessGroup, send: torch.Tensor, axes, op: ReduceOp) -> torch.Tensor:
    if group.distributed:
        return _span_reduce_scatter(group, send, axes, op)
    g = _grouped(send, group, axes)
    G, n, m = g.shape[:3]
    red = _reduce_members(g, op)
    return _ungrouped(red.reshape(G, n, m // n, *g.shape[3:]), group, axes)


def hierarchical_allreduce(
    send: torch.Tensor, op: ReduceOp = ReduceOp.AVG,
    comm: Optional[BaguaProcessGroup] = None,
) -> torch.Tensor:
    """Intra-axis reduce, then inter-axis reduce (the reference's
    hierarchical communicator).  AVG sums both phases and divides once, by
    the group size; every other op composes across the phases.  Wire: the
    two legs' (:func:`allreduce`); with intra inside a process (the JAX
    package's layout) the intra leg moves nothing."""
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
    member order.  Wire: each chunk whose destination lives in another
    process, once: the native bytes."""
    group = comm or get_default_group()
    if _ir._tls.capture is not None:
        _ir.record_collective("all_to_all", (send,), group, _resolve(group, axis))
    return _move(group, _resolve(group, axis), send, ("alltoall",))


def allgather(
    send: torch.Tensor, comm: Optional[BaguaProcessGroup] = None, axis=None
) -> torch.Tensor:
    """Each rank's output is every member's slice, concatenated along the
    first dim.  Wire: each slice once to every other process that holds a
    member of its collective: the native bytes."""
    group = comm or get_default_group()
    if _ir._tls.capture is not None:
        _ir.record_collective("all_gather", (send,), group, _resolve(group, axis))
    return _move(group, _resolve(group, axis), send, ("allgather",))


def _stacked_move(group: BaguaProcessGroup, axes: Tuple[str, ...], x: torch.Tensor, op: tuple) -> torch.Tensor:
    """A data mover on the single controller's whole stack (``op`` as
    :func:`_route_table` takes it)."""
    kind = op[0]
    g = _grouped(x, group, axes)
    if kind == "shift":
        return _ungrouped(torch.roll(g, op[1], dims=1), group, axes)
    G, n = g.shape[:2]
    if kind == "apply":
        # one gather (each slice copied once), then zeros where no pair arrives
        source = dict((d, s) for s, d in op[1])
        out = g[:, [source.get(d, d) for d in range(n)]]
        out[:, [d for d in range(n) if d not in source]] = 0
        return _ungrouped(out, group, axes)
    if kind == "alltoall":
        m = g.shape[2]
        if m % n:
            raise ValueError(f"alltoall: dim {m} does not divide into {n} chunks")
        chunks = g.reshape(G, n, n, m // n, *g.shape[3:])  # (G, src, dst, ...)
        return _ungrouped(chunks.transpose(1, 2).reshape(g.shape), group, axes)
    full = g.reshape(G, 1, n * g.shape[2], *g.shape[3:])
    return _ungrouped(full.expand(G, n, *full.shape[2:]), group, axes)


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
    ``recv_counts[r, j]`` rows.  Wire: two :func:`alltoall`'s (the padded
    chunks and the counts)."""
    group = comm or get_default_group()
    n = axis_size(group, axis)
    if x.dim() < 3 or x.shape[1] != n:
        raise ValueError(f"alltoall_v_inplace: x {tuple(x.shape)} needs (size, {n}, capacity, ...)")
    if tuple(send_counts.shape) != (group.local_size, n):
        raise ValueError(f"alltoall_v_inplace: send_counts {tuple(send_counts.shape)} "
                         f"!= ({group.local_size}, {n})")
    recv = alltoall(x.reshape(group.local_size, n * x.shape[2], *x.shape[3:]), group, axis)
    return recv.reshape(x.shape), alltoall(send_counts, group, axis)


# ---------------------------------------------------------------------------
# Collectives across processes: the local stack's rows in, the same rows of
# the stacked collective out
# ---------------------------------------------------------------------------


def _check_member(group: BaguaProcessGroup) -> None:
    if not group.member:
        raise RuntimeError(f"this process holds none of the ranks of {group!r}: only its member "
                           f"processes {list(group.processes)} run its collectives")


def _local_stack(group: BaguaProcessGroup, *xs: torch.Tensor) -> bool:
    """Check that each tensor is this process's ``(k, ...)`` stack; True
    when any lies on ``meta`` (a dry run, which moves no bytes)."""
    _check_member(group)
    for x in xs:
        if x.dim() == 0 or x.shape[0] != group.local_size:
            raise ValueError(f"leading dim {tuple(x.shape)[:1]} != this process's "
                             f"{group.local_size} ranks of {group.size}")
    return any(x.is_meta for x in xs)


def _cached(group: BaguaProcessGroup, key: tuple, make):
    table = group._tables.get(key)
    if table is None:
        table = group._tables[key] = make()
    return table


def _index(group: BaguaProcessGroup, key: tuple, make) -> torch.Tensor:
    """A constant int64 tensor on the group's device, made once (on meta in
    a dry run, and then not kept)."""
    t = group._tables.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(make(), dtype=np.int64)).to(group.device)
        if t.device != group.device:
            return t
        group._tables[key] = t
    return t


def _member_index(group: BaguaProcessGroup, axes: Tuple[str, ...]) -> np.ndarray:
    """``(size,)``: each rank's member index in its collective over ``axes``."""
    def make():
        m = _members(group, axes)
        out = np.empty(group.size, dtype=np.int64)
        out[m] = np.arange(m.shape[1])
        return out
    return _cached(group, ("member", axes), make)


def _bytes(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` as ``(rows, bytes)`` uint8."""
    flat = x.contiguous().reshape(rows, -1)
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def _typed(b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """uint8 rows back as ``like``'s dtype, in ``shape``."""
    b = b.contiguous()
    return (b if like.dtype == torch.uint8 else b.view(like.dtype)).reshape(shape)


def _pull(group: BaguaProcessGroup, axes, pieces: List[torch.Tensor], needs, P: int, key: tuple):
    """Every process fetches the pieces it needs.  ``pieces`` are this
    process's ``(k P, bytes)`` payloads, piece ``q`` of local rank ``i``
    being global piece ``(p k + i) P + q``; ``needs[p]`` the sorted global
    pieces process p reads.  One ``all_to_all_single`` carries each needed
    piece once from its owner (the owner's own pieces too, a copy).
    Returns, for each payload, ``(len(needs[me]), bytes)`` in ``needs[me]``
    order."""
    k, me = group.local_size, group.process_index
    kP = k * P
    widths = [t.shape[1] for t in pieces]
    B = sum(widths)
    cat = torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]

    def plan():
        """Per process of the communicator: which of my pieces it reads
        (None: every one, in order, sent without a copy) and how many of
        its pieces I read."""
        out = []
        for q in group._backing.comm(axes)[1]:
            ask = needs[q]
            mine = ask[ask // kP == me] - me * kP
            whole = len(mine) == kP and bool((mine == np.arange(kP)).all())
            out.append((q, len(mine), None if whole else mine, int((needs[me] // kP == q).sum())))
        return out

    sends, recv = {}, {}
    for q, n_send, mine, n_recv in _cached(group, key + ("pull",), plan):
        if n_send:
            sends[q] = cat if mine is None else cat.index_select(0, _index(group, key + ("send", q), lambda: mine))
        if n_recv:
            recv[q] = n_recv * B
    got = group._backing.exchange(axes, sends, recv)
    if not got:
        return [cat.new_empty((0, w)) for w in widths]
    buf = torch.cat([got[q].view(-1, B) for q in sorted(got)]) if len(got) > 1 else next(iter(got.values())).view(-1, B)
    return list(buf.split(widths, dim=1)) if len(widths) > 1 else [buf]


def _route_table(group: BaguaProcessGroup, axes: Tuple[str, ...], op: tuple):
    """``(P, src)`` of a data-moving collective: rank r's output is the
    concatenation of the input pieces ``src[r]`` (``-1``: zeros), each
    rank's slice cut into P pieces along its first dim."""
    m = _members(group, axes)
    G, n = m.shape
    if op[0] == "shift":
        return 1, m[:, (np.arange(n) - op[1]) % n].reshape(-1, 1)[np.argsort(m.reshape(-1))]
    if op[0] == "apply":
        source = dict((d, s) for s, d in op[1])
        src = np.full((G, n), -1, dtype=np.int64)
        for d, s in source.items():
            src[:, d] = m[:, s]
        return 1, src.reshape(-1, 1)[np.argsort(m.reshape(-1))]
    order = np.argsort(m.reshape(-1))  # rank -> its (g, i) position
    g_of, i_of = order // n, order % n
    if op[0] == "alltoall":
        return n, m[g_of] * n + i_of[:, None]
    if op[0] == "allgather":
        return 1, m[g_of]
    raise ValueError(op)


def _route(group: BaguaProcessGroup, axes: Tuple[str, ...], x: torch.Tensor, op: tuple) -> torch.Tensor:
    """A data-moving collective across processes: exactly the pieces this
    process's outputs read cross the wire, the native collective's bytes."""
    k = group.local_size
    meta = _local_stack(group, x)

    def plan():
        P, src = _route_table(group, axes, op)
        needs = [np.unique(s[s >= 0]) for s in np.split(src, group.process_count)]
        return P, src.shape[1], needs

    P, P_out, needs = _cached(group, ("route", axes, op), plan)
    if x.dim() == 1:
        if P_out > 1:
            raise ValueError("a collective that concatenates slices needs slices of one dim or more")
        out_shape = (k,)
    else:
        if x.shape[1] % P:
            raise ValueError(f"dim {x.shape[1]} does not divide into {P} chunks")
        out_shape = (k, P_out * (x.shape[1] // P), *x.shape[2:])
    if meta:
        return x.new_empty(out_shape)
    (buf,) = _pull(group, axes, [_bytes(x, k * P)], needs, P, ("route", axes, op))
    me = group.process_index

    def where():
        src = _route_table(group, axes, op)[1][group.local_rows].reshape(-1)
        pos = np.searchsorted(needs[me], src)
        pos[src < 0] = len(needs[me])
        return pos
    pos = _index(group, ("route", axes, op, "pos"), where)
    buf = torch.cat([buf, buf.new_zeros((1, buf.shape[1]))]) if (op[0] == "apply") else buf
    return _typed(buf.index_select(0, pos), x, out_shape)


def _reduce_plan(group: BaguaProcessGroup, axes: Tuple[str, ...]):
    """How a reduction over ``axes`` crosses processes: fetch the members'
    rows and fold here (``gather``), or the element transpose, whichever
    sends fewer rows out of the busiest process (ties: the fetch)."""
    def make():
        k, W = group.local_size, group.process_count
        m = _members(group, axes)
        owner = m // k
        needs, sent = [], np.zeros(W, dtype=np.int64)
        for p in range(W):
            rows = np.unique(m[(owner == p).any(axis=1)])
            needs.append(rows)
            for q in range(W):
                if q != p:
                    sent[q] += int((rows // k == q).sum())
        gather = int(sent.max()) <= 2 * (W - 1) * k / W
        if not gather:
            return False, None, None, None, False
        me = group.process_index
        mine = np.nonzero((owner == me).any(axis=1))[0]  # the collectives touching my ranks
        gpos = np.searchsorted(needs[me], m[mine])  # (G_p, n) rows of the fetched buffer
        order = np.argsort(m.reshape(-1)) // m.shape[1]  # rank -> its collective
        local = np.searchsorted(mine, order[list(group.local_rows)])
        # fetched in (G_p, n) order already: a view, no gather
        in_order = gpos.size == len(needs[me]) and bool((gpos.reshape(-1) == np.arange(gpos.size)).all())
        return True, needs, gpos, local, in_order
    return _cached(group, ("reduce", axes), make)


def _transpose(group: BaguaProcessGroup, parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """The element transpose's wire: ``parts[t]`` ``(W, rows, c)`` typed,
    row block j to process j; returns what each process sent here, ``(W,
    rows, c)`` in process order.  One ``all_to_all_single`` on the global
    communicator."""
    W = group.process_count
    blocks = [_bytes(t, W) for t in parts]
    widths = [b.shape[1] for b in blocks]
    cat = torch.cat(blocks, dim=1) if len(blocks) > 1 else blocks[0]
    got = group._backing.exchange(None, {j: cat[j] for j in range(W)}, {j: cat.shape[1] for j in range(W)})
    recv = torch.stack([got[j] for j in range(W)])
    out = recv.split(widths, dim=1) if len(widths) > 1 else [recv]
    return [_typed(b, t, t.shape) for b, t in zip(out, parts)]


def _span_reduce(group: BaguaProcessGroup, sends: Sequence[torch.Tensor], axes: Tuple[str, ...],
                 reduce) -> List[torch.Tensor]:
    """Each local stack of ``sends`` reduced over ``axes`` across
    processes: ``reduce`` maps a grouped ``(G, n, ...)`` stack of a
    collective's members, in member order, to ``(G, ...)``, and runs here
    on the rows of the collectives this process's ranks are in (or, under
    the element transpose, on the stacked group's columns), so the result
    is bitwise the stacked group's ``reduce``."""
    k = group.local_size
    if _local_stack(group, *sends):
        return [s.new_empty(s.shape) for s in sends]
    gather, needs, gpos, local, in_order = _reduce_plan(group, axes)
    if gather:
        bufs = _pull(group, axes, [_bytes(s, k) for s in sends], needs, 1, ("reduce", axes))
        out = []
        for buf, s in zip(bufs, sends):
            rows = _typed(buf, s, (buf.shape[0], *s.shape[1:]))
            grouped = (rows.reshape(*gpos.shape, *s.shape[1:]) if in_order
                       else rows[_index(group, ("reduce", axes, "gpos"), lambda: gpos)])
            out.append(reduce(grouped).index_select(0, _index(group, ("reduce", axes, "local"), lambda: local)))
        return out
    W = group.process_count
    cols = []
    for s in sends:
        flat = s.reshape(k, -1)
        c = -(-flat.shape[1] // W)
        if c * W != flat.shape[1]:
            flat = torch.cat([flat, flat.new_zeros((k, c * W - flat.shape[1]))], dim=1)
        cols.append(flat.reshape(k, W, c).transpose(0, 1))  # (W, k, c): chunk j of each rank
    recv = _transpose(group, cols)
    stacked = group.stacked
    reduced = [_allreduce_by(r.reshape(W * k, -1), reduce, stacked, axes).reshape(W, k, -1) for r in recv]
    back = _transpose(group, reduced)  # from process j: chunk j of my ranks
    return [b.transpose(0, 1).reshape(k, -1)[:, :s[0].numel()].reshape(s.shape) for b, s in zip(back, sends)]


def _span_reduce_scatter(group: BaguaProcessGroup, send: torch.Tensor, axes: Tuple[str, ...],
                         op: ReduceOp) -> torch.Tensor:
    """:func:`reduce_scatter` of a local stack: the allreduce, each rank
    keeping its chunk."""
    n, m = axis_size(group, axes), send.shape[1]
    (full,) = _span_reduce(group, [send], axes, functools.partial(_reduce_members, op=op))
    full = full.reshape(group.local_size, n, m // n, *send.shape[2:])
    return full[torch.arange(group.local_size, device=send.device), rank_id(group, axes)]


# ---------------------------------------------------------------------------
# Gradients across processes: each collective's backward is the transposed
# collective, folding as the stacked group's autograd does
# ---------------------------------------------------------------------------


def _differentiable(*xs: torch.Tensor) -> bool:
    """Whether autograd records a collective of ``xs`` through its own
    function (not for a functorch transform's wrapped tensors, whose
    collectives run under a ``vmap`` rule: ``models/_rank_ops.py``)."""
    return (torch.is_grad_enabled() and any(x.requires_grad for x in xs)
            and not any(torch._C._functorch.is_functorch_wrapped_tensor(x) for x in xs))


def _move(group: BaguaProcessGroup, axes: Tuple[str, ...], x: torch.Tensor, op: tuple) -> torch.Tensor:
    """A data mover on either kind of group, recorded by autograd (through
    :class:`_Move`) where ``x`` takes a gradient."""
    if _differentiable(x):
        return _Move.apply(x, group, axes, op)
    return _move_raw(group, axes, x, op)


def _move_raw(group: BaguaProcessGroup, axes: Tuple[str, ...], x: torch.Tensor, op: tuple) -> torch.Tensor:
    return _route(group, axes, x, op) if group.distributed else _stacked_move(group, axes, x, op)


class _Move(torch.autograd.Function):
    """A data mover whose backward is its transposed collective
    (:func:`_move_vjp`), on the single controller as across processes: the
    same contiguous cotangent in both, so whatever a model reduces from it
    downstream adds in the same order."""

    @staticmethod
    def forward(ctx, x, group, axes, op):
        ctx.group, ctx.axes, ctx.op = group, axes, op
        return _move_raw(group, axes, x, op)

    @staticmethod
    def backward(ctx, g):
        return _move_vjp(ctx.group, ctx.axes, ctx.op, g), None, None, None


def _move_vjp(group: BaguaProcessGroup, axes: Tuple[str, ...], op: tuple, g: torch.Tensor) -> torch.Tensor:
    """The cotangent of a mover's input: a shift's is the shift back, an
    all-to-all's the all-to-all back, a permutation's the inverse
    permutation (zeros where no pair arrives), an allgather's the SUM
    reduce-scatter of the cotangent, folded left to right in member order
    (autograd's own backward of the stacked ``expand`` sums by ``sum``,
    whose order depends on the tensor's layout: a group that spans
    processes could not reproduce it)."""
    n = axis_size(group, axes)
    kind = op[0]
    g = g.contiguous()
    if kind == "shift":
        return _move_raw(group, axes, g, ("shift", -op[1] % n))
    if kind == "alltoall":
        return _move_raw(group, axes, g, ("alltoall",))
    if kind == "apply":
        return _move_raw(group, axes, g, ("apply", tuple((d, s) for s, d in op[1])))
    return _reduce_scatter_raw(group, g, axes, ReduceOp.SUM)


def _fold_sum(group: BaguaProcessGroup, sends: Sequence[torch.Tensor], axes: Tuple[str, ...]) -> List[torch.Tensor]:
    """The SUM allreduce of each tensor, folded left to right in member
    order, on either kind of group (no gradient)."""
    if group.distributed:
        return _span_reduce(group, sends, axes, functools.partial(_reduce_members, op=ReduceOp.SUM))
    return [_allreduce(s, ReduceOp.SUM, group, axes) for s in sends]


class _Reduce(torch.autograd.Function):
    """:func:`allreduce_many` (SUM or AVG) on either kind of group, with
    its transposed collective as the backward: the SUM allreduce of the
    cotangents, folded left to right in member order (divided by n under
    AVG), so a group that spans processes computes the very rows the
    single controller does (autograd's own backward of the stacked
    ``expand`` sums by ``sum``, whose order depends on the layout)."""

    @staticmethod
    def forward(ctx, group, axes, op, *sends):
        ctx.group, ctx.axes, ctx.op = group, axes, op
        if group.distributed:
            outs = _span_reduce(group, sends, axes, functools.partial(_reduce_members, op=op))
        else:
            outs = [_allreduce(s, op, group, axes) for s in sends]
        ctx.mark_non_differentiable(*[o for o in outs if not (o.is_floating_point() or o.is_complex())])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cts):
        need = ctx.needs_input_grad[3:]
        idx = [i for i, n in enumerate(need) if n]
        n = axis_size(ctx.group, ctx.axes)
        sums = _fold_sum(ctx.group, [cts[i].contiguous() for i in idx], ctx.axes)
        if ctx.op == ReduceOp.AVG:
            sums = [t / torch.full_like(t, n) for t in sums]
        grads = [None] * len(need)
        for i, t in zip(idx, sums):
            grads[i] = t
        return (None, None, None, *grads)


class _ReduceScatter(torch.autograd.Function):
    """:func:`reduce_scatter` on either kind of group, with its transposed
    collective as the backward: the allgather of the cotangents (divided by
    n under AVG)."""

    @staticmethod
    def forward(ctx, send, group, axes, op):
        ctx.group, ctx.axes, ctx.op = group, axes, op
        return _reduce_scatter_raw(group, send, axes, op)

    @staticmethod
    def backward(ctx, ct):
        full = _move_raw(ctx.group, ctx.axes, ct.contiguous(), ("allgather",))
        if ctx.op == ReduceOp.AVG:
            full = full / torch.full_like(full, axis_size(ctx.group, ctx.axes))
        return full, None, None, None


# ---------------------------------------------------------------------------
# The eager user API under the reference's names (``bagua_tpu/communication.py
# :439-646``): collectives over every rank of a group, rank-stacked
# ---------------------------------------------------------------------------


def reducescatter(
    send: torch.Tensor, op: ReduceOp = ReduceOp.SUM, comm: Optional[BaguaProcessGroup] = None
) -> torch.Tensor:
    """Rank r gets the r-th of ``size`` chunks of the reduced slices
    (reference ``communication.py:1219``): :func:`reduce_scatter` over
    every rank, and its wire."""
    group = comm or get_default_group()
    return reduce_scatter(send, op, group, group.all_axes)


def broadcast(send: torch.Tensor, src: int = 0, comm: Optional[BaguaProcessGroup] = None) -> torch.Tensor:
    """Every rank gets rank ``src``'s slice (reference
    ``communication.py:573``), as :func:`broadcast_inplace` computes it,
    with its wire."""
    group = comm or get_default_group()
    return broadcast_inplace(send, src, group, group.all_axes)


def _at_rank(group: BaguaProcessGroup, rank: int, ndim: int) -> torch.Tensor:
    """``(size, 1, ...)`` bool: True on ``rank``'s slice."""
    return (rank_id(group, group.all_axes) == rank).reshape(-1, *([1] * (ndim - 1)))


def reduce(
    send: torch.Tensor, dst: int = 0, op: ReduceOp = ReduceOp.AVG,
    comm: Optional[BaguaProcessGroup] = None,
) -> torch.Tensor:
    """Rank ``dst`` gets the reduction of every slice; the other ranks keep
    their own (reference ``communication.py:958``).  Wire: the
    allreduce's."""
    group = comm or get_default_group()
    return torch.where(_at_rank(group, dst, send.dim()), allreduce(send, op, group, group.all_axes), send)


def scatter(send: torch.Tensor, src: int = 0, comm: Optional[BaguaProcessGroup] = None) -> torch.Tensor:
    """Rank ``src``'s slice cut into ``size`` chunks along its first dim;
    rank i gets chunk i (reference ``communication.py:1155``).  Wire: the
    broadcast's."""
    group = comm or get_default_group()
    n, m, k = group.size, send.shape[1], group.local_size
    if m % n:
        raise ValueError(f"scatter: dim {m} does not divide into {n} chunks")
    full = broadcast_inplace(send, src, group, group.all_axes)
    chunks = full.reshape(k, n, m // n, *send.shape[2:])
    return chunks[torch.arange(k, device=send.device), rank_id(group, group.all_axes)]


def gather(send: torch.Tensor, dst: int = 0, comm: Optional[BaguaProcessGroup] = None) -> torch.Tensor:
    """Rank ``dst`` gets every slice, concatenated along the first dim; the
    other ranks get zeros, as the JAX package gives them (reference
    ``communication.py:1081`` leaves their buffers as they were).  Wire:
    the allgather's."""
    group = comm or get_default_group()
    full = allgather(send, group, group.all_axes)
    return torch.where(_at_rank(group, dst, full.dim()), full, torch.zeros_like(full))


def barrier(comm: Optional[BaguaProcessGroup] = None) -> None:
    """Returns once every collective issued on the group has finished: on
    a card, a synchronize of the group's device (reference
    ``communication.py:1377-1401``); on the CPU every call has already
    run.  A group that spans processes first exchanges one byte with
    every process of the group (its wire), so none returns before all have
    reached it."""
    group = comm or get_default_group()
    if group.distributed:
        W = group.process_count
        token = torch.ones((W, 1), dtype=torch.uint8, device=group.device)
        group._backing.exchange(None, {q: token[q] for q in range(W)}, {q: 1 for q in range(W)})
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)


def broadcast_object(obj, src: int = 0, comm: Optional[BaguaProcessGroup] = None):
    """Process ``src``'s object on every process (reference
    ``communication.py:668``; the JAX package's ``src`` is a process
    index too).  On a single-controller group every rank's object is
    already this one, as the JAX package returns it in a single process;
    across processes the pickled bytes ride the group's exchange (wire: 8
    bytes to every process, then ``src`` sends the pickle to each)."""
    group = comm if comm is not None else (_default_group if _default_group is not None else None)
    if group is None or not group.distributed:
        return obj
    W, me = group.process_count, group.process_index
    if not 0 <= src < W:
        raise ValueError(f"broadcast_object: src {src} is not a process of {W}")
    backing = group._backing
    size = torch.tensor([len(pickle.dumps(obj)) if me == src else 0], dtype=torch.int64)
    sizes = backing.exchange(None, {q: _bytes(size, 1)[0].to(group.device) for q in range(W)}, {q: 8 for q in range(W)})
    n = int(sizes[src].cpu().view(torch.int64)[0])
    payload = (torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8).to(group.device)
               if me == src else None)
    got = backing.exchange(None, {q: payload for q in range(W)} if me == src else {}, {src: n})
    return pickle.loads(got[src].cpu().numpy().tobytes())
