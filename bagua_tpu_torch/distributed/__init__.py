"""The port's launcher side: the worker half of the launcher
(``python -m bagua_tpu_torch.distributed.run``), its rendezvous store and
the multi-host fan-out (``python -m bagua_tpu_torch.distributed.baguarun``)."""

import os


def launched() -> bool:
    """Whether this process is a gang worker: the launcher (or a test that
    starts the workers itself) exported ``MASTER_PORT``."""
    return "MASTER_PORT" in os.environ


def init_gang(devices=None, intra_size=None, mesh_spec=None):
    """The default process group of a gang worker: it spans the
    ``WORLD_SIZE`` processes the launcher started, through
    ``torch.distributed`` even in a gang of one, rendezvousing at
    ``MASTER_ADDR:MASTER_PORT`` as process ``RANK``; NCCL where this
    process's ranks are on a card, gloo on the CPU.  ``devices``: this
    process's ranks; by default the card ``cuda:LOCAL_RANK``, once, or on
    ``mesh_spec`` once for each of its ranks this process holds (a raise
    where no card is visible)."""
    from bagua_tpu_torch.communication import init_process_group

    if devices is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("init_from_env: a gang worker and no card is visible; pass this "
                               "process's CPU devices to run the gang on gloo")
        torch.cuda.set_device(torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))))
    address = f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:{os.environ.get('MASTER_PORT', '29500')}"
    return init_process_group(devices, intra_size=intra_size, mesh_spec=mesh_spec, coordinator_address=address,
                              num_processes=int(os.environ.get("WORLD_SIZE", 1)),
                              process_id=int(os.environ.get("RANK", 0)))


def init_from_env(devices=None, intra_size=None, mesh_spec=None):
    """Initialize the default process group from the launcher's exported
    environment (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
    ``MASTER_ADDR`` / ``MASTER_PORT``), the worker half of
    :mod:`bagua_tpu_torch.distributed.run`, on the legacy mesh or on
    ``mesh_spec``.

    With ``WORLD_SIZE`` unset or 1 this is one controller driving every
    rank of the group: the visible card (``mesh_spec.size`` times on a
    mesh), or ``devices`` when given (e.g. ``[torch.device("cpu")] * n``).
    With ``WORLD_SIZE > 1`` the group spans the job's processes (one per
    card, ``--nproc_per_node``): :func:`init_gang`, ``devices`` being this
    process's ranks (every process passes as many; by default its card,
    once for each rank it holds)."""
    from bagua_tpu_torch.communication import init_process_group

    if int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return init_process_group(devices, intra_size=intra_size, mesh_spec=mesh_spec)
    return init_gang(devices, intra_size=intra_size, mesh_spec=mesh_spec)


def mesh_group(mesh_spec, device):
    """The group of ``mesh_spec`` a twin trains on, set as the default, its
    ranks on ``device``: a gang worker's (:func:`launched`) spans the gang
    even at ``WORLD_SIZE`` 1 (:func:`init_gang`), this process holding its
    share of the mesh's ranks; otherwise :func:`init_from_env`'s."""
    from bagua_tpu_torch.communication import mesh_share

    if launched():
        return init_gang([device] * mesh_share(mesh_spec, int(os.environ.get("WORLD_SIZE", 1))),
                         mesh_spec=mesh_spec)
    return init_from_env([device] * mesh_spec.size, mesh_spec=mesh_spec)
