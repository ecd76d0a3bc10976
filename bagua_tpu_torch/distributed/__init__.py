"""Launchers (the port of ``bagua_tpu/distributed/``): the elastic launcher
(``python -m bagua_tpu_torch.distributed.run``), its rendezvous store and
the multi-host fan-out (``python -m bagua_tpu_torch.distributed.baguarun``)."""


def init_from_env(devices=None, intra_size=None):
    """Initialize the default process group from the launcher's exported
    environment (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
    ``MASTER_PORT``), the worker half of
    :mod:`bagua_tpu_torch.distributed.run`.

    With ``WORLD_SIZE`` unset or 1 this is one controller driving every
    rank of the group: the visible cards, or ``devices`` when given (e.g.
    ``[torch.device("cpu")] * n``).  ``WORLD_SIZE > 1`` (one process per
    GPU over NCCL) raises until ROADMAP Queue 1 item 10."""
    from bagua_tpu_torch.communication import init_process_group
    from bagua_tpu_torch.env import get_world_size

    world_size = get_world_size()
    if world_size > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world_size}: one process per GPU over NCCL is not ported yet "
            "(ROADMAP Queue 1 item 10); launch one worker process, which drives every rank"
        )
    return init_process_group(devices, intra_size=intra_size)
