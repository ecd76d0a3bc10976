"""Launchers (the port of ``bagua_tpu/distributed/``): the elastic launcher
(``python -m bagua_tpu_torch.distributed.run``), its rendezvous store and
the multi-host fan-out (``python -m bagua_tpu_torch.distributed.baguarun``)."""


def init_from_env(devices=None, intra_size=None):
    """Initialize the default process group from the launcher's exported
    environment (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
    ``MASTER_ADDR`` / ``MASTER_PORT``), the worker half of
    :mod:`bagua_tpu_torch.distributed.run`.

    With ``WORLD_SIZE`` unset or 1 this is one controller driving every
    rank of the group: the visible card, or ``devices`` when given (e.g.
    ``[torch.device("cpu")] * n``).  With ``WORLD_SIZE > 1`` the group
    spans the job's processes (one per card, ``--nproc_per_node``):
    ``torch.distributed`` rendezvouses at ``MASTER_ADDR:MASTER_PORT`` as
    process ``RANK``, over NCCL with this process's one rank on
    ``cuda:LOCAL_RANK``, or over gloo where ``devices`` are CPU devices
    (this process's ranks; every process passes as many)."""
    import os

    from bagua_tpu_torch.communication import init_process_group

    world_size = int(os.environ.get("WORLD_SIZE", 1))
    if world_size <= 1:
        return init_process_group(devices, intra_size=intra_size)
    if devices is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("init_from_env: WORLD_SIZE > 1 and no card is visible; pass this "
                               "process's CPU devices to run the gang on gloo")
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        devices = [local]
    address = f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:{os.environ.get('MASTER_PORT', '29500')}"
    return init_process_group(devices, intra_size=intra_size, coordinator_address=address,
                              num_processes=world_size, process_id=int(os.environ.get("RANK", 0)))
