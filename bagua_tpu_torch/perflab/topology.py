"""The single link model of the port: NVLink inside an H100 host, the
network between hosts.

The port of ``bagua_tpu/perflab/topology.py``, whose TPU torus (ICI inside
a pod, DCN between pods) becomes an H100 fleet: the GPUs of one HGX host
share one NVLink domain, and a collective that spans hosts crosses the
network.  The fields keep the JAX package's names, so a caller of either
reads the same model: ``ici_*`` is NVLink, ``pod_size`` the GPUs of one
NVLink domain (one host), ``dcn_*`` the network.  Every number is an
**assumption** taken from NVIDIA's data sheets for the H100 SXM (NVIDIA
H100 80GB HBM3), not a measurement: NVLink 4 gives a GPU 900 GB/s over
both directions (450 GB/s each way), and the reference host pairs each
GPU with one 400 Gb/s NDR InfiniBand port (50 GB/s).

The collective shapes are the planner's ring models (and the CollectiveIR's
``primitive_wire_bytes``): an all-reduce moves ``2N(n-1)/n`` per GPU, a
reduce-scatter/all-to-all ``N(n-1)/n``, an all-gather ``N(n-1)``, and a
neighbour permute ``N`` over one hop.  NCCL's rings run ``n - 1`` hops per
leg, so the latency term is a ring's (the torus's diameter in the JAX
package).  Beyond one host the exchange crosses the network with no
overlap credit (a worst-case bound, not a prediction of a tuned
multi-host schedule).
"""

import dataclasses

__all__ = [
    "DEFAULT_TOPOLOGY",
    "TopologyAssumptions",
    "ring_hops",
    "t_axis_collective",
    "t_collective",
]


@dataclasses.dataclass(frozen=True)
class TopologyAssumptions:
    """Explicit, falsifiable fleet-topology parameters (H100 SXM hosts;
    data-sheet figures, assumed)."""

    #: NVLink bandwidth per GPU, one direction, B/s (NVLink 4: 900 GB/s
    #: over both directions, data sheet)
    ici_bw_chip: float = 450e9
    #: per-hop NVLink latency, seconds (assumed)
    ici_lat_hop: float = 2e-6
    #: fraction of the step a collective can hide behind (the backward)
    overlap_window_frac: float = 2 / 3
    #: GPUs in one NVLink domain (one HGX host); beyond it the network enters
    pod_size: int = 8
    #: network bandwidth per host, B/s: one 400 Gb/s NDR port per GPU
    dcn_bw_host: float = 8 * 50e9
    #: GPUs sharing one host's network ports
    chips_per_host: int = 8
    #: async averager: steps per sync interval (amortization)
    steps_per_interval: int = 20

    def dcn_bw_chip(self) -> float:
        """Per-GPU share of the host's network bandwidth."""
        return self.dcn_bw_host / self.chips_per_host

    def axis_link(self, axis: str, within_pod: bool = False) -> str:
        """The physical link one named mesh axis's collectives ride:
        model axes (tp/sp/ep/...) and the legacy ``intra`` axis are packed
        inside a host and ride NVLink; data axes span hosts and ride the
        network, unless the whole gang fits one host (``within_pod``).
        ``nvlink`` or ``network`` (the JAX package's ``ici``/``dcn``)."""
        from bagua_tpu_torch.mesh import MODEL_AXIS_NAMES

        if axis == "intra" or axis in MODEL_AXIS_NAMES or within_pod:
            return "nvlink"
        return "network"

    def describe(self) -> dict:
        return {
            "card": "NVIDIA H100 80GB HBM3 (SXM), data-sheet assumptions",
            "nvlink_bw_per_gpu_GBps": self.ici_bw_chip / 1e9,
            "nvlink_lat_per_hop_us": self.ici_lat_hop * 1e6,
            "overlap_window_frac_of_step": self.overlap_window_frac,
            "gpus_per_nvlink_domain": self.pod_size,
            "network_GBps_per_host": self.dcn_bw_host / 1e9,
            "gpus_per_host": self.chips_per_host,
            "async_steps_per_interval": self.steps_per_interval,
            "collective_model": (
                "ring: allreduce 2(n-1)/n, gather/a2a (n-1)/n, permute 1 hop; "
                "n-1 hops of latency a leg; beyond one host adds "
                "wire_bytes / network bandwidth per GPU with no overlap credit"
            ),
        }


DEFAULT_TOPOLOGY = TopologyAssumptions()


def ring_hops(n: int) -> int:
    """Hops of one leg of a ring over ``n`` GPUs (the torus's diameter in
    the JAX package)."""
    return max(0, int(n) - 1)


def t_collective(
    kind: str,
    bytes_per_chip: float,
    n: int,
    topo: TopologyAssumptions = DEFAULT_TOPOLOGY,
) -> float:
    """Per-GPU time of one collective over ``n`` GPUs on an NVLink ring."""
    if n <= 1:
        return 0.0
    lat = ring_hops(n) * topo.ici_lat_hop
    if kind == "allreduce":
        return 2 * (n - 1) / n * bytes_per_chip / topo.ici_bw_chip + 2 * lat
    if kind in ("allgather", "alltoall", "reducescatter"):
        return (n - 1) / n * bytes_per_chip / topo.ici_bw_chip + lat
    if kind == "permute":  # neighbour exchange: one hop, n-independent
        return bytes_per_chip / topo.ici_bw_chip + topo.ici_lat_hop
    raise ValueError(kind)


def t_axis_collective(
    kind: str,
    bytes_per_chip: float,
    n: int,
    axis: str,
    topo: TopologyAssumptions = DEFAULT_TOPOLOGY,
    within_pod: bool = False,
) -> float:
    """Per-GPU time of one collective riding a *named mesh axis* of size
    ``n``: the axis's :meth:`TopologyAssumptions.axis_link` picks the wire.
    NVLink legs reuse :func:`t_collective`'s ring; network legs pay the
    same ring byte factor on the per-GPU network share with no latency term
    (a worst-case bound, as the JAX package's DCN legs)."""
    if n <= 1:
        return 0.0
    if topo.axis_link(axis, within_pod) == "nvlink":
        return t_collective(kind, bytes_per_chip, n, topo)
    if kind == "allreduce":
        factor = 2 * (n - 1) / n
    elif kind in ("allgather", "alltoall", "reducescatter"):
        factor = (n - 1) / n
    elif kind == "permute":
        factor = 1.0
    else:
        raise ValueError(kind)
    return factor * bytes_per_chip / topo.dcn_bw_chip()
