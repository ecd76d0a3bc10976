"""Named mesh specification: one mesh of ranks, per-axis roles (the port of
``bagua_tpu/mesh.py``, a copy: the JAX package's ``__init__`` imports JAX).

The engine historically ran on a fixed 2-D ``("inter", "intra")`` group where
*every* axis carried the data-parallel exchange.  :class:`MeshSpec` makes the
mesh explicit -- an ordered mapping of axis names to sizes, e.g.
``{"dp": 4, "tp": 2}`` -- and assigns each axis a *role*:

* **data axes** -- the batch shards over them and the bucketed gradient
  exchange (all-reduce / ZeRO rs+ag / quantized rings) rides them.  ``dp``
  and ``fsdp`` are data axes: FSDP is "ZeRO over one more mesh axis", so its
  axis joins the exchange ring (the reduce-scatter shards params/optimizer
  state over ``dp x fsdp`` jointly).
* **model axes** -- params/activations shard over them (``tp``/``sp``/``ep``/
  ``pp``); the engine's exchange must never touch them.  Collectives on these
  axes are issued by the model itself (``parallel/*``).

Role inference is by name (the table below), overridable with explicit
``dp_axis``/``fsdp_axis``/``tp_axis`` keywords -- which are *validated against
the declared axes at construction*, mirroring ``_check_ep_axes`` in
``parallel/moe/layer.py``: a typo'd axis name raises immediately instead of
silently replicating the exchange or failing deep inside a step.

A group's ranks lie on the mesh row-major: rank ``r`` has the coordinates
``numpy.unravel_index(r, spec.shape)``, as a JAX mesh built from
``devices.reshape(spec.shape)`` places device ``r``.
"""

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["MeshSpec", "DATA_AXIS_NAMES", "MODEL_AXIS_NAMES"]

#: axis names inferred as data (exchange) axes
DATA_AXIS_NAMES = ("dp", "data", "fsdp", "inter", "intra")
#: axis names inferred as model axes
MODEL_AXIS_NAMES = ("tp", "sp", "ep", "pp", "model", "expert", "seq", "pipe")


def _none_of_declared(kw: str, value, declared: Tuple[str, ...]) -> ValueError:
    return ValueError(
        f"none of the declared mesh axes {declared} match {kw}={value!r} — "
        f"check the {kw} spelling against the mesh axis names (a typo here "
        f"would silently replicate the exchange instead of sharding it)"
    )


class MeshSpec:
    """Ordered named mesh axes with sizes and per-axis roles.

    Args:
        axes: ordered ``name -> size`` mapping (a dict preserves insertion
            order) or a sequence of ``(name, size)`` pairs.  Order is the
            device-mesh order (leftmost = outermost).
        dp_axis: explicitly mark one or more axes as the data-parallel
            exchange axes (str or sequence of str).
        fsdp_axis: explicitly mark one or more axes as FSDP axes — they join
            the data axes (the exchange ring spans ``dp × fsdp``).
        tp_axis: explicitly mark one or more axes as model axes.

    Every explicit keyword must name a declared axis; otherwise a
    none-of-the-declared-axes ``ValueError`` is raised at construction.
    """

    def __init__(
        self,
        axes: Union[Mapping[str, int], Sequence[Tuple[str, int]]],
        *,
        dp_axis: Optional[Union[str, Sequence[str]]] = None,
        fsdp_axis: Optional[Union[str, Sequence[str]]] = None,
        tp_axis: Optional[Union[str, Sequence[str]]] = None,
    ):
        if isinstance(axes, Mapping):
            items = list(axes.items())
        else:
            items = [(str(n), int(s)) for n, s in axes]
        if not items:
            raise ValueError("MeshSpec needs at least one axis")
        names = tuple(str(n) for n, _ in items)
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names in {names}")
        sizes = {}
        for n, s in items:
            s = int(s)
            if s < 1:
                raise ValueError(f"mesh axis {n!r} has non-positive size {s}")
            sizes[str(n)] = s
        self.names: Tuple[str, ...] = names
        self.sizes: Dict[str, int] = sizes

        def norm(kw, value):
            if value is None:
                return ()
            tup = (value,) if isinstance(value, str) else tuple(value)
            for a in tup:
                if a not in names:
                    raise _none_of_declared(kw, a, names)
            return tuple(str(a) for a in tup)

        explicit_dp = norm("dp_axis", dp_axis)
        explicit_fsdp = norm("fsdp_axis", fsdp_axis)
        explicit_tp = norm("tp_axis", tp_axis)
        overlap = set(explicit_dp + explicit_fsdp) & set(explicit_tp)
        if overlap:
            raise ValueError(
                f"mesh axes {sorted(overlap)} declared both data (dp_axis/"
                f"fsdp_axis) and model (tp_axis) — an axis has exactly one role"
            )

        data, model = [], []
        for n in names:
            if n in explicit_dp or n in explicit_fsdp:
                data.append(n)
            elif n in explicit_tp:
                model.append(n)
            elif n in DATA_AXIS_NAMES:
                data.append(n)
            elif n in MODEL_AXIS_NAMES:
                model.append(n)
            else:
                raise ValueError(
                    f"mesh axis {n!r} has no inferable role (known data axes "
                    f"{DATA_AXIS_NAMES}, model axes {MODEL_AXIS_NAMES}) — "
                    f"name it explicitly via dp_axis/fsdp_axis/tp_axis"
                )
        if not data:
            raise ValueError(
                f"none of the declared mesh axes {names} carry the data-"
                f"parallel exchange — declare at least one via dp_axis/"
                f"fsdp_axis (the engine's bucketed exchange needs an axis "
                f"to ride)"
            )
        self.data_axes: Tuple[str, ...] = tuple(data)
        self.model_axes: Tuple[str, ...] = tuple(model)
        self.fsdp_axes: Tuple[str, ...] = tuple(
            n for n in data if n in explicit_fsdp or n == "fsdp"
        )

    # -- derived -------------------------------------------------------------

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes.values():
            n *= s
        return n

    @property
    def exchange_size(self) -> int:
        """Ranks in the gradient-exchange ring: product of the data axes."""
        n = 1
        for a in self.data_axes:
            n *= self.sizes[a]
        return n

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.sizes[a] for a in self.names)

    def device_array(self, devices: Sequence) -> np.ndarray:
        """The devices (``torch.device`` objects, one per rank) on the
        mesh's shape, rank ``r`` at ``numpy.unravel_index(r, shape)``."""
        devices = list(devices)
        if len(devices) != self.size:
            raise ValueError(
                f"MeshSpec {dict(self.sizes)} needs {self.size} devices, "
                f"got {len(devices)}"
            )
        arr = np.empty(len(devices), dtype=object)
        arr[:] = devices
        return arr.reshape(self.shape)

    def validate_axis(self, kw: str, value: Optional[Union[str, Sequence[str]]]):
        """Validate an axis-name override against the declared axes (the
        Trainer/DDP ``dp_axis``/``tp_axis``/``fsdp_axis`` keywords)."""
        if value is None:
            return None
        tup = (value,) if isinstance(value, str) else tuple(value)
        for a in tup:
            if a not in self.names:
                raise _none_of_declared(kw, a, self.names)
        return tuple(tup)

    def describe(self) -> Dict:
        return {
            "axes": dict(self.sizes),
            "data_axes": list(self.data_axes),
            "model_axes": list(self.model_axes),
            "exchange_size": self.exchange_size,
        }

    def __eq__(self, other):
        return (
            isinstance(other, MeshSpec)
            and self.names == other.names
            and self.sizes == other.sizes
            and self.data_axes == other.data_axes
        )

    def __hash__(self):
        return hash((self.names, tuple(self.sizes.items()), self.data_axes))

    def __repr__(self) -> str:
        ax = ", ".join(f"{n}={self.sizes[n]}" for n in self.names)
        return f"MeshSpec({ax}; data={self.data_axes}, model={self.model_axes})"
