"""``chip_smoke.py``'s ``[resil]`` phase four times in one process, with the
snapshot writer's npz routine swapped in turns: ``np.savez``,
:func:`~bagua_tpu_torch.resilience.snapshot.save_npz`, ``save_npz``,
``np.savez``.  Each turn prints ``[resil]``'s lines: ms/step with the
snapshotter off and on, the on-turn steps that started with the writer
busy, the writer's wall time, the drain's and the resume's.  The first
turn also runs ``[resil-ref]``.

Run on one CUDA card from the root of the repo (it builds the codec
kernels first)::

    python3 chip_snapshot_ab.py
"""

import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from bagua_tpu_torch.resilience import snapshot


def savez(f, arrays):
    """The writer as ``np.savez`` writes it (the same archive entries)."""
    np.savez(f, **{f"leaf_{i:05d}": a for i, a in enumerate(arrays)})


def main() -> int:
    cs.phase_device()
    cs.phase_build()
    device = torch.device("cuda", 0)
    writers = [("np.savez", savez), ("save_npz", snapshot.save_npz)]
    for i, (name, fn) in enumerate([writers[0], writers[1], writers[1], writers[0]]):
        snapshot.save_npz = fn
        if i:
            cs.check_resil_on_card = lambda device: None
        print(f"[ab] writer {name}", flush=True)
        t0 = time.perf_counter()
        cs.phase_resil(device, False)
        print(f"[ab] writer {name}: the phase took {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
