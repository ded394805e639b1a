#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 26 on every card of one host.

Run from the repository root on a machine with two or more NVIDIA GPUs:

    python3 chip_parallel.py

It builds the kernels, runs phase 6's main path for its weights and canvas,
then ``chip_smoke.parallel_phase`` with the world size set to the number of
cards: (a) world 1 in this process on NCCL; (b) one process per card (NCCL
when a two-rank probe on two cards succeeds), rank r on card r: the
tile-sharded continent, the band-distributed product, the data-parallel
step at 128 / world rows per rank, the channel-parallel forward on a
(1, world) mesh and the CLI's ``continent --mesh-devices`` and
``--multihost``, each against its one-device counterpart. Prints the
cards' name and power limit, the phase's numbers as one JSON line, and the
device line last. Refuses to run without two CUDA devices.
"""

from __future__ import annotations

import json
import sys
import tempfile

import chip_smoke as cs


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        raise SystemExit("chip_parallel.py: needs two or more CUDA devices")
    from deepbedmap_tpu_torch.ops import _kernels

    world = torch.cuda.device_count()
    card_name = cs.card()
    cs.log(f"{card_name} x {world}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.library()
    path = cs.main_path(card_name, "default")
    with tempfile.TemporaryDirectory() as tmp:
        res = cs.parallel_phase(card_name, path["model"].state_dict(), path["out"], tmp,
                                world=world)
    print(json.dumps({"parallel": res}), flush=True)
    print(json.dumps({"device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": world}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
