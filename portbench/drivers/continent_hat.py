"""Continent inference with HAT: whole passes of
`DeepBedMap.predict_continent` with the port's HAT generator (`HATConfig`),
on `drivers/continent.py`'s traffic (`continent_band3`'s parameters),
window, trace and check, as `drivers/continent_swinir.py` runs SwinIR.

What differs from the SwinIR driver: the weights (`weights_hat.py`, by the
configuration's `weights`), the model's construction (a `HATConfig` from the
configuration's `generator`), the reference tile (`reference/hat.py`:
`trunk` names the precision of the two attention products, `other` of every
other product) and the faults. The SwinIR driver's `setup` has no hook for
the weights or the configuration, so it is copied here, on
`drivers/continent.py`'s `Run` as the SwinIR driver's is. The check stays `tile_gap_share`, the widest
gap from the reference over the widest gap of the reference one precision
step lower. With ``control`` it also reads the faults planted in the
reference, each as a share of the same control: the relative-position
biases, the shifted windows' mask or the shift dropped, the CAB branch left
out, the OCAB's zero-padded keys left out of the softmax, and the attention
products in TF32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.drivers import continent
from portbench.fields import continent_inputs
from portbench.reference import hat as reference
from portbench.weights_hat import hat_weights

FAULTS = {"bias": dict(drop=("bias",)), "mask": dict(drop=("mask",)),
          "shift": dict(drop=("shift",)), "cab": dict(drop=("cab",)),
          "oca_pad": dict(drop=("oca_pad",)), "attn_tf32": dict(attn_precision="tf32")}


class Run(continent.Run):
    def setup(self) -> None:
        from deepbedmap_tpu_torch import DeepBedMap
        from deepbedmap_tpu_torch.config import HATConfig
        from deepbedmap_tpu_torch.device import disable_tf32

        disable_tf32()
        cfg, seed = self.cell.config, self.cell.seed
        self.weights = hat_weights(cfg["weights"], cfg["generator"], seed, self.dev)
        x0, y0 = self.cell.traffic["origin"]
        width = self.per_band * self.tile * continent.RES
        height = self.bands * self.tile * continent.RES
        self.bounds = (x0, y0, x0 + width, y0 + height)
        self.inputs = continent_inputs(self.bounds, self.bands * self.tile_lr,
                                       self.per_band * self.tile_lr, seed, self.dev,
                                       pinned=self.pinned and self.dev.type == "cuda")
        rng = np.random.default_rng(seed)
        interior = [(int(rng.integers(1, max(self.bands - 1, 2))),
                     int(rng.integers(1, max(self.per_band - 1, 2))))
                    for _ in range(self.cell.traffic["check_tiles"] - 2)]
        tiles = [(0, 0), (self.bands - 1, self.per_band - 1)] + interior
        self.tiles = [tiles[i] for i in rng.permutation(len(tiles))]
        self.dbm = DeepBedMap(self.weights, device=self.dev,
                              cfg=HATConfig(**cfg["generator"], **cfg["program"]))
        # every band's inputs have the same shapes: one band warms them all
        band = {k: v[:, :, : continent.RATIOS[k] * self.tile_lr]
                for k, v in self.inputs.items()}
        top = self.bounds[3]
        self.dbm.predict_continent(band, (x0, top - self.tile * continent.RES, x0 + width, top),
                                   **self.kw)

    def reference_tile(self, ty: int, tx: int, lower: bool = False,
                       **fault) -> torch.Tensor:
        """The plain reference's (tile, tile) output for tile (ty, tx), at the
        configuration's precisions, or one step below each with ``lower``;
        ``fault`` is passed to the reference (`FAULTS`)."""
        prec = self.cell.config["precision"]
        other, trunk = prec["other"], prec["trunk"]
        if lower:
            other, trunk = reference.LOWER[other], reference.LOWER[trunk]
        kw = {"precision": other, "attn_precision": trunk, **fault}
        with torch.no_grad(), reference.strict_fp32():
            out = reference.hat(self.weights, *self.crop(ty, tx),
                                cfg=self.cell.config["generator"], **kw)
        d = self.cell.traffic["halo_lr"] * continent.SCALE
        return out[0, 0, d:out.shape[2] - d, d:out.shape[3] - d]

    def check(self, control: bool = False) -> Dict[str, float]:
        out = super().check(control)
        if control:
            for pos in {pos for pos, _ in self.saved}:
                want = self.reference_tile(*pos)
                lower = reference.widest_gap(self.reference_tile(*pos, lower=True), want)
                for name, fault in FAULTS.items():
                    share = reference.widest_gap(self.reference_tile(*pos, **fault),
                                                 want) / lower
                    key = f"fault_{name}_tile_gap_share"
                    out[key] = min(out.get(key, share), share)
        return out
