"""Seeded smooth fields at bed, surface, velocity and accumulation scale.

Each field is `base` plus a sum of `terms` separable products
cos(2 pi y / ly + py) sin(2 pi x / lx + px), amplitude `amp / terms`, with
wavelengths drawn between 20 and 150 km and phases drawn from the seed: the
fields of the program's on-card checks (`chip_smoke.py:_smooth_field`,
`PRODUCT_FIELDS`), made here on the device, where a continent band's
gigabytes take milliseconds, and then copied to host memory once.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from portbench.weights import seeded_generator

# the conditioning inputs over an output of 250 m cells: the ratio of each
# input's cells to the 1000 m grid's, and (base, amplitude) of each channel;
# W1's base lies below its amplitude, so part of it is below zero and the
# program's clip of the conditioning runs
INPUTS = {"X": (1, [(-500.0, 800.0)]), "W1": (10, [(300.0, 800.0)]),
          "W2": (2, [(0.0, 300.0), (0.0, 300.0)]), "W3": (1, [(0.3, 0.2)])}
TERMS = 6
INPUTS_STREAM = 2


def smooth_field(g: torch.Generator, xc: torch.Tensor, yc: torch.Tensor, base: float,
                 amp: float, terms: int = TERMS) -> torch.Tensor:
    """(len(yc), len(xc)) float32 on the generator's device; ``xc`` and ``yc``
    are float64 cell centres in metres."""
    dev = xc.device
    u = torch.rand((terms, 4), generator=g, device=dev, dtype=torch.float64)
    lx, ly = 20e3 + 130e3 * u[:, 0], 20e3 + 130e3 * u[:, 1]
    px, py = 2 * math.pi * u[:, 2], 2 * math.pi * u[:, 3]
    cols = torch.sin(2 * math.pi * xc[None] / lx[:, None] + px[:, None])
    rows = torch.cos(2 * math.pi * yc[None] / ly[:, None] + py[:, None])
    out = torch.full((len(yc), len(xc)), base, dtype=torch.float32, device=dev)
    return out.addmm_(rows.T.float() * (amp / terms), cols.float())


def continent_inputs(bounds: Sequence[float], lr_h: int, lr_w: int, seed: int,
                     device, pinned: bool = False) -> Dict[str, np.ndarray]:
    """NCHW float32 host arrays X (1,1,h,w), W1 (1,1,10h,10w), W2 (1,2,2h,2w)
    and W3 (1,1,h,w) over ``bounds`` (xmin, ymin, xmax, ymax), for a 1000 m
    grid of ``lr_h`` x ``lr_w`` cells; with ``pinned``, in page-locked host
    memory (each array a view of a pinned tensor, which it keeps alive)."""
    g = seeded_generator(seed, device, INPUTS_STREAM)
    xmin, _, xmax, ymax = bounds
    out = {}
    for key, (ratio, channels) in INPUTS.items():
        h, w = ratio * lr_h, ratio * lr_w
        res = (xmax - xmin) / w
        xc = xmin + res * (torch.arange(w, device=device, dtype=torch.float64) + 0.5)
        yc = ymax - res * (torch.arange(h, device=device, dtype=torch.float64) + 0.5)
        stack = torch.stack([smooth_field(g, xc, yc, b, a) for b, a in channels])[None]
        host = torch.empty(stack.shape, dtype=stack.dtype, pin_memory=pinned)
        out[key] = host.copy_(stack).numpy()
    return out


# training tiles (REFERENCE_SHAPES_NCHW of the published training arrays):
# key -> (cells a side, cell size in m, offset of the first cell from the
# tile's corner in m, the smooth field of each channel); Y is the bed at
# 250 m over the tile's inner 9 km, with `Y_ROUGHNESS_M` of seeded noise
TILES = {"X": (11, 1000.0, 0.0, ["bed"]), "W1": (110, 100.0, 0.0, ["surface"]),
         "W2": (22, 500.0, 0.0, ["velocity_x", "velocity_y"]),
         "W3": (11, 1000.0, 0.0, ["accumulation"]), "Y": (36, 250.0, 1000.0, ["bed"])}
TILE_FIELDS = {"bed": (-500.0, 800.0), "surface": (300.0, 800.0), "velocity_x": (0.0, 300.0),
               "velocity_y": (0.0, 300.0), "accumulation": (0.3, 0.2)}
TILE_DOMAIN_KM = 2000
Y_ROUGHNESS_M = 20.0


def training_tiles(n: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """``n`` NCHW float32 training tiles on ``device``, each a crop at a
    seeded position of one seeded smooth field per quantity."""
    g = seeded_generator(seed, device, INPUTS_STREAM)
    f64 = dict(device=device, dtype=torch.float64)
    origin = 1000.0 * TILE_DOMAIN_KM * torch.rand((n, 2), generator=g, **f64)
    params = {}
    for name in TILE_FIELDS:
        u = torch.rand((TERMS, 4), generator=g, **f64)
        params[name] = (20e3 + 130e3 * u[:, 0], 20e3 + 130e3 * u[:, 1],
                        2 * math.pi * u[:, 2], 2 * math.pi * u[:, 3])
    out = {}
    for key, (cells, res, offset, channels) in TILES.items():
        pos = offset + res * (torch.arange(cells, **f64) + 0.5)
        xc = origin[:, :1] + pos[None]
        yc = origin[:, 1:] - pos[None]
        chans = []
        for name in channels:
            base, amp = TILE_FIELDS[name]
            lx, ly, px, py = params[name]
            cols = torch.sin(2 * math.pi * xc[:, None, :] / lx[None, :, None] + px[None, :, None])
            rows = torch.cos(2 * math.pi * yc[:, None, :] / ly[None, :, None] + py[None, :, None])
            chans.append(base + (amp / TERMS) * torch.einsum("nky,nkx->nyx", rows, cols))
        out[key] = torch.stack(chans, 1).float()
    out["Y"] += Y_ROUGHNESS_M * torch.randn(out["Y"].shape, generator=g, device=device)
    return out
