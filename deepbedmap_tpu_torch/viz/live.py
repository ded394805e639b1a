"""Live training-curve visualisation (the reference's livelossplot role,
srgan_train.py:1625-1632: PlotLosses redrawing D/G losses every epoch).

Counterpart of ``deepbedmap_tpu/viz/live.py``, copied: it needs no
framework. ``LiveCurves`` is a ``train.loop.fit`` callback that accumulates
the per-epoch metric record and redraws a multi-panel PNG every ``every``
epochs (atomic replace, so a file watcher / browser tab always sees a
complete image — the headless equivalent of the notebook's inline redraw).
It can also print a terminal sparkline per metric for tmux-style monitoring.
matplotlib is imported inside ``render`` only.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[float], width: int = 40) -> str:
    """Unicode sparkline of a series (resampled to ``width``)."""
    vals = [float(v) for v in values if v == v]  # drop NaN
    if not vals:
        return ""
    if len(vals) > width:
        step = len(vals) / width
        vals = [vals[int(i * step)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        _BLOCKS[min(7, int(8 * (v - lo) / span))] for v in vals
    )


class LiveCurves:
    """fit-callback: ``fit(..., callback=LiveCurves(out_png))``.

    Panels default to the reference's pairing — adversarial losses together,
    quality metrics together — and any metric key not matched falls into a
    trailing panel."""

    def __init__(
        self,
        out_png: Optional[str] = None,
        panels: Optional[Dict[str, List[str]]] = None,
        every: int = 1,
        terminal: bool = False,
    ):
        self.out_png = out_png
        self.every = max(1, every)
        self.terminal = terminal
        self.panels = panels or {
            "loss": ["g_loss", "d_loss"],
            "psnr": ["psnr", "dev_psnr"],
            "ssim": ["ssim", "dev_ssim"],
        }
        self.history: Dict[str, List[float]] = {}
        self.epochs: List[int] = []

    def __call__(self, epoch: int, metrics: Dict[str, float]) -> bool:
        self.epochs.append(epoch)
        for k, v in metrics.items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            self.history.setdefault(k, []).append(fv)
        if epoch % self.every == 0:
            if self.out_png:
                self.render(self.out_png)
            if self.terminal:
                for line in self.render_terminal():
                    print(line, flush=True)
        return False  # never requests a stop

    def _panel_keys(self):
        used = set()
        panels = []
        for title, keys in self.panels.items():
            have = [k for k in keys if k in self.history]
            if have:
                panels.append((title, have))
                used.update(have)
        rest = [k for k in self.history if k not in used]
        if rest:
            panels.append(("other", rest))
        return panels

    def render_terminal(self) -> List[str]:
        lines = []
        for title, keys in self._panel_keys():
            for k in keys:
                h = self.history[k]
                lines.append(
                    f"{title:>6s} {k:<12s} {sparkline(h)} {h[-1]:.4g}"
                )
        return lines

    def render(self, out_png: str) -> str:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        panels = self._panel_keys() or [("loss", [])]
        fig, axes = plt.subplots(
            1, len(panels), figsize=(5 * len(panels), 3.2), squeeze=False
        )
        for ax, (title, keys) in zip(axes[0], panels):
            for k in keys:
                ax.plot(self.epochs[: len(self.history[k])], self.history[k],
                        label=k, linewidth=1.2)
            ax.set_title(title)
            ax.set_xlabel("epoch")
            ax.grid(alpha=0.3)
            if keys:
                ax.legend(fontsize=8)
        fig.tight_layout()
        tmp = out_png + ".tmp.png"
        fig.savefig(tmp, dpi=110)
        plt.close(fig)
        os.replace(tmp, out_png)
        return out_png
