"""GAN training: `train.loop.fit` on a device-resident tile set.

Reads a traffic mix of this shape (`traffic/train_b128.json`): `tiles`
training tiles of the published arrays' shapes, made from the seed on the
device; `compare_steps` steps compared with the reference; `trace_steps`
steps traced. The configuration's `train` fields are the `TrainConfig`
(batch, rate; the rest the published defaults), its `train_weights` and
`discriminator` the published initial weights' scales.

Set-up draws the starting weights and the tiles, builds one training state
(G, D, their Adams) and drives it through its first `compare_steps` steps,
on distinct rows drawn from the seed, through the epoch function `fit`
itself runs (`train.loop.make_epoch_fns`), and one evaluation step. It
keeps each step's losses, the first gradient of each leaf as the Adam got
it (its first moment after one step over 1 - beta1), each leaf's change
over the steps, and the losses of the evaluation of `fit`'s first dev
batch after them. The window hands that same state to `fit`, which runs
epochs (each with its evaluation of the dev split) until `--seconds` have
gone by, and reports the tiles of its completed steps over its time.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from portbench import tracing
from portbench.fields import training_tiles
from portbench.reference import train as reference
from portbench.reference.generator import strict_fp32
from portbench.weights import discriminator_weights, generator_weights


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


class Run:
    # the readings a limit is set from need no measured window
    READINGS_WINDOW_S = None

    def __init__(self, cell):
        self.cell = cell
        self.dev = torch.device(cell.device)
        self.readings: Dict = {}

    def setup(self) -> None:
        from deepbedmap_tpu_torch.config import DiscriminatorConfig, GeneratorConfig, \
            TrainConfig
        from deepbedmap_tpu_torch.data.dataset import TileDataset, epoch_batches, \
            train_dev_split
        from deepbedmap_tpu_torch.device import disable_tf32
        from deepbedmap_tpu_torch.models.discriminator import Discriminator
        from deepbedmap_tpu_torch.models.generator import Generator
        from deepbedmap_tpu_torch.train.loop import make_epoch_fns
        from deepbedmap_tpu_torch.train.state import GANState, make_optimizer

        disable_tf32()
        cfg, tr, seed = self.cell.config, self.cell.traffic, self.cell.seed
        self.blocks = cfg["generator"]["num_residual_blocks"]
        self.t_cfg = TrainConfig(**cfg["train"])
        self.g0 = generator_weights(cfg["train_weights"], self.blocks, seed, self.dev)
        self.d0 = discriminator_weights(cfg["discriminator"]["init_scale"], seed, self.dev)
        self.tiles = training_tiles(tr["tiles"], seed, self.dev)
        self.dataset = TileDataset({k: v.permute(0, 2, 3, 1).contiguous()
                                    for k, v in self.tiles.items()})
        g = Generator(GeneratorConfig(**cfg["generator"], **cfg["program"]))
        g.load_state_dict(self.g0)
        d = Discriminator(DiscriminatorConfig(init_scale=cfg["discriminator"]["init_scale"]))
        d.load_state_dict(self.d0)
        g, d = g.to(self.dev), d.to(self.dev)
        self.state = GANState(step=0, g=g, g_opt=make_optimizer(self.t_cfg, g.parameters()),
                              d=d, d_opt=make_optimizer(self.t_cfg, d.parameters()))
        train_fn, eval_fn = make_epoch_fns(self.dataset, self.t_cfg)
        train_idx, dev_idx = train_dev_split(len(self.dataset), self.t_cfg.train_fraction,
                                             self.t_cfg.split_seed)
        rows = epoch_batches(train_idx, self.t_cfg.batch_size,
                             np.random.RandomState(seed % 2**32))
        self.rows = rows[: tr["compare_steps"]]
        self.trace_rows = rows[-tr["trace_steps"]:]
        self.state, first = train_fn(self.state, self.rows[:1])
        b1 = self.t_cfg.adam_beta1
        grads = {}
        for prefix, model, opt in (("g.", g, self.state.g_opt), ("d.", d, self.state.d_opt)):
            for name, p in model.named_parameters():
                # no moment where the step never reached the optimizer
                m = opt.state[p].get("exp_avg", torch.zeros_like(p))
                grads[prefix + name] = m / (1 - b1)
        self.readings["grads"] = _norms(grads)
        self.state, rest = train_fn(self.state, self.rows[1:])
        self.readings["losses"] = [(float(m.discriminator_loss), float(m.generator_loss))
                                   for m in first + rest]
        change = {}
        for prefix, model, start in (("g.", g, self.g0), ("d.", d, self.d0)):
            for name, p in model.named_parameters():
                change[prefix + name] = p.detach() - start[name]
        self.readings["change"] = _norms(change)
        # the first of the dev batches `fit` evaluates after each epoch
        self.dev_rows = epoch_batches(dev_idx, min(self.t_cfg.batch_size, len(dev_idx)),
                                      np.random.RandomState(self.t_cfg.split_seed))[0]
        m = eval_fn(self.state, self.dev_rows[None])[0]
        self.readings["eval"] = (float(m.discriminator_loss), float(m.generator_loss))

    def window(self, seconds: float) -> Dict:
        from deepbedmap_tpu_torch.train.loop import fit

        t_end = time.perf_counter() + seconds
        t0 = time.perf_counter()
        self.state, history = fit(self.state, self.dataset, self.t_cfg,
                                  callback=lambda epoch, record: time.perf_counter() >= t_end)
        elapsed = time.perf_counter() - t0
        n_train = int(len(self.dataset) * self.t_cfg.train_fraction)
        steps = len(history) * (n_train // self.t_cfg.batch_size)
        tiles = steps * self.t_cfg.batch_size
        failed = sum(1 for r in history if not np.isfinite(r["generator_loss"]))
        return {"metrics": {"train_tiles_per_s": tiles / elapsed}, "attempted": steps,
                "failed": failed, "seconds": elapsed}

    def trace(self) -> Dict:
        from deepbedmap_tpu_torch.train.loop import make_epoch_fns

        train_fn, _ = make_epoch_fns(self.dataset, self.t_cfg)
        return {"trace": tracing.profile(lambda: train_fn(self.state, self.trace_rows))}

    def release(self) -> None:
        del self.state, self.dataset
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def follow(self, precision: str = "fp32", rows: int = None) -> Dict:
        """The reference's readings over the same steps: losses, first
        gradients and changes, on the first ``rows`` of each batch, and the
        dev evaluation's losses after them."""
        ref = reference.Trainer(self.g0, self.d0, self.t_cfg.learning_rate, self.blocks,
                                precision)
        out = {"losses": []}
        with strict_fp32():
            for i, idx in enumerate(self.rows):
                sel = torch.as_tensor(idx[:rows], device=self.dev)
                step = ref.step({k: v.index_select(0, sel) for k, v in self.tiles.items()})
                out["losses"].append((step["d_loss"], step["g_loss"]))
                if i == 0:
                    out["grads"] = {**_norms({"g." + k: v for k, v in step["g_grads"].items()}),
                                    **_norms({"d." + k: v for k, v in step["d_grads"].items()})}
        sel = torch.as_tensor(self.dev_rows, device=self.dev)
        with strict_fp32():
            out["eval"] = ref.evaluate({k: v.index_select(0, sel) for k, v in self.tiles.items()})
        out["change"] = {**_norms({"g." + k: ref.g[k].detach() - v for k, v in self.g0.items()}),
                         **_norms({"d." + k: ref.d[k].detach() - self.d0[k]
                                   for k in ref.d_names})}
        return out

    @staticmethod
    def compare(got: Dict, want: Dict, detail: bool = False) -> Dict[str, float]:
        """loss_gap: the widest relative gap of a step's D or G loss, or of
        the dev evaluation's after the steps; grad_gap: the median leaf's gap
        of its first gradient's norm, change_gap: the worst leaf's gap of its
        change's norm (`reference.train.leaf_gaps`), each the larger of G's
        and D's; the change leaves out leaves whose reference gradient is
        under a thousandth of the median leaf's of its network (they move by
        round-off alone). With ``detail`` also worst_grad_gap, the worst
        leaf's gap of its first gradient's norm."""
        loss_gap = max(abs(g - w) / abs(w)
                       for gs, ws in zip(got["losses"] + [got["eval"]],
                                         want["losses"] + [want["eval"]])
                       for g, w in zip(gs, ws))
        grads, change = [], []
        for net in ("g.", "d."):
            mine = {k: v for k, v in want["grads"].items() if k.startswith(net)}
            norms = sorted(mine.values())
            skip = [k for k, v in mine.items() if v < 1e-3 * norms[len(norms) // 2]]
            grads.append(sorted(reference.leaf_gaps(got["grads"], mine).values()))
            change.append(reference.leaf_gaps(
                got["change"], {k: v for k, v in want["change"].items() if k.startswith(net)},
                skip))
        out = {"loss_gap": loss_gap,
               "grad_gap": max(g[len(g) // 2] for g in grads),
               "change_gap": max(max(c.values()) for c in change)}
        if detail:
            out["worst_grad_gap"] = max(g[-1] for g in grads)
        return out

    def check(self, control: bool = False) -> Dict[str, float]:
        want = self.follow()
        out = self.compare(self.readings, want, control)
        if control:
            lower = self.compare(self.follow("tf32"), want, True)
            half = self.compare(self.follow(rows=self.t_cfg.batch_size // 2), want, True)
            out.update({f"control_{k}": v for k, v in lower.items()})
            out.update({f"fault_half_batch_{k}": v for k, v in half.items()})
            # where the loss gap arises: the first step's alone
            out["first_step_loss_gap"] = max(abs(g - w) / abs(w) for g, w in
                                             zip(self.readings["losses"][0], want["losses"][0]))
        return out
