"""End-to-end training driver: real steps through the elastic runtime.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --reduced --steps 20 --device cpu

``--reduced`` swaps in the per-arch smoke config (same family, small
dims). The driver wires together what the reference's
(``repro/launch/train.py``) does: the config registry, the synthetic token
corpus (``TokenBatcher``), ``make_train_step`` (AdamW at ``--lr``, one
microbatch), checkpoints, and ``run_elastic``. ``--device`` (default
``cuda``) places the params and batches. On the card the MoE, hybrid and
SSM families need ``ops.set_default_impl("ref")``: their kernels have no
backward pass (``kernels.NoKernelGradError``). The audio and VLM archs
(musicgen-medium, paligemma-3b) are ROADMAP module 10.c.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.config.base import ArchFamily, OptimizerConfig, TrainConfig
from repro_torch.data.synthetic import make_lm_tokens
from repro_torch.kernels import no_grad_error, ops
from repro_torch.launch.elastic import ElasticConfig, run_elastic
from repro_torch.launch.serve import REDUCED_MODULES as _SERVED
from repro_torch.launch.serve import load_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import lm_init

#: arch id -> module with its ``reduced()`` config; the audio and VLM ids
#: (module 10.c) map to None.
REDUCED_MODULES = {**_SERVED, "musicgen-medium": None, "paligemma-3b": None}


class TokenBatcher:
    """Restartable LM batch stream over a synthetic token corpus
    (``make_lm_tokens``, 200,000 tokens): {"tokens", "labels"}, the same
    (batch, seq) int32 tensor, on ``device``."""

    def __init__(self, cfg, batch: int, seq: int, seed: int = 0,
                 device="cuda"):
        if cfg.family in (ArchFamily.AUDIO, ArchFamily.VLM):
            raise NotImplementedError(
                f"{cfg.name}: frontend batches are ROADMAP module 10.c")
        self.cfg = cfg
        self.batch, self.seq = batch, seq
        self.device = device
        self.tokens = make_lm_tokens(200_000, max(cfg.vocab_size, 2),
                                     seed=seed)
        self.cursor = 0
        self.rng_seed = seed

    def state(self):
        return {"cursor": self.cursor}

    def restore(self, st):
        self.cursor = st["cursor"]

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        n = self.batch * self.seq
        if self.cursor + n + 1 > len(self.tokens):
            self.cursor = 0
        chunk = self.tokens[self.cursor: self.cursor + n]
        self.cursor += n
        toks = torch.from_numpy(chunk.reshape(self.batch, self.seq)).to(
            self.device)
        return {"tokens": toks, "labels": toks}


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the per-arch smoke config (CPU-scale)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)

    if REDUCED_MODULES.get(args.arch, "") is None:
        raise NotImplementedError(
            f"{args.arch}: the audio and VLM families are ROADMAP module "
            "10.c, not ported yet")
    cfg = load_config(args.arch, args.reduced)
    if (torch.device(args.device).type == "cuda"
            and cfg.family in (ArchFamily.MOE, ArchFamily.HYBRID,
                               ArchFamily.SSM)
            and ops.get_default_impl() == "cuda"):
        # fail at once, not after every restart of run_elastic
        raise no_grad_error("moe_gmm" if cfg.family == ArchFamily.MOE
                            else "linear_scan")

    tc = TrainConfig(optimizer=OptimizerConfig(name="adamw", lr=args.lr),
                     microbatches=1)
    step, opt_init = make_train_step(cfg, tc)

    def make_state():
        params = lm_init(cfg, seed=0, device=args.device)
        return (params, opt_init(params))

    batches = TokenBatcher(cfg, args.batch, args.seq, device=args.device)

    t0 = time.time()
    losses = []

    def on_step(i, m):
        losses.append(m["loss"])
        if i % 10 == 0 or i == 1:
            print(f"step {i:4d}  loss {m['loss']:.4f}  gnorm "
                  f"{m['grad_norm']:.3f} ({time.time() - t0:.1f}s)")

    def step_fn(state, batch):
        params, opt_state = state
        params, opt_state, metrics = step(params, opt_state, batch)
        return (params, opt_state), metrics

    out = run_elastic(make_state=make_state, step_fn=step_fn,
                      batch_iter=batches, num_steps=args.steps,
                      config=ElasticConfig(save_every=args.save_every,
                                           checkpoint_dir=args.ckpt_dir),
                      on_step=on_step)
    if losses:
        print(f"done: {args.steps} steps, first loss {losses[0]:.4f} -> "
              f"last {losses[-1]:.4f}, restarts={out['restarts']}")
    else:
        print(f"done: {args.steps} steps, all restored from {args.ckpt_dir}")
    return dict(out, losses=losses)


if __name__ == "__main__":
    main()
