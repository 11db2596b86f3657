"""Serving loop: continuous-batched decode against a KV and recurrent
state.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --reduced --requests 16 --max-new 32 --device cpu

The reference's decode loop (``repro/launch/serve.py``): a request queue,
per-slot lengths, one fused ``serve_step`` per token across every slot
(decode-time continuous batching: a finished slot is refilled from the
queue at once), greedy sampling. Each request is one prompt token drawn
from ``np.random.default_rng(0)`` and ``max_new`` emitted tokens; the
queue is served from its end, as the reference pops it. A refilled slot
starts at length 0 but keeps the recurrent state (SSD, mLSTM, sLSTM) its
last request left, as in the reference. ``serve`` returns the tokens
every request emitted and the step count; the emitted tokens stay on the
device until the loop ends, so the loop never waits for the card. The
VLM serves token prompts (no image prefix), and the CLI refuses the audio
family before it draws any params, both as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config.base import ArchFamily, ModelConfig
from repro_torch.config.registry import get_arch
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.transformer import (compute_params, init_decode_state,
                                            lm_init)

#: arch id -> module with its ``reduced()`` same-family config (the
#: reference keeps its own at launch/train.py).
REDUCED_MODULES = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "trinity-mini": "repro_torch.configs.trinity_mini",
    "trinity-mini-ep8-8l": "repro_torch.configs.trinity_mini",
}


@dataclasses.dataclass
class ServeResult:
    tokens: List[List[int]]   # per request (queue order), its emitted tokens
    steps: int                # fused serve steps
    seconds: float            # wall time of the loop, ending in a sync


def serve(cfg: ModelConfig, params, *, requests: int, slots: int,
          max_new: int, cache_len: int, device="cuda") -> ServeResult:
    """Serve ``requests`` greedy requests of ``max_new`` tokens on
    ``slots`` batch slots with a ``cache_len`` KV cache. ``params`` on
    ``device`` (a compute copy is fastest, see models/transformer.py)."""
    if max_new < 1 or slots < 1:
        raise ValueError(f"max_new and slots must be >= 1, got {max_new}, "
                         f"{slots}")
    serve_step = make_serve_step(cfg)
    B = slots
    state = init_decode_state(cfg, B, cache_len, device)
    rng = np.random.default_rng(0)
    queue = [(int(rng.integers(0, cfg.vocab_size)), max_new)
             for _ in range(requests)]
    slot_tok = torch.zeros(B, dtype=torch.int32, device=device)
    lengths = torch.zeros(B, dtype=torch.int32, device=device)
    slot_left = np.zeros(B, np.int64)
    slot_req = np.full(B, -1)
    emitted = []   # per step: (next tokens on the device, [(slot, request)])
    completed = steps = 0
    t0 = time.perf_counter()
    while completed < requests:
        for b in range(B):  # fill free slots (continuous batching)
            if slot_left[b] == 0 and queue:
                slot_req[b] = len(queue) - 1
                tok, n = queue.pop()
                slot_tok[b] = tok
                slot_left[b] = n
                lengths[b] = 0
        logits, state = serve_step(params, state, slot_tok, lengths)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        active = slot_left > 0
        act = torch.as_tensor(active).to(device)
        lengths = lengths + act
        slot_tok = torch.where(act, next_tok, slot_tok)
        emitted.append((next_tok, [(b, int(slot_req[b]))
                                   for b in np.flatnonzero(active)]))
        steps += 1
        for b in range(B):
            if slot_left[b] > 0:
                slot_left[b] -= 1
                if slot_left[b] == 0:
                    completed += 1
    tokens: List[List[int]] = [[] for _ in range(requests)]
    if emitted:
        table = torch.stack([t for t, _ in emitted]).cpu().numpy()
        for s, (_, who) in enumerate(emitted):
            for b, req in who:
                tokens[req].append(int(table[s, b]))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return ServeResult(tokens=tokens, steps=steps,
                       seconds=time.perf_counter() - t0)


def load_config(arch: str, reduced: bool) -> ModelConfig:
    if reduced:
        if arch not in REDUCED_MODULES:
            get_arch(arch)  # an unknown id: KeyError with the known ones
            raise KeyError(f"no reduced config for {arch!r}")
        return importlib.import_module(REDUCED_MODULES[arch]).reduced()
    return get_arch(arch)


def main(argv: Optional[List[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4, help="batch slots")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.arch, args.reduced)
    if cfg.family == ArchFamily.AUDIO:
        raise SystemExit("audio decode demo: use examples/serve_batched.py")
    params = compute_params(cfg, lm_init(cfg, seed=0, device=args.device))
    res = serve(cfg, params, requests=args.requests, slots=args.slots,
                max_new=args.max_new, cache_len=args.cache_len,
                device=args.device)
    total = sum(len(t) for t in res.tokens)
    print(f"served {args.requests} requests / {total} tokens in {res.steps} "
          f"fused steps, {res.seconds:.2f}s "
          f"({total / max(res.seconds, 1e-9):.1f} tok/s) on {args.device}")
    return res


if __name__ == "__main__":
    main()
