#!/usr/bin/env python3
"""The expert-parallel MoE path across the cards of one host: the ``mesh``
executor (one rank a card, NCCL) against ``emulate`` (every block in turn
on one card), at ``chip_smoke.py`` phase 16's dbrx-132b layers.

    python3 scripts/moe_ep_cards.py [--out FILE]
    python3 scripts/moe_ep_cards.py --device cpu   # 4 gloo ranks, reduced

Needs at least two CUDA cards and ``nvcc``; N is the card count, one
process a card (``torch.multiprocessing``). dbrx-132b at full width (d
6,144, d_ff 10,752, 16 experts, top 4), 2 of its 40 layers drawn on every
card from one seed (phase 9's ``draw_params``), bf16. The no-mesh prefill
of phase 16's (2, 4096) tokens gives each layer's MoE input, which rank 0
broadcasts. For each layout, (1, N) and, at N = 4, (2, 2) ("data",
"model"), and each layer: params and input laid out as DTensors by the
logical-axis rules (experts over "model", the contraction dims stored
over "data"), ``moe_apply`` under ``use_mesh`` on the mesh, so each rank
routes its batch shard, all-gathers its experts' weights over "data",
launches kernel 2.5 three times on its local experts and all-reduces the
float32 partials over "model". Checks, failing on any miss:

- every rank launches kernel 2.5 exactly 3 times a layer;
- the gathered output equals ``emulate`` of the same layout on rank 0's
  card within EP_BF16_TOL (1 + |y|): the partials are summed in another
  order before the cast to bf16, so an output may move by one bf16 step.

Prints one JSON line per layout (launches per card, ms a layer under each
executor, the largest difference) and the card's name and power limit
last. ``--device cpu`` rehearses the same program on 4 gloo ranks at
dbrx's reduced size. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import socket
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

EP_BF16_TOL = 2e-2         # the MoE grouped matmul's bf16 tolerance
REPS = 5


def layouts(world: int):
    out = [(1, world)]
    if world == 4:
        out.append((2, 2))
    return out


def moe_inputs(torch, cfg, cparams, toks):
    """Each layer's MoE input in the no-mesh prefill."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    seen, orig = [], T.moe_apply

    def kept(cfg_, p, x):
        seen.append(x.clone())
        return orig(cfg_, p, x)

    T.moe_apply = kept
    try:
        make_prefill_step(cfg)(cparams, {"tokens": toks})
    finally:
        T.moe_apply = orig
    return seen


def timed_ms(torch, fn, dist=None, cuda=True):
    def sync():
        if cuda:
            torch.cuda.synchronize()
        if dist is not None:
            dist.barrier()
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / REPS, out


def worker(rank: int, world: int, port: str, device: str, out_path):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.config import MeshConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.launch.sharding import (distribute, distribute_tree,
                                             use_mesh)
    from repro_torch.models import moe
    from repro_torch.models.transformer import compute_params, lm_init

    cuda = device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    if cuda:
        cfg = dataclasses.replace(get_arch("dbrx-132b"),
                                  num_layers=cs.DBRX_LAYERS)
        params = cs.draw_params(torch, cfg, dev, seed=1601)
        shape = cs.PREFILL
    else:
        from repro_torch.configs.dbrx_132b import reduced

        cfg = dataclasses.replace(reduced(), num_layers=cs.DBRX_LAYERS)
        params = lm_init(cfg, 0, device="cpu")
        shape = (2, 64)
    cparams = compute_params(cfg, params)
    del params
    g = torch.Generator(device=dev).manual_seed(1600)
    toks = torch.randint(0, cfg.vocab_size, shape, device=dev, generator=g)
    with torch.no_grad():
        xs = moe_inputs(torch, cfg, cparams, toks)
        for x in xs:                        # every rank: rank 0's inputs
            dist.broadcast(x, 0)
        rows = []
        for layout in layouts(world):
            mesh = init_device_mesh(dev.type, layout,
                                    mesh_dim_names=("data", "model"))
            for layer, x in enumerate(xs):
                p = {k: v[layer] for k, v in cparams["blocks"]["moe"].items()}
                pd = distribute_tree(mesh, p, moe.moe_axes())
                xd = distribute(mesh, x, ("batch", None, None))
                before = gmm.launches
                with use_mesh(mesh):
                    y = moe.moe_apply(cfg, pd, xd)
                launches = gmm.launches - before
                with use_mesh(mesh):
                    mesh_ms, _ = timed_ms(
                        torch, lambda: moe.moe_apply(cfg, pd, xd), dist, cuda)
                full = y.full_tensor()
                per_rank = [None] * world
                dist.all_gather_object(per_rank, launches)
                if rank == 0:
                    with use_mesh(MeshConfig(layout, ("data", "model"))):
                        emu_ms, exp = timed_ms(
                            torch, lambda: moe.moe_apply(cfg, p, x),
                            cuda=cuda)
                    diff = (full.float() - exp.float()).abs()
                    ok = bool((diff <= EP_BF16_TOL
                               * (1 + exp.float().abs())).all())
                    rows.append(dict(
                        layout=list(layout), layer=layer,
                        launches_per_rank=per_rank,
                        experts_per_rank=cfg.num_experts // layout[1],
                        capacity_per_rank=moe.capacity(
                            cfg, x.shape[0] // layout[0] * x.shape[1]),
                        mesh_ms=mesh_ms, emulate_ms=emu_ms,
                        max_abs_diff=float(diff.max()), within_tol=ok))
                del pd, xd, y, full
                if cuda:
                    torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        Path(out_path).write_text(json.dumps(rows))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda":
        world = torch.cuda.device_count()
        if world < 2:
            print(f"moe_ep_cards: needs 2 or more CUDA cards, found {world}",
                  file=sys.stderr)
            return 2
        from repro_torch.kernels import build

        build.build_all()
        smi = cs.nvidia_smi_line()
    else:
        world, smi = 4, "cpu (gloo rehearsal, no card)"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    rows_path = ROOT / "build" / "moe_ep_cards_rows.json"
    rows_path.parent.mkdir(parents=True, exist_ok=True)
    mp.spawn(worker, args=(world, port, args.device, str(rows_path)),
             nprocs=world, join=True)
    rows = json.loads(rows_path.read_text())
    for r in rows:
        cs.emit(dict(part="moe-ep", card=smi, cards=world, **r))
    want = 3 if args.device == "cuda" else 0    # the CPU takes the plain gmm
    bad = [r for r in rows if not r["within_tol"]
           or any(n != want for n in r["launches_per_rank"])]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(cards=world, rows=rows),
                                              indent=1))
    if bad:
        raise AssertionError(f"moe_ep_cards: rows out of bounds: {bad}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
