"""Gym CLI: train, evaluate, and list learned scheduler policies.

  python -m repro_torch.gym train --name rlds-full --curriculum full \\
      --num-devices 64,256 --iters 80 --zoo policies
  python -m repro_torch.gym eval --name rlds-full --curriculum default
  python -m repro_torch.gym list

``train`` runs batched REINFORCE over the chosen curriculum (one stage per
pool size), reports trained-vs-untrained mean cost on held-out scenarios,
and saves the policy to the zoo. ``--device`` (default ``cuda``) is where the
environments and the policy run; ``--device cpu`` runs them on the CPU. The
saved name plugs straight into the experiment CLI::

  python -m repro_torch.experiment.cli preset quickstart \\
      --arg scheduler=rlds --set policy=rlds-full --run
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch.gym.scenarios import CURRICULA
from repro_torch.gym.train import (TrainConfig, default_stages, evaluate,
                                   train_rlds)
from repro_torch.gym.zoo import DEFAULT_ZOO_DIR, PolicyZoo, save_rlds_params


def _stages(args):
    sizes = tuple(int(k) for k in str(args.num_devices).split(","))
    return default_stages(args.curriculum, num_devices=sizes,
                          num_jobs=args.num_jobs,
                          n_sel_frac=args.n_sel_frac), sizes


def cmd_train(args) -> None:
    from repro_torch.core.schedulers.rlds import init_policy

    stages, sizes = _stages(args)
    tcfg = TrainConfig(num_envs=args.envs, rollout_len=args.rollout,
                       iters=args.iters, lr=args.lr,
                       minibatches=args.minibatches)
    print(f"training {args.name!r}: curriculum={args.curriculum} "
          f"K={sizes} E={tcfg.num_envs} T={tcfg.rollout_len} "
          f"iters={tcfg.iters} device={args.device}")
    params, logs = train_rlds(stages, tcfg, seed=args.seed,
                              device=args.device)
    for log in logs[:: max(1, len(logs) // 10)]:
        print(f"  iter {log['iter']:4d} stage {log['stage']} "
              f"mean_cost={log['mean_cost']:.4f} "
              f"({log['wall_s'] * 1e3:.0f} ms)")

    # Held-out comparison vs a fresh (untrained) policy on paired scenarios.
    cfg, scen = stages[0]
    untrained = init_policy(torch.Generator().manual_seed(args.seed + 1),
                            args.device)
    ev_t = evaluate(cfg, scen, params, seed=args.seed + 2,
                    device=args.device)
    ev_u = evaluate(cfg, scen, untrained, seed=args.seed + 2,
                    device=args.device)
    print(f"eval (K={cfg.num_devices}): trained mean_cost="
          f"{ev_t['mean_cost']:.4f}  untrained={ev_u['mean_cost']:.4f}")

    zoo = PolicyZoo(args.zoo)
    meta = {"curriculum": args.curriculum, "num_devices": list(sizes),
            "num_jobs": args.num_jobs, "iters": tcfg.iters,
            "seed": args.seed, "eval_trained_cost": ev_t["mean_cost"],
            "eval_untrained_cost": ev_u["mean_cost"]}
    path = save_rlds_params(zoo, args.name, params, num_jobs=args.num_jobs,
                            lr=args.lr, meta=meta)
    print(f"saved -> {path}\nuse it: python -m repro_torch.experiment.cli "
          f"preset quickstart --arg scheduler=rlds --set policy={args.name} "
          f"--set policy_dir={args.zoo} --run")


def cmd_eval(args) -> None:
    from repro_torch.core.cost import CostModel
    from repro_torch.core.devices import DevicePool
    from repro_torch.core.schedulers.rlds import RLDSScheduler

    stages, _ = _stages(args)
    cfg, scen = stages[0]
    zoo = PolicyZoo(args.zoo)
    # Load through a scratch scheduler so the restore path is the same one
    # the experiment layer uses.
    pool = DevicePool.heterogeneous(cfg.num_devices, cfg.num_jobs, seed=0)
    sched = RLDSScheduler(CostModel(pool, device=args.device), seed=0,
                          pretrain_rounds=0)
    meta = zoo.load_into(args.name, sched)
    ev = evaluate(cfg, scen, sched.params, seed=args.seed,
                  device=args.device)
    print(json.dumps({"name": args.name, "meta": meta, "eval": ev}, indent=2))


def cmd_list(args) -> None:
    zoo = PolicyZoo(args.zoo)
    names = zoo.names()
    if not names:
        print(f"(no policies in {args.zoo!r})")
    for name in names:
        info = zoo.info(name)
        print(f"{name:24s} kind={info.get('kind', '?'):5s} "
              f"meta={json.dumps(info.get('meta', {}))}")


def _common(p) -> None:
    p.add_argument("--zoo", default=DEFAULT_ZOO_DIR,
                   help="policy zoo root directory")
    p.add_argument("--curriculum", default="default",
                   choices=sorted(CURRICULA))
    p.add_argument("--num-devices", default="64",
                   help="comma-separated pool sizes (one stage each)")
    p.add_argument("--num-jobs", type=int, default=3)
    p.add_argument("--n-sel-frac", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the environments and the policy run")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.gym", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_tr = sub.add_parser("train", help="train an RLDS policy in the gym")
    p_tr.add_argument("--name", required=True, help="policy zoo entry name")
    p_tr.add_argument("--envs", type=int, default=32)
    p_tr.add_argument("--rollout", type=int, default=32)
    p_tr.add_argument("--iters", type=int, default=80)
    p_tr.add_argument("--lr", type=float, default=1e-2)
    p_tr.add_argument("--minibatches", type=int, default=4)
    _common(p_tr)
    p_tr.set_defaults(fn=cmd_train)

    p_ev = sub.add_parser("eval", help="evaluate a saved policy in the gym")
    p_ev.add_argument("--name", required=True)
    _common(p_ev)
    p_ev.set_defaults(fn=cmd_eval)

    p_ls = sub.add_parser("list", help="list zoo policies")
    p_ls.add_argument("--zoo", default=DEFAULT_ZOO_DIR)
    p_ls.set_defaults(fn=cmd_list)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
