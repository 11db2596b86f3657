"""Experiment CLI: run a spec file, materialize a preset, list components.

  python -m repro_torch.experiment.cli run spec.json [--verbose] [--out result.json]
  python -m repro_torch.experiment.cli preset paper-group-a --run [--arg scheduler=rlds]
  python -m repro_torch.experiment.cli preset quickstart --out spec.json
  python -m repro_torch.experiment.cli list

``preset --arg k=v`` feeds the preset factory (values parsed as JSON, bare
strings allowed); ``--set k=v`` overrides ExperimentSpec fields on the
materialized spec — top-level, or nested via a dotted key (``--set
fleet.scoring_backend=cuda``; ``--set fleet.num_shards=4`` splits the fleet
axis of scoring and the fused searches into 4 blocks, one per card where
there are 4, else run in turn on one; ``"auto"`` is one per card). ``--device``
(default ``cuda``) is where the torch/cuda scoring backends and the
``real_fl`` runtime run; ``--device cpu`` runs without a card.
Spec and result JSON written by the reference CLI load here unchanged, and
a saved result's ``spec`` block is itself a valid input to ``run``.

The fleet-scale preset on the card with its default BODS acquisition (the
candidate block's statistics from the CUDA plan-scoring kernel), and the
host genetic search whose population the kernel scores every generation:

  python -m repro_torch.experiment.cli preset fleet-scale --run
  python -m repro_torch.experiment.cli preset fleet-scale \
      --arg scheduler=genetic --set search_backend=host \
      --set scoring_backend=cuda --run

and the same with the fleet axis in 4 blocks, kernel 2.1 once per block:

  python -m repro_torch.experiment.cli preset fleet-scale \
      --arg scheduler=genetic --set search_backend=host \
      --set scoring_backend=cuda --set fleet.num_shards=4 --run
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

from repro_torch.experiment.presets import get_preset, list_presets
from repro_torch.experiment.registry import RUNTIMES, SCHEDULERS
from repro_torch.experiment.spec import ExperimentResult, ExperimentSpec


def _parse_kv(pairs) -> Dict:
    """``k=v`` pairs -> dict (values parsed as JSON, bare strings allowed).

    Dotted keys address nested spec axes: ``fleet.n_sel=4`` becomes
    ``{"fleet": {"n_sel": 4}}``, which ``ExperimentSpec.replace``
    merges over the current sub-spec. Dotted pairs for the same axis
    accumulate into one merge dict."""
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"expected key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass  # bare string
        if "." in k:
            root, sub = k.split(".", 1)
            node = out.setdefault(root, {})
            if not isinstance(node, dict):
                raise SystemExit(
                    f"--set {k}: {root!r} already set to a non-dict value")
            node[sub] = v
        else:
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k].update(v)
            else:
                out[k] = v
    return out


def _print_summary(result: ExperimentResult) -> None:
    print(f"\n[{result.spec.name}] scheduler={result.spec.scheduler} "
          f"runtime={result.spec.runtime} rounds={len(result.records)} "
          f"wall={result.wall_s:.1f}s")
    for name, v in result.summary.items():
        t2t = ("-" if v["time_to_target"] is None
               else f"{v['time_to_target'] / 60:.1f}m")
        print(f"  {name:20s} rounds={v['rounds']:4d} "
              f"best_acc={v['best_accuracy']:.3f} t2t={t2t} "
              f"makespan={v['makespan'] / 60:.1f}m")


def _run_spec(spec: ExperimentSpec, args) -> None:
    result = spec.run(verbose=args.verbose, device=args.device)
    _print_summary(result)
    if args.out:
        result.save(args.out)
        print(f"result -> {args.out} (replay: python -m "
              f"repro_torch.experiment.cli run {args.out})")


def cmd_run(args) -> None:
    with open(args.spec) as f:
        d = json.load(f)
    # Accept either a bare spec or a saved ExperimentResult (replay).
    spec = ExperimentSpec.from_dict(d.get("spec", d))
    if args.set:
        spec = spec.replace(**_parse_kv(args.set))
    _run_spec(spec, args)


def cmd_preset(args) -> None:
    spec = get_preset(args.name, **_parse_kv(args.arg))
    if args.set:
        spec = spec.replace(**_parse_kv(args.set))
    wrote_spec = bool(args.out)
    if wrote_spec:
        spec.save(args.out)
        print(f"spec -> {args.out}")
        args.out = None  # --out holds the spec; don't overwrite with a result
    if args.run or not wrote_spec:
        _run_spec(spec, args)


def cmd_list(args) -> None:
    print("schedulers:", ", ".join(SCHEDULERS.names()))
    print("runtimes:  ", ", ".join(RUNTIMES.names()))
    print("presets:   ", ", ".join(list_presets()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiment.cli",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="run an ExperimentSpec JSON file")
    p_run.add_argument("spec", help="path to spec.json (or a saved result)")
    p_run.add_argument("--set", action="append", metavar="K=V",
                       help="override a top-level spec field")
    p_run.add_argument("--out", help="write the ExperimentResult JSON here")
    p_run.add_argument("--verbose", action="store_true")
    p_run.add_argument("--device", default="cuda",
                       help="where the torch/cuda scoring backends and "
                            "the real_fl runtime run (default: cuda)")
    p_run.set_defaults(fn=cmd_run)

    p_pre = sub.add_parser("preset", help="materialize (and optionally run) "
                                          "a named preset")
    p_pre.add_argument("name", help="preset name (see `list`)")
    p_pre.add_argument("--arg", action="append", metavar="K=V",
                       help="preset factory argument")
    p_pre.add_argument("--set", action="append", metavar="K=V",
                       help="override a top-level spec field")
    p_pre.add_argument("--out", help="write the spec JSON here (skips the "
                                     "run unless --run)")
    p_pre.add_argument("--run", action="store_true")
    p_pre.add_argument("--verbose", action="store_true")
    p_pre.add_argument("--device", default="cuda",
                       help="where the torch/cuda scoring backends and "
                            "the real_fl runtime run (default: cuda)")
    p_pre.set_defaults(fn=cmd_preset)

    p_ls = sub.add_parser("list", help="list registered schedulers / "
                                       "runtimes / presets")
    p_ls.set_defaults(fn=cmd_list)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
