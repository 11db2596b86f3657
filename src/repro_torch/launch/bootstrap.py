"""Launch bootstrap: check that this process has the cards the fleet's
shards need.

The fleet-sharding layer (``repro_torch.core.shard``) runs one block of the
fleet axis per CUDA device under its ``shard_map`` executor, and the blocks
in turn on one device under ``emulate``. A process sees the cards it was
started with (``CUDA_VISIBLE_DEVICES``); nothing set from inside it adds
one. So, unlike the reference's bootstrap, this one never re-executes the
interpreter: ``ensure_host_devices(n)`` only reports whether ``n`` cards
are there. The reference's XLA host-platform device flag and its tcmalloc
preload size jax's CPU "fleet"; they mean nothing to torch, and nothing
here sets them.

    from repro_torch.launch.bootstrap import ensure_host_devices
    if not ensure_host_devices(8):
        ...                       # num_shards=8 runs emulated on one card

or from a shell (exit 1 when the cards are short):

    python -m repro_torch.launch.bootstrap --shards 8
"""

from __future__ import annotations

import sys

from repro_torch.core.shard import shard_capacity


def ensure_host_devices(num_shards: int) -> bool:
    """Whether this process has ``num_shards`` CUDA devices: one block a
    card under the ``shard_map`` executor. True for one shard (the single
    lane needs no card); never re-executes."""
    n = int(num_shards)
    if n < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return n == 1 or shard_capacity() >= n


def main(argv=None) -> int:
    """Print the device count; exit 1 when it is short of ``--shards``."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.bootstrap",
        description="check the CUDA devices an N-shard fleet runs on")
    ap.add_argument("--shards", type=int, required=True)
    args = ap.parse_args(argv)
    ok = ensure_host_devices(args.shards)
    print(f"cuda devices: {shard_capacity()}; shards: {args.shards}"
          + ("" if ok else "; short: the blocks run in turn on one device "
             "(emulate)"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
