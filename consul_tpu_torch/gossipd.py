"""The gossip plane daemon on the port: real agents set to
``gossip_backend=tpu`` delegate their LAN membership to it, and its
round runs on the CUDA card.

    python -m consul_tpu_torch.gossipd [-port 8310] [-capacity 256]
        [-sim-nodes 0] [-shard-devices -1] [-nemesis partition_heal]
        [--device cpu] ...

The flags are those of the reference's ``consul-tpu gossipd``
(``consul_tpu/cli/main.py``), plus ``--device`` (default: the card;
``cpu`` runs the plane on the CPU).  ``-nemesis`` runs the round under a
scenario of the nemesis catalog (``gossip/nemesis.py``); a name not in
the catalog exits 1 before the plane starts.  SIGINT or SIGTERM stops
the plane and exits 0.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m consul_tpu_torch.gossipd",
        description="Runs the gossip plane daemon on the port")
    p.add_argument("-bind", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8310)
    p.add_argument("-unix", default="", help="serve on a unix socket")
    p.add_argument("-capacity", type=int, default=256,
                   help="real-agent universe size")
    p.add_argument("-sim-nodes", dest="sim_nodes", type=int, default=0,
                   help="simulated nodes sharing the round's tensors")
    p.add_argument("-gossip-interval", dest="gossip_interval", type=float,
                   default=0.2, help="round length (seconds)")
    p.add_argument("-hb-lapse", dest="hb_lapse", type=float, default=2.0,
                   help="heartbeat lapse before a node fails probes")
    p.add_argument("-suspicion-mult", dest="suspicion_mult", type=float,
                   default=4.0)
    p.add_argument("-slots", type=int, default=64)
    p.add_argument("-dissem", default="",
                   choices=("swar", "planes", "prefused", "fused"),
                   help="dissemination strategy (all bit-identical; the "
                        "port runs one tail for all); omit to take the "
                        "autotune verdict")
    p.add_argument("-shard-devices", dest="shard_devices", type=int,
                   default=-1,
                   help="column shards for the round: -1 takes the "
                        "autotune verdict, 0 one per card, >=1 forces "
                        "that shard count")
    p.add_argument("-encrypt", action="append", default=[],
                   help="gossip key (base64); registrations must carry "
                        "a keyring HMAC proof (repeatable for rotation)")
    p.add_argument("-keyring-file", dest="keyring_file", default="",
                   help="load accepted keys from a serf keyring file")
    p.add_argument("-nemesis", default="",
                   help="run the round under this nemesis catalog "
                        "scenario (gossip/nemesis.py)")
    p.add_argument("-device", "--device", dest="device", default=None,
                   help="torch device of the round (default: the CUDA "
                        "card; 'cpu' runs on the CPU)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from consul_tpu_torch.gossip.plane import GossipPlane, PlaneConfig

    keys = list(args.encrypt)
    if args.keyring_file:
        # A malformed keyring file fails here, not by arming the plane
        # with keys that refuse every agent.
        from consul_tpu_torch.keyring import list_keys
        keys.extend(k for k in list_keys(args.keyring_file)
                    if k not in keys)
    if args.nemesis:
        # A typo'd scenario fails here, before the round session boots.
        from consul_tpu_torch.gossip.nemesis import names as nemesis_names
        if args.nemesis not in nemesis_names():
            print(f"Unknown nemesis scenario {args.nemesis!r}; catalog: "
                  f"{', '.join(nemesis_names())}", file=sys.stderr)
            return 1
    cfg = PlaneConfig(
        bind_addr=args.bind, bind_port=args.port, unix_path=args.unix,
        capacity=args.capacity, sim_nodes=args.sim_nodes,
        gossip_interval_s=args.gossip_interval,
        hb_lapse_s=args.hb_lapse, suspicion_mult=args.suspicion_mult,
        slots=args.slots, encrypt_keys=keys, nemesis=args.nemesis,
        dissem=args.dissem, shard_devices=args.shard_devices,
        device=args.device)

    async def serve() -> None:
        plane = GossipPlane(cfg)
        await plane.start()
        addr = cfg.unix_path or "%s:%s" % plane.local_addr
        nem = f", nemesis={cfg.nemesis}" if cfg.nemesis else ""
        print(f"==> gossip plane running at {addr} "
              f"(capacity={cfg.capacity}, sim_nodes={cfg.sim_nodes}, "
              f"round={cfg.gossip_interval_s * 1000:.0f}ms{nem})", flush=True)
        loop = asyncio.get_event_loop()
        stop = asyncio.Event()
        loop.add_signal_handler(signal.SIGINT, stop.set)
        loop.add_signal_handler(signal.SIGTERM, stop.set)
        await stop.wait()
        await plane.stop()

    asyncio.run(serve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
