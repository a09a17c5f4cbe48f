"""Standalone HA-aware dict-service process.

``python -m nydus_snapshotter_tpu_torch.ha.runner --listen <uds>
[--controller <uds>] [--role primary|replica|unassigned]
[--upstream <uds>] [--name <member>] [--device cuda|cpu|cuda:N]``

Starts a :class:`~nydus_snapshotter_tpu_torch.parallel.dict_service.
DictService` on ``--listen`` with a
:class:`~nydus_snapshotter_tpu_torch.ha.replicate.HaAgent` attached,
self-registers with the fleet controller (component ``dict``, the
placement controller's candidate pool; the controller address comes from
``--controller`` or ``NTPU_FLEET_CONTROLLER``), and serves until SIGTERM.
The namespaces' probe indexes live on ``--device`` (default ``cuda``:
every probe RPC is a launch of kernel K3 there; it raises when CUDA is
missing). A SIGKILLed runner takes everything it holds with it, and the
plane recovers without it.

``--role unassigned`` (the default under a controller) rejects merges
until the placement controller pushes a role: two fresh members must
never both accept writes for the same shard. ``--role primary`` serves
immediately (the single-process, no-controller deployment).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ntpu-dict-ha-runner")
    p.add_argument("--listen", required=True, help="UDS to serve the dict RPCs on")
    p.add_argument("--controller", default="", help="fleet controller UDS")
    p.add_argument(
        "--role", default="", choices=["", "primary", "replica", "unassigned"],
        help="initial role (default: unassigned under a controller, "
        "primary without one)",
    )
    p.add_argument("--upstream", default="", help="primary UDS for --role replica")
    p.add_argument("--name", default="", help="fleet member name override")
    p.add_argument(
        "--device", default="cuda",
        help="torch device of the probe indexes (default cuda; cpu runs the "
        "kernels' plain versions)",
    )
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s %(message)s",
        stream=sys.stderr,
    )
    if args.controller:
        os.environ["NTPU_FLEET_CONTROLLER"] = args.controller
    if args.name:
        os.environ.setdefault("NTPU_FLEET_MEMBER", args.name)

    from nydus_snapshotter_tpu_torch import ha as ha_mod
    from nydus_snapshotter_tpu_torch.ha.replicate import HaAgent
    from nydus_snapshotter_tpu_torch.parallel.dict_service import DictService

    role = args.role or (
        "unassigned" if os.environ.get("NTPU_FLEET_CONTROLLER") else "primary"
    )
    service = DictService(device=args.device)
    agent = HaAgent(service, cfg=ha_mod.resolve_ha_config(), role=role)
    if role == "replica":
        agent.configure("replica", upstream=args.upstream)
    # The handlers go in before the socket answers: a SIGTERM sent as soon
    # as the service serves must end it cleanly, not kill it.
    stop = threading.Event()

    def _on_signal(_signum, _frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    service.run(args.listen)
    try:
        stop.wait()
    finally:
        tailer = agent.tailer
        if tailer is not None:
            tailer.stop()
        service.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
