#!/usr/bin/env python
"""Swarm coordinator of the PyTorch port (the flags of ``coordinator.py``).

Bootstraps the swarm: the initial DHT node and one control-plane replica,
which serves ``coord.status`` and takes the volunteers' batched heartbeat
and report traffic. Host-only: it touches no card. Prints
``COORDINATOR_READY host:port`` once listening; SIGTERM retires it.

    python coordinator_torch.py --host 0.0.0.0 --port 9000 --metrics swarm.jsonl
"""

import argparse
import asyncio


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 = pick a free port")
    ap.add_argument("--metrics", default=None, help="swarm-level metrics JSONL path")
    ap.add_argument("--advertise-host", default=None,
                    help="dialable address to publish when binding 0.0.0.0")
    ap.add_argument("--secret-file", default=None,
                    help="file holding the shared swarm secret; enables "
                         "HMAC frame authentication (all members must use "
                         "the same secret)")
    args = ap.parse_args()
    from distributedvolunteercomputing_tpu_torch.swarm.coordinator import run_coordinator_forever
    from distributedvolunteercomputing_tpu_torch.swarm.transport import read_secret

    secret = read_secret(args.secret_file)
    try:
        asyncio.run(
            run_coordinator_forever(
                args.host, args.port, args.metrics, args.advertise_host, secret=secret
            )
        )
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
