# The port's copy of weaviate_tpu/__main__.py, its imports pointed at the port.
"""Process entry point: `python -m weaviate_tpu_torch`.

Reference: cmd/weaviate-server/main.go:30 — load config from the
environment, assemble the whole object graph, serve REST (+ metrics when
enabled) and gRPC until SIGTERM/SIGINT, then shut down cleanly.

Flags mirror the reference's swagger flags where they matter:
    --host (default 0.0.0.0), --port (default 8080; PORT env also honored),
    --grpc-port (default GRPC_PORT env / 50051), --data-path (overrides
    PERSISTENCE_DATA_PATH), and the port's --device (default cuda; cpu
    runs the whole server on the CPU). Everything else comes from the
    env-var surface (usecases/config/environment.go twin in
    weaviate_tpu_torch/config). Without a card and without --device cpu
    the process exits non-zero with the device's message.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="weaviate-tpu-torch", description=__doc__)
    ap.add_argument("--host", default=os.environ.get("HOST", "0.0.0.0"))
    ap.add_argument("--port", type=int, default=int(os.environ.get("PORT", "8080")))
    ap.add_argument("--grpc-port", type=int, default=None)
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the torch device the indexes live on (cuda or cpu)")
    args = ap.parse_args(argv)

    from weaviate_tpu_torch.config import load_config
    from weaviate_tpu_torch.device import resolve_device
    from weaviate_tpu_torch.server import App, RestServer
    from weaviate_tpu_torch.server.grpc_server import GrpcServer
    from weaviate_tpu_torch.version import __version__

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr, flush=True)
        return 2
    config = load_config()
    app = App(config=config, data_path=args.data_path, device=device)
    rest = RestServer(app, host=args.host, port=args.port)
    grpc_port = args.grpc_port if args.grpc_port is not None else config.grpc_port
    grpc_srv = GrpcServer(app, host=args.host, port=grpc_port)

    stop = threading.Event()

    def handle(signum, frame):
        print(f"received signal {signum}, shutting down", flush=True)
        stop.set()

    # handlers BEFORE the listeners come up: a supervisor that signals the
    # moment readiness flips must hit the graceful path, not the default
    # action
    signal.signal(signal.SIGTERM, handle)
    signal.signal(signal.SIGINT, handle)

    rest.start()
    grpc_srv.start()
    parts = [f"REST http://{args.host}:{rest.port}", f"gRPC {args.host}:{grpc_srv.port}"]
    if getattr(rest, "_metrics_httpd", None) is not None:
        parts.append(f"metrics :{rest.metrics_port}")
    print(f"weaviate-tpu-torch {__version__} serving on {device}: "
          + ", ".join(parts), flush=True)
    stop.wait()

    grpc_srv.stop()
    rest.stop()
    app.shutdown()
    print("shutdown complete", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
