"""Scaler Deployment entrypoint: ``python -m tpuserve_torch.autoscale``.

Runs the reconcile loop against a Kubernetes engine pool and serves
its own ``/metrics`` (tpuserve_autoscaler_* families + the cold-start
histogram) and ``/healthz`` so the cluster's Prometheus scrape-by-
annotation picks the control plane up like any other pod.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tpuserve_torch.autoscale.policy import AutoscalePolicy, PolicyConfig
from tpuserve_torch.autoscale.reconciler import KubePool, Reconciler

logger = logging.getLogger("tpuserve_torch.autoscale")


def _serve_metrics(reconciler: Reconciler, metrics, host: str,
                   port: int) -> int:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

        def do_GET(self):
            if self.path == "/metrics":
                data, ctype = metrics.render(), \
                    "text/plain; version=0.0.4"
            elif self.path == "/healthz":
                data, ctype = b'{"status":"ok"}', "application/json"
            elif self.path == "/backends":
                # the ready-replica list for the gateway's
                # --backends-url poll loop: scale-out replicas join
                # after their first scrape, retired/terminating ones
                # drop out on the next observe — and an EMPTY list is
                # what makes the gateway count unserved demand, closing
                # the scale-from-zero loop
                data = json.dumps(
                    reconciler.backend.ready_urls()).encode()
                ctype = "application/json"
            elif self.path == "/decisions":
                data = json.dumps(
                    [d.as_tuple() for d in
                     reconciler.policy.decisions[-256:]]).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="tpuserve-autoscaler-http").start()
    return httpd.server_address[1]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("tpuserve_torch.autoscale")
    ap.add_argument("--namespace", required=True)
    ap.add_argument("--deployment", default="tpuserve-engine")
    ap.add_argument("--selector",
                    default="app=tpuserve,component=engine")
    ap.add_argument("--engine-port", type=int, default=8000,
                    help="port the engine pods serve /debug/engine on")
    ap.add_argument("--gateway-url", default=None,
                    help="gateway base URL; its unserved counter is "
                         "the scale-from-zero demand signal")
    ap.add_argument("--backends-file", default=None,
                    help="publish the ready-backend list here for the "
                         "gateway's --backends-file poll loop")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="control-loop cadence, seconds")
    ap.add_argument("--min-replicas", type=int, default=0)
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--brownout-out-level", type=int, default=1)
    ap.add_argument("--queue-delay-out-s", type=float, default=0.5)
    ap.add_argument("--ttft-p95-out-s", type=float, default=0.0)
    ap.add_argument("--scale-out-cooldown-s", type=float, default=30.0)
    ap.add_argument("--scale-in-cooldown-s", type=float, default=120.0)
    ap.add_argument("--idle-in-s", type=float, default=60.0)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9090,
                    help="the scaler's own /metrics + /healthz port")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    policy = AutoscalePolicy(PolicyConfig(
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        brownout_out_level=args.brownout_out_level,
        queue_delay_out_s=args.queue_delay_out_s,
        ttft_p95_out_s=args.ttft_p95_out_s,
        scale_out_cooldown_s=args.scale_out_cooldown_s,
        scale_in_cooldown_s=args.scale_in_cooldown_s,
        idle_in_s=args.idle_in_s))
    pool = KubePool(args.namespace, deployment=args.deployment,
                    selector=args.selector, port=args.engine_port,
                    gateway_url=args.gateway_url)
    from tpuserve_torch.server.metrics import AutoscalerMetrics
    metrics = AutoscalerMetrics()
    rec = Reconciler(pool, policy, metrics=metrics,
                     backends_file=args.backends_file,
                     pool_name=args.deployment)
    port = _serve_metrics(rec, metrics, args.host, args.port)
    logger.info("autoscaler up on :%d — %s/%s every %.1fs "
                "(replicas %d..%d)", port, args.namespace,
                args.deployment, args.interval, args.min_replicas,
                args.max_replicas)
    try:
        rec.serve(interval_s=args.interval)
    except KeyboardInterrupt:
        rec.shutdown()


if __name__ == "__main__":
    main()
