"""Operator CLI of the PyTorch port.

  python -m tpufd_torch health     — run the probes on the card, print
                                     label lines (key=value, the NFD
                                     feature-file format)
  python -m tpufd_torch perfmodel  — print bare matmul-tflops= / hbm-gbps=
                                     lines (the daemon's --perf-exec
                                     payload)

Both run on the CUDA card and fail without one, unless --device cpu asks
for the host.
"""

import argparse
import sys


def cmd_health(args):
    from tpufd_torch import health, metrics

    labels = health.health_labels(prefix=args.prefix,
                                  extended=args.extended,
                                  device=args.device)
    for key in sorted(labels):
        print(f"{key}={labels[key]}")
    if args.metrics_out:
        metrics.default_registry().write_textfile(args.metrics_out)
    return 0 if labels.get(args.prefix + "ok") == "true" else 1


def cmd_perfmodel(args):
    from tpufd_torch import perfmodel

    return perfmodel.main(device=args.device)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m tpufd_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def add_device(p):
        p.add_argument(
            "--device", default=None,
            help="where the probes run: the CUDA card by default (cuda, "
                 "cuda:N); 'cpu' runs them on the host")

    health = sub.add_parser("health", help="on-card health probe labels")
    health.add_argument("--prefix", default="google.com/tpu.health.")
    health.add_argument(
        "--extended", action="store_true",
        help="add the DMA-copy kernel probe (dma-copy-gbps): slower, "
             "tells a sick copy path from sick HBM")
    health.add_argument(
        "--metrics-out", default="",
        help="also write probe-timing telemetry as a Prometheus textfile "
             "(node-exporter textfile-collector format) to this path")
    add_device(health)
    health.set_defaults(fn=cmd_health)

    perfmodel = sub.add_parser(
        "perfmodel",
        help="perf-characterization measurement: print bare "
             "matmul-tflops=/hbm-gbps= lines (the daemon's --perf-exec "
             "payload). Honors TFD_PERF_EXCLUDE_CHIPS=<ordinal,...>")
    add_device(perfmodel)
    perfmodel.set_defaults(fn=cmd_perfmodel)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
