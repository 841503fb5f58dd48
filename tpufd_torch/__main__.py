"""Operator CLI of the PyTorch port.

  python -m tpufd_torch health     — run the probes on the card, print
                                     label lines (key=value, the NFD
                                     feature-file format)
  python -m tpufd_torch perfmodel  — print bare matmul-tflops= / hbm-gbps=
                                     lines (the daemon's --perf-exec
                                     payload)
  python -m tpufd_torch burnin     — run the burn-in train step on one
                                     card (forward, backward, SGD) and
                                     report its final loss

All run on the CUDA card and fail without one, unless --device cpu asks
for the host.
"""

import argparse
import math
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


def cmd_burnin(args):
    import torch

    from tpufd_torch import burnin, health, mesh, metrics

    device = health.resolve_device(args.device)
    data_n, model_n = mesh.data_model_shape(1, args.model_parallelism)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"devices: 1 x {kind}")
    print(f"mesh: data={data_n} model={model_n}")
    n_visible = torch.cuda.device_count() if on_card else 1
    if n_visible > 1:
        sys.stderr.write(
            f"burn-in runs on {device} alone: {n_visible} cards visible "
            f"and the sharded step and the ring attention check are not "
            f"ported\n")
    loss = burnin.run_burnin(device=device, steps=args.steps,
                             model_parallelism=args.model_parallelism)
    ok = math.isfinite(loss)
    print(f"final loss after {args.steps} steps: {loss:.6f} "
          f"({'ok' if ok else 'NOT FINITE'})")
    if args.metrics_out:
        metrics.default_registry().write_textfile(args.metrics_out)
    return 0 if ok else 1


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

    def positive_int(text):
        value = int(text)
        if value < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return value

    burnin = sub.add_parser("burnin", help="burn-in train step on one card")
    burnin.add_argument("--steps", type=positive_int, default=2)
    burnin.add_argument("--model-parallelism", type=int, default=None)
    burnin.add_argument(
        "--skip-ring", action="store_true",
        help="skip the ring-attention check (it runs only across cards, "
             "which the port does not drive yet)")
    burnin.add_argument(
        "--metrics-out", default="",
        help="also write step timing telemetry as a Prometheus textfile "
             "to this path")
    add_device(burnin)
    burnin.set_defaults(fn=cmd_burnin)

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
