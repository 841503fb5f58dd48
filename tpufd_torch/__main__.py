"""Operator CLI of the PyTorch port.

  python -m tpufd_torch health     — run the probes on the card, print
                                     label lines (key=value, the NFD
                                     feature-file format)
  python -m tpufd_torch perfmodel  — print bare matmul-tflops= / hbm-gbps=
                                     lines (the daemon's --perf-exec
                                     payload)
  python -m tpufd_torch burnin     — run the burn-in train step
                                     (forward, backward, SGD), sharded
                                     over every card when there are
                                     several, then ring attention across
                                     them, and report the final loss
  python -m tpufd_torch journal    — fetch a daemon's /debug/journal (or
                                     read a SIGUSR1 dump file) and
                                     pretty-print the flight recorder

health, perfmodel and burnin run on the CUDA card and fail without one,
unless --device cpu asks for the host; journal touches no device.
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

    from tpufd_torch import burnin, health, launch, mesh, metrics

    device = health.resolve_device(args.device)
    on_card = device.type == "cuda"
    n_cards = torch.cuda.device_count() if on_card else 1
    data_n, model_n = mesh.data_model_shape(n_cards, args.model_parallelism)
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"devices: {n_cards} x {kind}")
    print(f"mesh: data={data_n} model={model_n}")
    if n_cards == 1:
        loss = burnin.run_burnin(device=device, steps=args.steps,
                                 model_parallelism=args.model_parallelism)
        rings = []
        if args.metrics_out:
            metrics.default_registry().write_textfile(args.metrics_out)
    else:
        # One NCCL rank per card: the sharded step over a (data, model)
        # mesh, then ring attention over all cards, each checked for
        # equality against full attention.
        result = launch.spawn_ranks(
            burnin.sharded_acceptance, n_cards, "cuda",
            args=("cuda", args.steps, args.model_parallelism,
                  not args.skip_ring, args.metrics_out))
        loss, rings = result["loss"], result["ring"]
    ok = math.isfinite(loss)
    print(f"final loss after {args.steps} steps: {loss:.6f} "
          f"({'ok' if ok else 'NOT FINITE'})")
    for mode, err, error in rings:
        if error is None:
            print(f"{mode} ring attention over context={n_cards}: max abs "
                  f"err {err:.2e} vs full attention (ok)")
        else:
            print(f"{mode} ring attention FAILED: {error}")
            ok = False
    return 0 if ok else 1


def cmd_perfmodel(args):
    from tpufd_torch import perfmodel

    return perfmodel.main(device=args.device)


def cmd_journal(args):
    import json
    import urllib.request

    from tpufd_torch import journal as journal_lib

    if args.file:
        with open(args.file) as f:
            doc = json.load(f)
        # A SIGUSR1 dump embeds the journal next to snapshots/labels.
        if "journal" in doc:
            doc = doc["journal"]
    else:
        url = (f"{args.url.rstrip('/')}/debug/journal"
               f"?n={args.n}&type={args.type}")
        with urllib.request.urlopen(url, timeout=5) as r:
            doc = json.load(r)
    doc = journal_lib.parse_journal(doc)
    if args.raw:
        print(json.dumps(doc, indent=2))
    else:
        print(journal_lib.dump_text(doc))
    return 0


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

    burnin = sub.add_parser("burnin", help="sharded burn-in train step")
    burnin.add_argument("--steps", type=positive_int, default=2)
    burnin.add_argument("--model-parallelism", type=int, default=None)
    burnin.add_argument(
        "--skip-ring", action="store_true",
        help="skip the context-parallel ring-attention acceptance check "
             "(runs by default when several cards are visible)")
    burnin.add_argument(
        "--metrics-out", default="",
        help="also write step/ring timing telemetry as a Prometheus "
             "textfile to this path")
    add_device(burnin)
    burnin.set_defaults(fn=cmd_burnin)

    perfmodel = sub.add_parser(
        "perfmodel",
        help="perf-characterization measurement: print bare "
             "matmul-tflops=/hbm-gbps= lines (the daemon's --perf-exec "
             "payload). Honors TFD_PERF_EXCLUDE_CHIPS=<ordinal,...>")
    add_device(perfmodel)
    perfmodel.set_defaults(fn=cmd_perfmodel)

    journal = sub.add_parser(
        "journal", help="pretty-print a daemon's flight recorder")
    journal.add_argument(
        "--url", default="http://127.0.0.1:8081",
        help="daemon introspection base URL (serves /debug/journal)")
    journal.add_argument(
        "--file", default="",
        help="read a SIGUSR1 dump (or raw /debug/journal JSON) from a "
             "file instead of fetching")
    journal.add_argument("--n", type=int, default=0,
                         help="newest N events (0 = all retained)")
    journal.add_argument("--type", default="",
                         help="filter by event type (e.g. label-diff)")
    journal.add_argument("--raw", action="store_true",
                         help="print the JSON instead of pretty text")
    journal.set_defaults(fn=cmd_journal)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
