#!/usr/bin/env python3
"""Benchmark of ``whisper_timestamped_tpu_torch`` on CUDA cards: one run of
one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is ``portbench/workloads/<name>.json``
(with its configuration and traffic mix, named there); the metrics are
those ``BENCHMARK.json`` gives the cell, end to end with ``--trace 0``,
per layer with ``--trace 1``. The last line of standard output is the
result as JSON; the numbers compared with the reference, each beside its
limit, are the last lines of standard error and the result's last key.

Exits non-zero, and prints no result, without as many CUDA cards as the
cell asks for, without the system under test, or if JAX or the JAX package
was imported. Builds of the system's kernels go to ``build/portbench/``
inside the checkout; the system's ``WTT_*`` environment variables are
dropped, so that the cell alone states its levers. ``--control fp8``
judges the reference computed one precision lower in the system's place
(the control of the comparison); ``--rate`` overrides an open-loop
cell's offered rate (the sweep for its knee). The benchmark's own runs use
neither."""

import os
import sys
import time


def _process_t0() -> float:
    """The process's start on the ``perf_counter`` clock."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


PROCESS_T0 = _process_t0()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from pbcore import guard  # noqa: E402

guard.install()

import argparse  # noqa: E402

from pbcore import device, manifest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args(argv)

    cell = manifest.cell(args.workload)
    device.require(cell.spec["chips"])
    build = os.path.join(manifest.CHECKOUT, "build", "portbench")
    os.environ["WTT_TORCH_BUILD_DIR"] = build
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    # the cell states every lever and route: none is taken from the environment
    for key in [k for k in os.environ if k.startswith("WTT_") and k != "WTT_TORCH_BUILD_DIR"]:
        del os.environ[key]
    sys.path.append(manifest.CHECKOUT)
    try:
        import whisper_timestamped_tpu_torch  # noqa: F401
    except ImportError as exc:
        raise SystemExit(f"portbench: the system under test is not importable: {exc}")

    from pbcore import harness

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", PROCESS_T0,
                              control=args.control, rate=args.rate,
                              log=lambda m: print(m, file=sys.stderr, flush=True))
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
