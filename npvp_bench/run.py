"""Run one cell of the benchmark of ``npvp_tpu_torch`` once.

    python3 npvp_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number compared
with the plain reference beside its limit, which are also the last lines
of standard error.

The cell runs in a child process; this one is the subreaper of everything
the run starts and exits once all of it has ended. Caches of built code
stay at fixed paths inside the checkout (``.bench_cache/``, and the
port's own ``_build`` directories). The run exits non-zero and prints no
result without enough CUDA devices, or if ``jax``, ``jaxlib``, ``flax`` or
``npvp_tpu`` was imported by the time the window closed.
"""

import time

START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
CHILD_ENV = "NPVP_BENCH_STARTED"
FORBIDDEN = ("jax", "jaxlib", "flax", "npvp_tpu")
REAP_SECONDS = 30.0


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules(modules=None):
    """Top-level names of ``modules`` (``sys.modules``) that are, whole,
    one of :data:`FORBIDDEN`."""
    names = {m.split(".")[0] for m in (modules or sys.modules)}
    return sorted(names.intersection(FORBIDDEN))


def child_environment() -> dict:
    env = dict(os.environ)
    env[CHILD_ENV] = repr(START)
    env["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    env["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    env["USE_FLAX"] = "0"
    env["USE_JAX"] = "0"
    # one process with few threads: the host-bound cells' pace is the
    # main thread's, and idle OpenMP workers only contend with it
    env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
    env["PYTHONHASHSEED"] = "0"
    return env


def _children(pid: int):
    out = []
    for task in Path(f"/proc/{pid}/task").glob("*"):
        try:
            out += [int(c) for c in (task / "children").read_text().split()]
        except OSError:
            pass
    return out


def reap(deadline: float) -> list:
    """Wait for every descendant left (this process adopts them as the
    subreaper) until ``deadline``; end the ones still there. Returns what
    had to be ended."""
    ended = []
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return ended
        if pid == 0:
            if time.time() > deadline:
                for c in _children(os.getpid()):
                    try:
                        os.kill(c, signal.SIGKILL)
                        ended.append(c)
                    except ProcessLookupError:
                        pass
                deadline = float("inf")
            time.sleep(0.05)


def supervise(argv) -> int:
    import ctypes

    ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)  # subreaper
    proc = subprocess.Popen([sys.executable, __file__, *argv],
                            env=child_environment())

    def forward(signum, frame):
        proc.send_signal(signum)

    signal.signal(signal.SIGTERM, forward)
    signal.signal(signal.SIGINT, forward)
    rc = proc.wait()
    ended = reap(time.time() + REAP_SECONDS)
    if ended:
        print(f"run.py: ended {len(ended)} process(es) left behind: "
              f"{ended}", file=sys.stderr, flush=True)
        return rc or 4
    return rc


def run(args) -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from npvp_bench import check, harness

    harness.log(f"set-up: torch imported at "
                f"{time.time() - float(os.environ[CHILD_ENV]):.3f} s")

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(manifest, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"run.py: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = harness.make_context(manifest, args.workload, args.seed,
                               args.seconds, bool(args.trace), "cuda",
                               float(os.environ[CHILD_ENV]))
    result = harness.run_cell(manifest, ctx)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the run imported {bad}", file=sys.stderr)
        return 3
    harness.log(f"card: {harness.power_limit()}")
    for line in check.lines(result["checks"]):
        harness.log(line)
    print(json.dumps(result), flush=True)
    return 0


def main(argv) -> int:
    if CHILD_ENV in os.environ:
        return run(parse(argv))
    parse(argv)
    return supervise(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
