"""The benchmark of plvs_tpu_torch: one run of one cell.

    python3 slam_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card. The run
loads the cell's files by name (``registry.py``), renders the session from
the seed, builds the System from the configuration's YAML as ``run_slam``
does, warms up, measures for ``--seconds`` (``harness.py``), checks what the
window produced against the plain reference (``reference/``), and prints as
its last line on standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number and its limit,
also the last lines on standard error).

Without a CUDA card, with fewer cards than the cell asks for, or with a
module of jax, jaxlib, flax or plvs_tpu loaded once the window has closed,
it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "plvs_tpu")


def pin_caches():
    """Compile caches at fixed paths inside the checkout, so that only the
    first run of a cell in a checkout compiles: Triton's, Inductor's,
    PyTorch's runtime-compiled kernels' and CUDA's JIT cache (the
    program's nvcc libraries already live in plvs_tpu_torch/_build/)."""
    cache = os.path.join(HERE, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(cache, "torch")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from slam_bench import registry

    work = {w["name"]: w for w in registry.load_benchmark(ROOT)["workloads"]}
    if args.workload not in work:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = int(work[args.workload]["chips"])
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on one", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    from slam_bench import harness

    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_process=T_START)
    result.pop("readings", None)
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that a run may not load: {bad}",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
