"""Run one cell of the benchmark once on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights made on the card from the seed, the traffic's pools, the
warm-up that captures every program the cell's traffic uses), then the
measured window of `--seconds`, then with `--trace 1` a profiled part,
then the check against the plain reference. The last line of standard
output is the result object; the last lines of standard error are the
numbers compared, each beside its limit. Exits non-zero, printing no
result, without a CUDA card, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "cape_tpu")


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no JAX through
    third-party libraries."""
    cache = os.path.join(ROOT, "output", "bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for k in ("CAPE_MSDA_GATHER", "CAPE_MSDA_TINY", "CAPE_DECODE_PREQUAD"):
        os.environ.pop(k, None)
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    import common
    import harness
    cell = common.cell_files(args.workload)
    print(f"set-up: imports at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    need = cell["cell"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < need:
        print(f"needs {need} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    result = harness.execute(args.workload, args.seed % (2 ** 62),
                             args.seconds, bool(args.trace), "cuda:0",
                             T_START, files=cell)
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, v in result.pop("readings").items():
        if name not in result["checks"]:
            print(f"reading {name}: {v!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
