"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/mixes/<traffic>.json``, whose ``kind`` names the loop,
``benchmark/loops/<kind>.py``); the limits of its comparison
are ``benchmark/limits/<workload>.json``. With ``--trace 0`` the line holds
the cell's end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` and the line holds its per-layer metrics, each read by
``benchmark/metrics/<metric>.py``, with ``busy_s``, ``window_s`` and the
``breakdown``.

Without as many CUDA devices as the cell asks for it exits with 2 and
prints no result; it never falls back to the CPU. It exits with 3, and no
result, when the process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is timed from here: before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Mapping, Optional, Sequence  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "plip_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> Sequence[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device,
             bench: Optional[Mapping] = None, cfg: Optional[Mapping] = None,
             mix: Optional[Mapping] = None, limits: Optional[Mapping] = None,
             controls: Sequence[str] = (), t0: float = T0):
    """(the result line as a dict, the Result). ``cfg``, ``mix`` and
    ``limits`` replace the cell's files (the benchmark's tests run a cell at
    a small size on the CPU this way)."""
    import importlib

    import torch

    from . import readers

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg = cfg or load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = mix or load_json(HERE / "mixes" / f"{cell['traffic']}.json")
    limits = limits or load_json(HERE / "limits" / f"{workload}.json")
    loop = importlib.import_module(f"{__package__}.loops.{mix['kind']}")
    device = torch.device(device)
    res = loop.run(cfg, mix, seed, seconds, traced, device, t0, controls)

    checks = {k: {"value": v, "limit": limits[k]} for k, v in res.readings.items()}
    correct = (res.attempted > 0 and res.failed == 0 and all(res.holds.values())
               and all(c["value"] <= c["limit"] for c in checks.values()))
    line = {"correct": bool(correct), "attempted": res.attempted, "failed": res.failed}
    metrics = {}
    if not traced:
        for m in bench["end_to_end"]:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": res.setup_s, "unit": m["unit"]}
            elif m["name"] in res.metrics and workload in m.get("workloads", [workload]):
                metrics[m["name"]] = {"value": res.metrics[m["name"]][0], "unit": m["unit"]}
    else:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else None
        peaks = load_json(HERE / "peaks.json").get(name)
        run = readers.Run(cfg=cfg, dtype=mix["dtype"], trace=res.trace,
                          span_seconds=res.span_seconds, works=res.works, items=res.items,
                          steps=res.steps, memory_peak_bytes=res.memory_peak_bytes,
                          peaks=peaks)
        for m in bench["per_layer"]:
            if workload in m.get("workloads", [workload]):
                value = readers.load_reader(m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line["metrics"] = metrics
    line["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                      "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": res.memory_peak_bytes}
    if traced and res.trace:
        line["device"]["busy_s"] = res.trace["busy_s"]
        line["device"]["window_s"] = res.trace["window_s"]
        line["breakdown"] = {"device_ops": [list(x) for x in res.trace["device_ops"]],
                             "idle_gaps": [list(x) for x in res.trace["idle_gaps"]]}
    line["checks"] = {**checks, **{k: {"value": int(v), "limit": 1}
                                   for k, v in res.holds.items()}}
    return line, res


def finite(x):
    """``x`` with every non-finite float written as a string (``"inf"``),
    so the line stays JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}",
              file=sys.stderr)
        return 2
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                         bench=bench)
    bad = forbidden_modules()
    if bad:
        print("loaded JAX or the JAX package: " + ", ".join(bad), file=sys.stderr)
        return 3
    for k, v in res.notes.items():
        print(f"note {k} {json.dumps(finite(v))}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(line)))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
