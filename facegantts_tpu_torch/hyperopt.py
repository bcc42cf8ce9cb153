"""Hyperparameter sweeps (reference hyperopt/hyperopt.py:29-124).

Port of the JAX package's ``hyperopt.py``.  The reference drives train.py
subprocesses through cluster_utils CEM/grid search and scrapes the composite
metric back from eval_output.txt.  This native version keeps the same
contract — spawn the port's trainer, ``python -m facegantts_tpu_torch.train
key=value...`` (on the GPU unless ``fixed`` holds ``device: cpu``), read
``Composite Metric`` from the newest eval_output.txt that the in-training
evaluation writes under the trial's work_dir — but implements the search
loop itself (grid, random, or CEM — the reference's cluster_utils modes —
with no cluster_utils dependency).  A trial that fails scores ``inf``.

Usage:
  python -m facegantts_tpu_torch.hyperopt config=sweep.json [max_jobs=8] \
      [mode=grid|random|cem] [out_root=runs/sweep]

sweep.json: {"fixed": {...}, "grid": {"learning_rate": [1e-4, 1e-5], ...}}
or {"random": {"learning_rate": {"min": 1e-6, "max": 1e-3, "log": true}}}
or {"cem": {...same spec...}, "generations": 4, "population": 8}
"""

import itertools
import json
import os
import re
import subprocess
import sys
from typing import Any, Dict, Iterator, List

import numpy as np

METRIC_RE = re.compile(r"Composite Metric:\s*([0-9.eE+-]+)")


def read_composite(results_dir: str) -> float:
    """Newest eval_output.txt under results_dir -> composite value
    (reference hyperopt.py:102-124)."""
    candidates = []
    for base, _, files in os.walk(results_dir):
        if "eval_output.txt" in files:
            p = os.path.join(base, "eval_output.txt")
            candidates.append((os.path.getmtime(p), p))
    if not candidates:
        return float("inf")
    _, newest = max(candidates)
    m = METRIC_RE.search(open(newest).read())
    return float(m.group(1)) if m else float("inf")


def grid_points(grid: Dict[str, List[Any]]) -> Iterator[Dict[str, Any]]:
    keys = sorted(grid)
    for combo in itertools.product(*(grid[k] for k in keys)):
        yield dict(zip(keys, combo))


def random_points(spec: Dict[str, Dict], n: int, seed: int = 0) -> Iterator[Dict[str, Any]]:
    rng = np.random.default_rng(seed)
    for _ in range(n):
        point = {}
        for k, s in spec.items():
            if "choices" in s:
                point[k] = s["choices"][rng.integers(len(s["choices"]))]
            elif s.get("log"):
                point[k] = float(np.exp(rng.uniform(np.log(s["min"]), np.log(s["max"]))))
            else:
                point[k] = float(rng.uniform(s["min"], s["max"]))
        yield point


def cem_search(
    spec: Dict[str, Dict],
    fixed: Dict[str, Any],
    out_root: str,
    generations: int = 4,
    population: int = 8,
    elite_frac: float = 0.25,
    seed: int = 0,
    run=None,
) -> List[Dict[str, Any]]:
    """Cross-entropy-method search (the reference's cluster_utils mode,
    hyperopt_config.json): per continuous param keep a Gaussian in value- or
    log-space, sample a population each generation, refit mean/std on the
    elite quantile of the composite metric.  `choices` params are sampled
    from a categorical refit on elite counts."""
    rng = np.random.default_rng(seed)
    run = run or run_trial
    cont = {k: s for k, s in spec.items() if "choices" not in s}
    cat = {k: s["choices"] for k, s in spec.items() if "choices" in s}

    tf = {k: (np.log if s.get("log") else (lambda x: x)) for k, s in cont.items()}
    inv = {k: (np.exp if s.get("log") else (lambda x: x)) for k, s in cont.items()}
    mean = {k: (tf[k](s["min"]) + tf[k](s["max"])) / 2.0 for k, s in cont.items()}
    std = {k: (tf[k](s["max"]) - tf[k](s["min"])) / 4.0 for k, s in cont.items()}
    probs = {k: np.ones(len(c)) / len(c) for k, c in cat.items()}

    results, trial = [], 0
    n_elite = max(1, int(round(population * elite_frac)))
    for gen in range(generations):
        points = []
        for _ in range(population):
            p = {}
            for k, s in cont.items():
                lo, hi = tf[k](s["min"]), tf[k](s["max"])
                p[k] = float(inv[k](np.clip(rng.normal(mean[k], std[k]), lo, hi)))
            for k, c in cat.items():
                p[k] = c[rng.choice(len(c), p=probs[k])]
            points.append(p)
        scored = []
        for p in points:
            wd = os.path.join(out_root, f"trial_{trial:03d}")
            score = run({**fixed, **p}, wd)
            scored.append((score, p))
            results.append({"trial": trial, "generation": gen, "params": p,
                            "composite": score})
            trial += 1
        scored.sort(key=lambda t: t[0])
        elite = [p for _, p in scored[:n_elite]]
        for k in cont:
            vals = np.array([tf[k](p[k]) for p in elite])
            mean[k] = float(vals.mean())
            std[k] = max(float(vals.std()), 0.1 * std[k])  # floor: keep exploring
        for k, c in cat.items():
            counts = np.array([sum(1 for p in elite if p[k] == v) for v in c], float)
            probs[k] = (counts + 0.5) / (counts + 0.5).sum()  # add-half smoothing
        best = scored[0]
        print(f"[hyperopt/cem] gen {gen}: best composite={best[0]} params={best[1]}")
        with open(os.path.join(out_root, "results.json"), "w") as f:
            json.dump(sorted(results, key=lambda r: r["composite"]), f, indent=2)
    return results


def run_trial(params: Dict[str, Any], work_dir: str) -> float:
    args = [sys.executable, "-m", "facegantts_tpu_torch.train"] + [
        f"{k}={v}" for k, v in params.items()
    ] + [f"work_dir={work_dir}"]
    print("[hyperopt] running:", " ".join(args))
    env = dict(os.environ, DYNAMIC_EVAL_PATH=os.path.join(work_dir, "eval"))
    proc = subprocess.run(args, env=env)
    if proc.returncode != 0:
        print(f"[hyperopt] trial failed (rc={proc.returncode})")
        return float("inf")
    return read_composite(work_dir)


def sweep(config: Dict[str, Any], out_root: str = "runs/sweep", max_jobs: int = 8,
          mode: str = "grid", seed: int = 0) -> List[Dict[str, Any]]:
    fixed = config.get("fixed", {})
    if mode == "cem":
        # NOTE: cem runs generations x population trials (population defaults
        # to max_jobs); max_jobs is NOT an additional cap in this mode.
        os.makedirs(out_root, exist_ok=True)
        spec = config.get("cem", config.get("random"))
        if not spec:
            raise SystemExit(
                "hyperopt: mode=cem requires a 'cem' (or 'random') "
                "search-space block in the sweep config; found neither"
            )
        return cem_search(
            spec, fixed, out_root, seed=seed,
            generations=int(config.get("generations", 4)),
            population=int(config.get("population", max_jobs)),
            elite_frac=float(config.get("elite_frac", 0.25)),
        )
    if mode == "grid":
        points = list(grid_points(config["grid"]))[:max_jobs]
    else:
        points = list(random_points(config["random"], max_jobs, seed))
    os.makedirs(out_root, exist_ok=True)
    results = []
    for i, p in enumerate(points):
        wd = os.path.join(out_root, f"trial_{i:03d}")
        score = run_trial({**fixed, **p}, wd)
        results.append({"trial": i, "params": p, "composite": score})
        print(f"[hyperopt] trial {i}: composite={score}")
        with open(os.path.join(out_root, "results.json"), "w") as f:
            json.dump(sorted(results, key=lambda r: r["composite"]), f, indent=2)
    return results


def main(argv=None):
    from facegantts_tpu_torch.config import parse_cli_overrides

    o = parse_cli_overrides(argv if argv is not None else sys.argv[1:])
    with open(o.get("config", "sweep.json")) as f:
        cfg = json.load(f)
    sweep(
        cfg,
        out_root=o.get("out_root", "runs/sweep"),
        max_jobs=int(o.get("max_jobs", 8)),
        mode=o.get("mode", "grid"),
    )


if __name__ == "__main__":
    main()
