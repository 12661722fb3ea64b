"""Local sweep runner: executes the grid defined by a configs/*.yml file.

The reference orchestrates hyperparameter grids through wandb sweeps
(experiments/wandb_utils.py + configs/*.yml).  This environment is sealed, so
the same sweep YAMLs drive a LOCAL cartesian-product runner: each grid point
launches the config's ``program`` as a subprocess with the parameters as CLI
flags, and the one-line JSON summaries each trainer prints are aggregated
into ``<out>/sweep_results.jsonl``.

Grid points run one at a time, each in its own process, and this parent
never imports JAX: a JAX process reserves most of a GPU's memory when it
first uses it, so only one process may hold the card at a time.

Usage:
    python experiments/sweep.py configs/simplexgp.yml --out runs/sweep_simplexgp
    python experiments/sweep.py configs/mvm_err.yml --dry-run
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import subprocess
import sys


def load_config(path: str) -> dict:
    """Minimal YAML subset reader for the sweep configs (no pyyaml needed):
    two-level mappings with ``value:`` / ``values: [..]`` leaves."""
    try:
        import yaml  # type: ignore

        return yaml.safe_load(pathlib.Path(path).read_text())
    except ModuleNotFoundError:
        pass

    cfg: dict = {"parameters": {}}
    cur_param = None
    in_params = False
    for raw in pathlib.Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, val = line.strip().partition(":")
        val = val.strip()
        if indent == 0:
            in_params = key == "parameters"
            if not in_params and val:
                cfg[key] = _scalar(val)
        elif in_params and indent == 2:
            cur_param = key
            cfg["parameters"][cur_param] = {}
        elif in_params and indent >= 4 and cur_param is not None:
            if key == "value":
                cfg["parameters"][cur_param]["value"] = _scalar(val)
            elif key == "values":
                items = val.strip("[]")
                cfg["parameters"][cur_param]["values"] = [
                    _scalar(v.strip()) for v in items.split(",") if v.strip()
                ]
    return cfg


def _scalar(s: str):
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def grid_points(parameters: dict):
    names, val_lists = [], []
    for name, spec in parameters.items():
        names.append(name)
        val_lists.append(spec["values"] if "values" in spec else [spec["value"]])
    for combo in itertools.product(*val_lists):
        yield dict(zip(names, combo))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--out", default=None)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--limit", type=int, default=0, help="run only the first k grid points")
    args, extra = p.parse_known_args()  # unrecognized flags pass through to every run

    cfg = load_config(args.config)
    program = cfg["program"]
    out_dir = pathlib.Path(
        args.out or f"runs/sweep_{pathlib.Path(args.config).stem}"
    )
    out_dir.mkdir(parents=True, exist_ok=True)
    results_path = out_dir / "sweep_results.jsonl"

    points = list(grid_points(cfg.get("parameters", {})))
    if args.limit:
        points = points[: args.limit]
    print(f"{len(points)} grid points for {program}")
    for i, point in enumerate(points):
        flags = []
        for k, v in point.items():
            flags += [f"--{k}", str(v)]
        cmd = [sys.executable, program] + flags + extra
        print(f"[{i + 1}/{len(points)}]", " ".join(cmd))
        if args.dry_run:
            continue
        proc = subprocess.run(cmd, capture_output=True, text=True)
        # Trainers print one JSON summary line on stdout; keep the last one.
        summary = None
        for line in reversed(proc.stdout.strip().splitlines()):
            try:
                summary = json.loads(line)
                break
            except json.JSONDecodeError:
                continue
        rec = {"point": point, "returncode": proc.returncode, "summary": summary}
        if proc.returncode != 0:
            rec["stderr_tail"] = proc.stderr.strip().splitlines()[-5:]
        with results_path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
    if not args.dry_run:
        print(f"results -> {results_path}")


if __name__ == "__main__":
    main()
