"""The data-driven inis run end to end through the CLI, from one or more
checkouts in turns, on the card.

    python -m polychordlite_tpu_torch.experiments.data_ini_runs [--inis NAME ...] [CHECKOUT ...]

For each checkout (default: this one; another is a directory holding a
copy of the repository, such as ``git archive <rev> | tar -x -C DIR``),
runs ``python -m polychordlite_tpu_torch`` on copies of ``ini/fitting.ini``
and ``ini/object_detection.ini``, or of the inis ``--inis`` names
(``base_dir`` in a new directory, seed 7, the checkout's ``data/``), each
in a process of its own, the checkouts in
turns, forward then back.  Prints one JSON line a run: the checkout, the
ini, wall seconds, dead points a second, the route and its reason, the
kernel launches, ``device_frac``, the epoch timers (``enqueue`` among
them), the host totals, logZ and its error, from the run's last metrics
record and its ``.stats``.  Needs a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
INIS = ("fitting", "object_detection")
SEED = 7


def ini_copy(checkout: str, name: str, base: str) -> str:
    """``checkout``'s ini/<name>.ini with ``base_dir`` set to ``base``, its
    own ``data/`` and a seed added."""
    lines = []
    with open(os.path.join(checkout, "ini", f"{name}.ini")) as f:
        for ln in f.read().splitlines():
            key = ln.split("=")[0].strip()
            if key == "base_dir":
                ln = f"base_dir = {base}"
            elif key == "data_dir":
                ln = f"data_dir = {os.path.join(checkout, 'data')}"
            lines.append(ln)
    lines.insert(lines.index("[ output settings ]") + 1, f"seed = {SEED}")
    path = os.path.join(base, f"{name}.ini")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def run(checkout: str, name: str) -> dict:
    """One CLI run of ``name``'s ini from ``checkout``: its record."""
    with tempfile.TemporaryDirectory() as base:
        ini = ini_copy(checkout, name, base)
        env = {**os.environ, "PYTHONPATH": checkout}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "polychordlite_tpu_torch", ini],
                              cwd=checkout, env=env, capture_output=True, text=True,
                              timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{checkout} {name}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        with open(os.path.join(base, f"{name}.metrics.jsonl")) as f:
            last = json.loads(f.read().splitlines()[-1])
        summary = [ln for ln in proc.stdout.splitlines() if ln.startswith("logZ = ")]
        ndead = int(summary[-1].split("ndead =")[1].split("|")[0]) if summary else None
    return {"checkout": checkout, "ini": name, "wall_s": wall, "ndead": ndead,
            "dead_per_s": ndead / wall if ndead else None, "route": last.get("route"),
            "route_reason": last.get("route_reason"),
            "launches": {k: v for k, v in last.get("kernel_launches", {}).items() if v},
            "device_frac": last.get("device_frac"), "epoch_timers_s": last.get("epoch_timers"),
            "host_totals_s": last.get("host_totals"), "summary": summary[-1] if summary else None}


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--inis", nargs="*", default=list(INIS))
    p.add_argument("checkouts", nargs="*")
    a = p.parse_args(argv)
    checkouts = [os.path.abspath(c) for c in a.checkouts] or [HERE]
    for turn in (checkouts, checkouts[::-1]):
        for checkout in turn:
            for name in a.inis:
                print(json.dumps(run(checkout, name)), flush=True)


if __name__ == "__main__":
    main()
