"""The fused route on the data-driven inis' models on the card: forms of
each model's functor (``ops/fused_like.py``, one data loop a model), made by
patching the generated header, each checked against its plain version in a
process of its own, the bitwise ones timed beside the traced route.

    python -m polychordlite_tpu_torch.experiments.fused_data_times [--reps N]
        [--groups G ...] [--forms F ...] [--models M ...] [--jobs N]

At the batches ``ini/fitting.ini`` and ``ini/object_detection.ini`` give
the kernel (``chip_smoke.DATA_RUNS``), on mid-run inputs
(``chip_smoke.mid_run_inputs``), builds ``csrc/slice_epoch_fused.cu`` for
each form of :data:`FORMS` at each G of ``--groups`` (default the rule's G
without the rows, 16 and 32; the route's own is
``pallas_slice_v4.route_group``'s, 32), one nvcc each, all started
together.  The forms:

* ``route``: the header as the route builds it (FUSED_ROW_LANES = G: lane g
  runs the rows of virtual lanes g, g + G, ...; every lane the same row
  trip count, a row past the end computing row 0 unfolded);
* ``redundant``: FUSED_ROW_LANES 1, every lane runs every row (B3's form);
* ``lane_trips``: each lane leaves the row loop after its own last row;
* ``loads64`` / ``loads32``: each float64 slot read as one 8-byte load, or
  as two 32-bit loads;
* ``syncwarp``: a ``__syncwarp()`` before the fold's shuffles;
* ``checked``: every float64 slot's word index and every row checked
  against their ranges, a ``printf`` for each outside (the slot then read
  by ``fused_f64``, or by a later form's reader);

and any of them joined by ``+``, applied in that order
(``lane_trips+checked+loads32``).  Each (form, G)
runs one epoch in a child process (a fault ends its CUDA context, not the
study's), ``--jobs`` at a time, against the plain version
(``slice_records_plain`` on ``Lowered.plain_logL``, on the card, computed
once): its t, logL and nlike mismatches (the fold order depends on neither
G nor the form), or its error, and the first lines it printed.  Then the
bitwise forms are timed by CUDA events (one warm-up, ``--reps`` epochs), in
turns forward then backward, beside the traced route (``slice_step``).
Prints per model one JSON line: the checks, ms of each form and of the
traced route, evals, the bound (``chip_smoke.fused_bound``), nvcc seconds,
ptxas's registers and spills, and the functor's source lines.  Run from the
repository's root (it imports ``chip_smoke``).  Needs a card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KEY_WORDS = (0x01234567, 0x89ABCDEF)
SEED = 1234

_LOADS = {
    "loads64": "return __ldg(reinterpret_cast<const double*>(c + at));",
    "loads32": "return __hiloint2double(__float_as_int(__ldg(c + at + 1)), "
               "__float_as_int(__ldg(c + at)));",
}


def _f64_reader(src: str, name: str, body: str) -> str:
    """``src`` with its float64 slots read by a function ``name`` of
    ``body``, put first in the header (so that a later patch's reader,
    put before it, can replace a ``fused_f64`` that ``body`` calls)."""
    fn = (f"__device__ __forceinline__ double {name}(const float* c, int at) {{\n"
          f"    {body}\n}}\n")
    return src.replace("fused_f64(c, ", f"{name}(c, ").replace("#pragma once\n",
                                                               "#pragma once\n" + fn, 1)


def _lane_trips(src: str, low) -> str:
    return re.sub(r"r0 < (\d+); r0 \+= 32\) \{", r"r0 + lane < \1; r0 += 32) {", src)


def _checked(src: str, low) -> str:
    end = low.nc64_at + 2 * len(low.consts64)
    src = _f64_reader(src, "fused_f64_checked", (
        f"if ((at & 1) || at < {low.nc64_at} || at >= {end})\n"
        f'        printf("float64 slot word %d outside [{low.nc64_at}, {end}) thread %d '
        'block %d\\n", at, (int)threadIdx.x, (int)blockIdx.x);\n'
        "    return fused_f64(c, at);"))
    rows = low.data_rows
    src = src.replace("#pragma once\n", "#pragma once\n#include <cstdio>\n", 1)
    return src.replace("const int r = on ? r0 + lane : 0;", (
        "const int r = on ? r0 + lane : 0;\n"
        f"                    if (r < 0 || r >= {rows}) printf(\"row %d outside [0, {rows}) "
        "thread %d block %d\\n\", r, (int)threadIdx.x, (int)blockIdx.x);"))


#: each form's patch of the generated header text (module docstring)
FORMS = {
    "route": lambda src, low: src,
    "redundant": lambda src, low: re.sub(r"#define FUSED_ROW_LANES \d+",
                                         "#define FUSED_ROW_LANES 1", src),
    "lane_trips": _lane_trips,
    "loads64": lambda src, low: _f64_reader(src, "fused_f64_wide", _LOADS["loads64"]),
    "loads32": lambda src, low: _f64_reader(src, "fused_f64_narrow", _LOADS["loads32"]),
    "syncwarp": lambda src, low: re.sub(r"(\n +)(s\d+ = fold\.result\()", r"\1__syncwarp();\1\2",
                                        src),
    "checked": _checked,
}


@dataclasses.dataclass
class Patched:
    """A lowering whose generated header is ``form``'s patch of ``low``'s
    (its library named by the patched text's hash); every other attribute
    is ``low``'s."""

    low: object
    form: str

    def __getattr__(self, name):
        return getattr(self.low, name)

    def source(self, group: int, engine: str = "cuda", ring: bool = False) -> str:
        src = self.low.source(group, engine, ring)
        for part in self.form.split("+"):
            src = FORMS[part](src, self.low)
        return src

    def key(self, group: int, engine: str = "cuda", ring: bool = False) -> str:
        import hashlib

        return hashlib.sha256(self.source(group, engine, ring).encode()).hexdigest()[:16]

    def library_name(self, group: int, engine: str = "cuda", ring: bool = False) -> str:
        return f"slice_epoch_fused_{self.key(group, engine, ring)}"

    def library(self, group: int, engine: str = "cuda", ring: bool = False):
        from ..ops import fused_like
        from ..utils import nvcc

        return nvcc.load(self.library_name(group), [fused_like.SOURCE],
                         header=self.source(group))


def _smoke():
    """``chip_smoke`` of the repository's root (its data runs and helpers)."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import chip_smoke

    return chip_smoke


def ptxas(log: str) -> dict:
    """ptxas's registers, stack frame and spill bytes (the largest of the
    library's kernels)."""
    s = _smoke().ptxas_summary(log)
    return {"registers": s["max_registers"], "stack_bytes": s["max_stack_bytes"],
            "spill_bytes": s["max_spill_bytes"]}


def build(forms) -> dict:
    """Build every (form, G)'s library, one nvcc each, all started together:
    {(form, G): {"library", "nvcc_s", "ptxas", "source_lines"}}."""
    from ..ops import fused_like
    from ..utils import nvcc

    names = {key: p.library_name(key[1]) for key, p in forms.items()}
    nvcc.build_all({n: [fused_like.SOURCE] for n in names.values()},
                   headers={names[k]: p.source(k[1]) for k, p in forms.items()})
    return {key: {"library": n, "nvcc_s": nvcc.build_seconds.get(n, 0.0),
                  "ptxas": ptxas(nvcc.build_log.get(n, "")),
                  "source_lines": len(forms[key].source(key[1]).splitlines())}
            for key, n in names.items()}


def run_form(calc, low, cfg, args, G):
    """The fused route's epoch with ``low`` (a :class:`Patched`) as the
    calc's lowering, at G."""
    from ..ops import pallas_slice_v4

    kept = calc.__dict__.get("fused")
    calc.__dict__["fused"] = low
    try:
        return pallas_slice_v4.slice_epoch_fused(calc, cfg, KEY_WORDS, *args, group=G)
    finally:
        calc.__dict__["fused"] = kept


def _config(geo):
    from ..ops.slice_kernel import EpochConfig

    D = geo["D"]
    return EpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(geo["R"],))


def child(path: str, name: str, form: str, G: int) -> dict:
    """One (form, G)'s epoch on the inputs and plain records saved at
    ``path``: its mismatches against them, or its error."""
    from ..ops import fused_like

    dev = torch.device("cuda")
    saved = torch.load(path, map_location=dev)
    calc = _smoke().data_calc(name, dev)
    low = Patched(fused_like.lowering(calc), form)
    try:
        got = run_form(calc, low, _config(_smoke().DATA_RUNS[name]), saved["args"], G)
        torch.cuda.synchronize()
        return {"mismatches": {k: int((a != b).sum()) for k, a, b in
                               zip(("t", "logL", "nlike"), got, saved["want"])}}
    except Exception as e:  # noqa: BLE001 -- the study records the error
        return {"error": f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}"}


def _check(path: str, name: str, form: str, G: int) -> dict:
    """:func:`child` in a process of its own, with the first lines it printed."""
    proc = subprocess.run(
        [sys.executable, "-m", "polychordlite_tpu_torch.experiments.fused_data_times",
         "--child", path, name, form, str(G)], cwd=HERE, capture_output=True, text=True,
        timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("CHILD ")]
    rec = json.loads(lines[-1][6:]) if lines else {"error": f"exit {proc.returncode}: "
                                                            f"{proc.stderr[-400:]}"}
    rec["printed"] = [ln for ln in proc.stdout.splitlines() if not ln.startswith("CHILD ")][:8]
    return rec


def epoch_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def study(name: str, groups=None, forms=("route", "redundant"), reps: int = 3, jobs: int = 4,
          traced: bool = True) -> dict:
    """One model's record (module docstring)."""
    from ..ops import fused_like, pallas_slice_v4
    from ..ops.slice_kernel import slice_records_plain

    smoke = _smoke()
    dev = torch.device("cuda")
    geo = smoke.DATA_RUNS[name]
    calc = smoke.data_calc(name, dev)
    low = fused_like.lowering(calc)
    if not isinstance(low, fused_like.Lowered):
        raise AssertionError(f"{name}: the lowering refused it: {low.reason}")
    rule = pallas_slice_v4.choose_group(geo["B"], geo["D"], pallas_slice_v4._sm_count(dev))
    route = pallas_slice_v4.route_group(calc, geo["B"], geo["D"], dev)
    groups = sorted(set(groups or (rule, 16, 32)))
    variants = {(f, G): Patched(low, f) for f in forms for G in groups}
    built = build(variants)
    cfg, args = smoke.mid_run_inputs(calc, geo, dev, SEED)
    want = slice_records_plain(low.plain_logL, cfg, KEY_WORDS, *args)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        path = os.path.join(tmp, f"{name}.pt")
        torch.save({"args": list(args), "want": list(want)}, path)
        with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
            checks = dict(zip(variants, pool.map(lambda k: _check(path, name, *k), variants)))
    good = [k for k, c in checks.items()
            if "mismatches" in c and not any(c["mismatches"].values())]
    ms = {k: [] for k in good}
    for turn in (good, good[::-1]):
        for key in turn:
            ms[key].append(epoch_ms(lambda key=key: run_form(calc, variants[key], cfg, args,
                                                             key[1]), reps))
    tag = "/".join
    rec = {"model": name, **{k: geo[k] for k in ("B", "R", "D")}, "valid_lanes": geo["B_valid"],
           "rule_group": rule, "route_group": route, "evals": int(want[2].sum()),
           "checks": {tag(map(str, k)): v for k, v in checks.items()},
           "ms": {tag(map(str, k)): min(v) for k, v in ms.items()},
           "ms_turns": {tag(map(str, k)): v for k, v in ms.items()},
           "loops": [(lp.n_rows, len(lp.body)) for lp in low.loops],
           "ops_per_probe": low.ops_per_probe(),
           "built": {tag(map(str, k)): v for k, v in built.items()}}
    rec["bound_ms"], rec["bound_by"] = smoke.fused_bound(low, geo["B"], geo["R"], geo["D"],
                                                         rec["evals"])
    if traced:
        rec["traced_ms"] = epoch_ms(lambda: pallas_slice_v4.slice_epoch_traced(
            calc, cfg, KEY_WORDS, *args), max(1, reps // 2))
        rec["fused_vs_traced"] = smoke.decisions_against(want, pallas_slice_v4.slice_epoch_traced(
            calc, cfg, KEY_WORDS, *args))
    return rec


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--groups", type=int, nargs="*", default=None)
    p.add_argument("--forms", nargs="*", default=["route", "redundant"])
    p.add_argument("--models", nargs="*", default=["fitting", "object_detection"])
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--no-traced", action="store_true")
    p.add_argument("--child", nargs=4, metavar=("PATH", "MODEL", "FORM", "G"),
                   help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fused_data_times needs a CUDA card")
    if a.child:
        path, name, form, G = a.child
        print("CHILD " + json.dumps(child(path, name, form, int(G))), flush=True)
        return []
    for form in a.forms:
        if any(part not in FORMS for part in form.split("+")):
            raise SystemExit(f"unknown form {form!r}; have {sorted(FORMS)}")
    out = []
    for name in a.models:
        rec = {**study(name, a.groups, a.forms, a.reps, a.jobs, not a.no_traced),
               "device": torch.cuda.get_device_name(0)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
