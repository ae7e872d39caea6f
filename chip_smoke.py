"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel libraries from ``polychordlite_tpu_torch/csrc``
(one ``nvcc`` each, started together; ptxas registers, stack and spills
reported, by G for the Gaussian kernels of B1, B3, B4, B5 and E2, and by
dimension bucket), checks each kernel against its plain torch version on
the card (B2 Gram-Schmidt, bitwise, at the bench and gaussian.ini shapes,
and its wide kernel at the bases a B = 512, R = 2 D epoch draws
at D = 40, 64, 128, at the 64-D run's (2, 64, 64, 256) and at
(5, 64, 64, 8192), each beside ``torch.linalg.qr``; B1 v4, B3 v5, B4 v3 and B5
v2 at every group size G of lanes per chain, at four geometries, B1, B3,
B4 and B5 also against their G = 1 forms, B3-B5 against B1, each G timed,
B3's resident warps by G read from the card; E1, the counted v4, in the
``lane_efficiency`` study), measures what B1's micro-step costs
(``measure_first``: E7's ``body20`` with an IEEE division and with the
hash, B1 at every G at the gaussian.ini, 4-D and 8-D zoo, bench and 4x
bench geometries, B3, B4 and B5 at every G at the zoo's, and the SASS of B1's
Gaussian instantiations from ``cuobjdump``), holds B1's route for a
likelihood evaluated in torch (``slice_step``: the kernel
``csrc/slice_step.cu`` replayed from a CUDA graph) bitwise against the
plain engine and B1 at gaussian.ini's shape, the bench and D = 40, with 1,
7 and 32 rounds per replay, times it beside both
and times its kernel's own share of a round (rounds whose calc is one copy
of a constant logL), holds B1's fused route (``slice_fused``: gaussian.ini's
likelihood written in torch, lowered by ``ops/fused_like.py`` into
``csrc/slice_epoch_fused.cu``) bitwise against its plain version at every G
at gaussian.ini's shape and the bench, counts and lists its decisions that
differ from the traced route's and B1's on the same inputs, holds the zoo's
own Gaussian lowered bitwise against B1, and times the three routes, holds
the kernel template's wide bucket (``slice_epoch_d128``: B1's functor, the
fused route with a per-point torch Gaussian, B4 and B5 at D = 40, 64 and
128, B = 512, R = 2 D, at each G the bucket has, bitwise their plain
versions and G = 32; the fused route also at the 64-D run's B = 256; ms,
registers, bounds, and the 32 bucket's B1 at the bench beside them), holds
the stream bucket above D = 128 (``slice_epoch_d512``: B1's functor on the
zoo Gaussian and random_gaussian, the fused route, the traced route, B4 and
B5 at D = 160, 256 and 512, B = 512, bitwise their plain versions at R = 4
and timed at R = 2 D; B1 also as a shard at lane0 = 256 and at the
bucket's bound, D = 19,370; the fused and traced routes also in float64 at
160), B2's long path past dim 128 (``gram_schmidt_d512``, blocked CGS2:
(2, dim, dim, 512) at dims 160 and 256, 160 in float64, the 160-D run's
bases and dim 512 on 16 chains bitwise, (2, 512, 512, 512) timed, each
beside ``torch.linalg.qr`` with its resident warps an SM and scratch
bytes) and the graded and host routes at D = 160
(``stream_routes_d160``), holds
the double kernels of ``precision='highest'`` (``f64_kernels``: B1's fused
route and the traced route at gaussian.ini's shape and the bench, the
traced route also at the 40-D run's (B 128, R 80, D 40), B2 narrow at the
first two and wide at (2, 64, 64, 512) and the 40-D run's (2, 40, 40, 128),
each bitwise its float64 plain version and timed beside its float32 twin
and, for B2, float64 ``torch.linalg.qr``), holds the graded route
(``graded_step``: ``csrc/slice_step.cu`` with its repeat barrier, the slow
part of a GradedLikelihood cached across fast-grade repeats, at B = 8,192,
D = 20, grade_dims (6, 14), num_repeats (8, 32), in float32 and float64,
and at run_graded's chains, B = 256, all valid, in float32) bitwise
against its plain version, the traced route on the monolithic form and the
plain engine, with the rows slow_fn evaluated, the epoch record's
included, against the monolithic route's, and B2 at the dims speed grades
give it (1, 2, 14, 20, and run_graded's (3, 14, 14, 256) and (1, 20, 20,
256)), holds the host route (``host_route``: ``csrc/slice_step.cu``
launched round by round, a numpy Gaussian called on the host between two
launches on the pending probes only) over two epochs at gaussian.ini's
chains in float32 and float64, and at run_callback's and capi_cc's batches,
against its plain version, the traced route on the likelihood's torch form
and (float32) the plain engine on the same model, with the epoch records
from the probes it kept against the re-evaluated ones, the user's calls
against nlike and the host time of a round by part, and B2 at those runs'
bases, holds the fused route and the traced route at the data-driven
inis' batches (``data_driven_step``: fitting at B 512, object_detection at
B 128, the inis' block priors; the functors' data loops, their rows split
over a chain's lanes at the route's G, bitwise their plain versions, timed
beside the traced route; B2 at object_detection's (5, 12, 12, 128)),
holds
the chain batch over shards (``sharded_epoch``: the runner of every engine
and route, the plain engine, B1's functor, fused and traced routes, the
graded route, B3, B4 and B5, over [cuda] * 2 and [cuda] * 4 at
gaussian.ini's chains and the bench's, the graded route at run_graded's,
bitwise its one-shard epoch at the same logical B; each kernel at a shard's
``lane0`` bitwise its plain version; B1 at the bench at lane0 0 and 8,192),
then drives the port's paths and checks what comes out and which kernels ran
(each path with every launch count set to 0 just before it):

* ``run_gaussian_ini``: ``run()`` on the 20-D Gaussian of
  ``ini/gaussian.ini`` (nlive 500, num_repeats 40, no clustering), engine
  ``"cuda"`` (the v4 kernel, at the G that ``choose_group`` picks, which
  must be > 1) and the Gram-Schmidt kernel;
* ``run_two_process``: gaussian.ini's settings at batch_size 512 through
  ``run()`` in two processes on this card, joined over gloo with the
  environment torchrun gives them, each waited for with its own timeout:
  both ranks' logZ, logZerr, ndead and nlike those of one process at the
  same batch (one epoch at a time, as a sharded run dispatches), rank 0's
  ``.stats`` and ``.txt`` byte for byte that process's, no file from rank
  1, dead/s of both;
* ``run_async``: gaussian.ini's settings through ``run(engine="cuda",
  synchronous=False)``: the bias warning, B1 and B2 only, no chain, within
  3 sigma of 0; dead/s, ``device_frac`` and the epoch timers beside the
  synchronous run one epoch at a time and ``run_gaussian_ini``'s chained
  run;
* ``run_gaussian_shells_ini``: ``python3 -m polychordlite_tpu_torch`` on a
  copy of ``ini/gaussian_shells.ini`` (2-D, two shells, clustering, nlive
  500, num_repeats 10) with only ``base_dir`` and a fixed ``seed`` added;
  the fresh process starts with every launch count at 0 and writes the
  launches of its run into its ``.metrics.jsonl``;
* ``run_gaussian_shells_v5``: the same settings through
  ``run(..., engine="cuda5")`` (the speculative-packet kernel, at the G
  that ``choose_packet_group`` picks, which must be > 1), which must give
  the CLI run's result bit for bit;
* ``run_zoo_inis``: the nine other analytic inis of ``ini/`` at their
  shipped settings (``base_dir`` and ``seed`` added) through
  ``inidriver.run_ini`` on the default device, and ``ini/eggbox.ini``
  through ``python3 -m polychordlite_tpu_torch``; each logZ within 3 sigma
  of its oracle (:data:`ZOO_ORACLES`);
* ``run_himmelblau_ab``: ``ini/himmelblau.ini`` through
  ``run(engine="cuda3")`` (B4, at a G > 1), bitwise the ``run_zoo_inis``
  run, and ``run(engine="cuda2")`` (B5, at a G > 1), within 3 sigma of
  -log 100;
* ``run_grades_ini``: ``python3 -m polychordlite_tpu_torch`` on a copy of
  ``ini/gaussian.ini`` whose prior lines give p1-p6 speed 1 and p7-p20
  speed 2, with ``grade_frac = 8 32`` (literal repeats): B1's functor
  route and B2 at dims 20 and 14, within 3 sigma of 0, two nlike counts
  in the ``.stats`` file, the fast one larger;
* ``run_graded``: a 20-D GradedLikelihood (the fixed-point loop of
  tests/test_graded.py on 6 slow coordinates, 14 fast) with gaussian.ini's
  settings at nlive 250 and grade_frac [8, 32] through ``run()``: engine ``"scan"``,
  the graded route and B2 only, no chain, at the batch graded_step held,
  within 3 sigma of 0, and the share of the rows evaluated (probes and the
  epoch records' babies) that ran slow_fn; the same likelihood as one
  callable on the fused route, the two within 3 combined sigma; and
  ``time_speeds`` on the graded calc (the full calc more than twice the
  fast part's time);
* ``run_callback``: the 4-D quickstart written with numpy (a host
  callback; nlive 200) through ``run()`` with the default engine: engine
  ``"scan"`` on the host route and B2 only, within 3 sigma of -4 log 2,
  its dead/s, ``device_frac``, user calls and the host time of a round by
  part;
* ``capi_cc``: ``examples/cc/gaussian_cc.cpp``, unchanged, built against
  the port's C++ layer (``polychordlite_tpu_torch/cabi``) as a program that
  embeds the interpreter (or, where this Python has no shared libpython,
  loaded into this process with ``ctypes.PyDLL``; the mode is printed) at
  its own settings (20-D, nlive 200, num_repeats 40, seed 17): the host
  route and B2, within 3 sigma of 0;
* ``run_fitting_ini`` and ``run_object_detection_ini``: ``python3 -m
  polychordlite_tpu_torch`` on copies of ``ini/fitting.ini`` and
  ``ini/object_detection.ini`` (``base_dir`` and a seed added, the data
  from the repository's ``data/``): the fused route (the functors' data
  loops, the libraries data_driven_step built) and B2, at the batches
  data_driven_step held, each within 3 combined sigma of the JAX package's
  run of the same ini on the CPU (:data:`DATA_ORACLES`);

* ``run_gaussian_ini_torch``: gaussian.ini's settings through ``run()`` with
  its likelihood written as a plain batched torch function (no device
  form): the fused route ``csrc/slice_epoch_fused.cu`` and B2, within 3
  sigma of 0, its dead/s beside the functor run's;
* ``run_quickstart_torch``: the reference quickstart written per point in
  torch (4-D, sigma 0.1, ``UniformPrior(-1, 1)``, one derived r^2, nlive
  200, clustering on) through ``run()``: the fused route and B2, within 3
  sigma of -4 log 2, the r^2 column in the chains;
* ``run_gaussian_prior``: a 5-D Gaussian likelihood N(0, 0.5^2) under a
  ``GaussianPrior(1, 1)`` (its erfinv lowered into the kernel), within 3
  sigma of its closed-form evidence;
* ``run_traced_route``: a 4-D Gaussian written with
  ``torch.linalg.vector_norm``, which the lowering refuses (the op is
  outside its table): the traced route ``csrc/slice_step.cu`` and B2, the
  refusal as the metrics' ``route_reason``, within 3 sigma of 0;
* ``run_gaussian_d64``: gaussian.ini's settings at D = 64 (num_repeats
  128) at nlive 250, the likelihood written per point in torch: the fused
  route in the wide bucket (B1's launches by bucket and G in the metrics)
  and B2's wide kernel, within 3 sigma of 0;
* ``run_gaussian_d160``: a per-point torch Gaussian at D = 160 (sigma 0.2
  at 0.5, uniform on [0, 1]^160), nlive 200, num_repeats 5 D, engine
  "auto": the fused route in the stream bucket and B2's long kernel, within
  3 sigma of 160 log erf(2.5 / sqrt 2);
* ``run_highest``: tests/test_precision.py's big likelihood (1e7 plus a
  normalised Gaussian, sigma 0.1, UniformPrior(-1, 1)) at gaussian.ini's
  width (D = 20, nlive 500, num_repeats 40) through
  ``run(precision='highest')``: the fused route and B2 in double only,
  within 3 sigma of 1e7 - 20 log 2; the same model at the default
  precision raises C13's error before its first epoch;
* ``run_traced_highest_d40``: a 40-D Gaussian written with
  ``torch.linalg.vector_norm`` at ``precision='highest'`` (nlive 100,
  num_repeats 80): the traced route and B2's wide kernel in
  double, within 3 sigma of 0;
* ``run_maximise_nlives``: gaussian.ini's likelihood per point with
  ``maximise=True`` and ``nlives={-30: 250}``: ``<root>.maximum`` at the
  peak, nlive 500 then 250 in the metrics, no chain dispatched;
  (each fused run's libraries are built before its clock starts, as a
  second run of the same model finds them);

then the structure-cost studies of ``polychordlite_tpu_torch.experiments``,
each kernel first held against its plain version on the card:

* ``lockstep_waste``: E3, the counted v2 kernel (bitwise B5 and its plain
  version at three geometries), and its study at the bench geometry;
* ``v3_iters``: E2, v3's grid steps as a cooperative kernel with their body
  counts, at every G whose grid is co-resident (bitwise B4 at the same G,
  B1 and its plain version; the other G refused; the skeleton one body per
  step; the occupancy the launch reads), its study (real at B4's G and at
  G = 1, skeleton, beside B4 at both: the price per step of v3's steps),
  and the numpy simulation's projected lane efficiencies beside E1's and
  E3's;
* ``grid_overhead``: E6, the grid-step skeleton, variants A-F and B one
  launch per step;
* ``while_cost``: E7, the loop-body cost of every body, beside B1's time
  per micro-step;
* ``proto_epoch``: E4, the whole-epoch prototype (bitwise its plain version
  at B=1024/R=8 and at its full size, B=8192/R=100), its study, and its
  time per lane iteration beside B1's per micro-step in the same call;
* ``proto_repeat``: E5, the one-repeat prototype (bitwise its plain version
  at nb=2 and nb=8 blocks of 1,024 chains, and over a chain of launches),
  its time per launch from a captured CUDA graph of 20 launches back to
  back, and its study (one repeat, then 100 launches back to back).

The ring engine (``engine="ring"``): ``ring_epoch`` holds B1's ring
instantiations (``RingPolicy``: the functor kernel on the zoo Gaussian,
the fused route on gaussian.ini's likelihood in torch) and the traced
route under the ring's budget (the vector_norm Gaussian) bitwise their
plain versions, overflow flags included, at gaussian.ini's shape and the
bench (ring_factor 12, timed beside the same route at its own budget) and
at gaussian.ini's shape at ring_factor 2, where lanes overflow and the
runner's re-run is the ``"cuda"`` epoch bit for bit; ``run_ring`` runs
gaussian.ini through ``run(engine="ring")`` on the functor kernel (cut
at 12,000 dead points), and
its torch and vector_norm forms (nlive 100) on the fused and traced
routes, each gated at 3 sigma, with its re-runs, dead/s and device_frac;
``run_quickstart_example`` runs the port's ``examples/quickstart.py`` in a
process of its own.

The forced engines above D = 32 and on torch models:
``slice_epoch_v5_buckets`` holds B3 in the wide bucket (D = 64, B = 512, R
= 128, slice_epoch_d128's inputs) and the stream bucket (D = 160, checked
at R = 4 and timed at R = 320) at the buckets' one G bitwise its plain
version and B1, timed beside B1; ``slice_forced_fused`` holds the forced
engines' fused routes (B3, B4, B5 with gaussian.ini's likelihood in torch
lowered into them) at every G at gaussian.ini's shape and the bench
bitwise their plain versions (``Lowered.plain_logL``), B3 and B4 also B1's
fused route, timed beside it; ``run_stream_routes_d160`` also runs the zoo
Gaussian on ``engine="cuda5"`` at D = 160 and 64, each run's files byte
for byte those of ``engine="cuda"``; ``run_forced_torch`` runs a per-point
torch Gaussian (D = 20, nlive 100) on ``"cuda"`` and each forced engine,
whose route must be its fused route: ``"cuda5"`` and ``"cuda3"`` write
the ``"cuda"`` run's files byte for byte, ``"cuda2"`` lands within 3 sigma.

The plain versions of the heaviest checks (B2's long path at every
``GS_LONG`` geometry but (2, 512, 512, 512), split by chains, the wide
bucket's four kernels, the 160-D run's fused geometry,
the two phases above) run on the host's CPU in ``PLAIN_WORKERS`` worker
processes (``plain_job``) while the card runs the phases that follow; the
phase ``plain_checks``, behind the kernel timings and beside the 160-D
run, compares them with the kernels' outputs bit for bit (their
``plain_ms`` is then CPU time, ``plain_device`` "cpu").

The runs through the CLI, the C++ example, the 64-D and the 160-D runs and
the quickstart example go in processes of their own, the 160-D run started before the main path's
runs (section 7), the others after ``run_async``, one after another (the
64-D run beside them), and run behind the in-process runs; each phase
waits for its own process and checks what it wrote.  Their dead/s, and
the in-process runs' from section 7 on, are taken while they share the
card and the host; every kernel timing comes before they start or after
the last has ended.

Each phase prints one JSON line, then one line gives every phase's
seconds; the line before the last lists the
kernels with their times, bounds (from this run's shapes and step counts)
and launches on the paths, and the last line is ``{"ok": true, "device": ...}``.  Any failed
phase exits non-zero without that line.  Without a CUDA device, or without
the package beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import types
import warnings
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out")
SEED = 20250101
BENCH = dict(B=8192, R=100, D=20)        # the slice bench geometry
BENCH_X4 = dict(B=32768, R=100, D=20)    # ... at four times the chains
SMALL = dict(B=1024, R=8, D=20)
INI = dict(nDims=20, nDerived=2, nlive=500, num_repeats=40)  # ini/gaussian.ini
# what run() gives the kernel on ini/gaussian.ini: B = nlive rounded to 8
# logical lanes, padded to 512 physical lanes (parallel/mesh.py)
RUN = dict(B=512, R=40, D=20, B_valid=504)
# ... and on ini/gaussian_shells.ini (nlive 500, num_repeats 10, 2-D)
SHELLS = dict(B=512, R=10, D=2, B_valid=504)
# ... and on the zoo's 4-D inis (half_gaussian, pyramidal, twin_gaussian:
# num_repeats 20) and its 8-D random_gaussian.ini (num_repeats 40)
ZOO_D4 = dict(B=512, R=20, D=4, B_valid=504)
ZOO_D8 = dict(B=512, R=40, D=8, B_valid=504)
# ... and a 40-D model, in the kernels' wide bucket (32 < D <= 128), on the
# traced route
TRACED_D40 = dict(B=512, R=40, D=40, B_valid=504)
# the wide bucket's checked dimensions (B = 512, R = 2 D, as gaussian.ini's
# ratio), and the 64-D Gaussian run (gaussian.ini's settings at D = 64)
WIDE_DIMS = (40, 64, 128)
# (nlive 250, half gaussian.ini's, to keep the script's time), and what
# run() gives the kernels there: B = 256 lanes, all valid; B2 two bases
D64 = dict(nDims=64, nlive=250, num_repeats=128)
D64_RUN = dict(B=256, R=128, D=64, B_valid=256)
# the stream bucket's checked dimensions (D > 128: B = 512, bitwise at R =
# 4, each kernel also timed at R = 2 D; the double routes at D = 160), and
# the 160-D Gaussian run: a per-point torch Gaussian of sigma 0.2 at 0.5 on
# [0, 1]^160 (logZ = 160 log erf(2.5 / sqrt 2) = -1.9995), nlive 200,
# num_repeats 5 D, the default of the JAX package's run()
# (polychordlite_tpu/settings.py:114): at 2 D the sampler itself lands 7-10
# sigma high at this D, the JAX package on the CPU as the port on the card
# and on the CPU (PERF.md, section 7); what run() gives its kernels: B =
# 256 lanes, 200 valid, B2 five bases of 160
STREAM_DIMS = (160, 256, 512)
STREAM_B = 512
D160 = dict(nDims=160, nlive=200, num_repeats=800, sigma=0.2)
D160_RUN = dict(B=256, R=800, D=160, B_valid=200)
D160_LOGZ = 160 * math.log(math.erf(2.5 / math.sqrt(2.0)))
# B2 above dim 128: (2, dim, dim, 512) at dims 160 and 256 in float32 and 160
# in float64, and the 160-D run's (5, 160, 160, 256), bitwise its plain
# version on the host's CPU; at dim 512 the time at the chains GS_D512_B, and
# bitwise on the few chains of GS_D512_FEW: (tag, NB, dim, B, dtype)
GS_D512_B = 512
GS_LONG = (("d160_float32", 2, 160, 512, "float32"), ("d256_float32", 2, 256, 512, "float32"),
           ("d160_float64", 2, 160, 512, "float64"), ("d160_run", 5, 160, 256, "float32"),
           ("d512_float32", 2, 512, GS_D512_B, "float32"))
GS_D512_FEW = (1, 512, 16, "float32")
# the 40-D run at precision='highest' (traced route and B2's wide kernel in
# double; nlive 100, num_repeats 2 D), and its kernels' geometry: 104 valid
# lanes of 128, B2 two bases
D40_HIGHEST = dict(nDims=40, nlive=100, num_repeats=80)
D40_RUN = dict(B=128, R=80, D=40, B_valid=104)
# tests/test_precision.py's big likelihood, run at gaussian.ini's width
BIG = dict(offset=1.0e7, sigma=0.1)
# speed grades at gaussian.ini's settings but nlive 250 (half the ini's, to
# keep the script's time): p1-p6 slow, p7-p20 fast, literal repeats 8 and
# 32 (40 in all, the ini's num_repeats); the graded route's kernel check at
# the bench's chains
GRADED = dict(nDims=20, nlive=250, grade_dims=[6, 14], grade_frac=[8, 32])
GRADED_STEP = dict(B=8192, B_valid=8192)
# ... and what run_graded gives the kernels: B = 256 lanes, all valid; B2
# one basis at dim 20 and three at dim 14
GRADED_RUN = dict(B=256, B_valid=256)
# the host route (a host-callback likelihood, a numpy Gaussian) is held at
# gaussian.ini's chains (RUN) and at what run_callback (the 4-D quickstart
# in numpy, nlive 200, num_repeats 20: B = 256 lanes, 200 valid) and
# capi_cc (examples/cc/gaussian_cc.cpp: 20-D, nlive 200, num_repeats 40)
# give it; B2 at their bases, (5, 4, 4, 256) and (2, 20, 20, 256)
QUICK_RUN = dict(B=256, R=20, D=4, B_valid=200)
# run_forced_torch's batch: nlive 100 in one shard's 128 lanes
FORCED_RUN_B = 128
CC_RUN = dict(B=256, R=40, D=20, B_valid=200)
# the data-driven inis at their own settings, on the fused route (one data
# loop a model): ini/fitting.ini (20-D, nlive 500, num_repeats 40: B = 512,
# 504 valid; B2 at gaussian.ini's (2, 20, 20, 512)) and
# ini/object_detection.ini (12-D, nlive 50, num_repeats 50: B = 128, 56
# valid; B2 at (5, 12, 12, 128)); the study experiments/fused_data_times.py
# reads these
DATA_RUNS = {"fitting": dict(B=512, R=40, D=20, B_valid=504),
             "object_detection": dict(B=128, R=50, D=12, B_valid=56)}
#: their oracles, the JAX package's runs of the same inis on the CPU (JAX
#: 0.9.0, commit 428c4d3, base_dir changed and seed 7 added): (logZ, sigma,
#: seed, commit, how).  object_detection at its own settings; fitting at
#: precision='highest' with its data and model built under jax.enable_x64,
#: because the JAX package's float32 run of fitting.ini climbs on rounding
#: spikes of its likelihood without end (ROADMAP C20; the port evaluates
#: fitting in float64)
DATA_ORACLES = {
    "fitting": (-132.28871930726797, 0.14527662021739973, 7, "428c4d3",
                "JAX package, CPU, precision='highest'"),
    "object_detection": (-112.916916, 0.507222, 7, "428c4d3", "JAX package, CPU, its CLI"),
}
SHELLS_LOGZ = -math.log(60.0)  # normalised shells over the [-6,6] x [-2.5,2.5] box
LIBRARIES = {
    "gram_schmidt": ["gram_schmidt.cu"],
    "slice_epoch": ["slice_epoch.cu"],
    "slice_epoch_ring": ["slice_epoch.cu"],  # with SLICE_EPOCH_RING (nvcc.DEFINES)
    "slice_epoch_v5": ["slice_epoch_v5.cu"],
    "slice_epoch_v5_wide": ["slice_epoch_v5.cu"],  # with SLICE_EPOCH_V5_WIDE (nvcc.DEFINES)
    "slice_epoch_v3": ["slice_epoch_v3.cu"],
    "slice_epoch_v2": ["slice_epoch_v2.cu"],
    "slice_epoch_v3_instr": ["slice_epoch_v3_instr.cu"],
    "probes": ["probes.cu"],
    "prototypes": ["prototypes.cu"],
    "slice_step": ["slice_step.cu"],
}
#: the ring engine's B1 library, built behind the first phases
RING_LIBRARY = "slice_epoch_ring"
#: run_ring's gaussian.ini cut: 12,000 of the ~23,700 dead points of the
#: whole run, past the posterior's bulk (log X ~ -17.7 at ndead ~8,850), so
#: the estimate (live points included) holds logZ = 0 within its error; it
#: halves the phase (per-epoch dispatch, no chains)
RING_MAX_NDEAD = 12000
#: the analytic inis' evidence oracles: (logZ, its sigma or None for an exact
#: value, where it comes from).  The JAX values are the JAX package's CPU runs
#: at the same settings and seed, from ``scripts/zoo_reference_logz.py``
#: (JAX 0.9.0); each run here must land within 3 combined sigma.  The same
#: script checked the four analytic values: gaussian_shell -4.9942 +- 0.0829,
#: himmelblau -4.5747 +- 0.0956, half_gaussian +0.0755 +- 0.0925, pyramidal
#: -0.1074 +- 0.0870.
ZOO_ORACLES = {
    "gaussian_shell": (-math.log(144.0), None, "normalised shell in a 12 x 12 box"),
    "himmelblau": (-math.log(100.0), None, "normalised, 10 x 10 box"),
    "half_gaussian": (0.0, None, "normalised"),
    "pyramidal": (0.0, None, "normalised"),
    "eggbox": (-4.068568333227493, 0.06926281283625953, "JAX package, CPU"),
    "rastrigin": (-4.601151046710499, 0.11321131723081969, "JAX package, CPU"),
    "rosenbrock": (-5.0304313247996255, 0.10651320969831203, "JAX package, CPU"),
    "twin_gaussian": (-2.236031473448633, 0.10162701830093217, "JAX package, CPU"),
    "random_gaussian": (-0.15459852089235782, 0.08891872190328032, "JAX package, CPU"),
}
# H100 SXM peaks (NVIDIA datasheet): HBM bytes/s, float32 and float64 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if os.path.isdir(OUT):  # the whole record, beyond the end of the output
        with open(os.path.join(OUT, "chip_smoke.jsonl"), "a") as f:
            f.write(line + "\n")


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn()`` from a captured CUDA graph of
    ``launches`` calls back to back, replayed ``reps`` times: no host work
    between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the default stream, as capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * launches)


def sass_report(so: str, keep: str):
    """From ``cuobjdump`` on the library ``so``: per kernel of B1's Gaussian
    (by G, and the counted form), the SASS ``CALL`` instructions, the
    instructions in all and the registers, stack and local bytes; the SASS
    of those kernels goes to ``keep``.  None when there is no cuobjdump."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          timeout=600).stdout
    usage = subprocess.run([tool, "-res-usage", so], capture_output=True, text=True,
                           timeout=600).stdout
    res = {m[0]: {"registers": int(m[1]), "stack": int(m[2]), "local": int(m[3])}
           for m in re.findall(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)",
                               usage)}
    out, kept = {}, []
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        m = re.search(r"slice_epoch_kernel.*12GaussianLikeILi32EELi(\d+)ELb([01])E", name)
        if not m:
            continue
        tag = f"G={m[1]}" + (" counted" if m[2] == "1" else "")
        out[tag] = {"calls": len(re.findall(r"\bCALL\b", block)),
                    "instructions": len(re.findall(r"/\*[0-9a-f]{4,}\*/", block)),
                    **res.get(name, {})}
        kept.append(f"==== {tag} {name}\n{block}")
    with open(keep, "w") as f:
        f.write("\n".join(kept))
    return out


def qr_ms(g) -> float:
    """The yardstick of B2 at the bases ``g`` (nb, dim, dim, B): one
    batched ``torch.linalg.qr`` of the same bases, (nb B, dim, dim) with the
    vectors as columns, after a warm-up; the port never calls it."""
    import torch

    nb, dim, _, B = g.shape
    mats = g.permute(0, 3, 1, 2).reshape(-1, dim, dim).contiguous()
    return cuda_ms(lambda: torch.linalg.qr(mats), 1)


def cuda_once(fn):
    """(result, device ms) of one call of ``fn()``, from CUDA events."""
    import torch

    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def ini_copy(base: str, name: str) -> str:
    """ini/<name>.ini with base_dir set to ``base`` and a fixed seed added,
    nothing else changed."""
    with open(os.path.join(HERE, "ini", f"{name}.ini")) as f:
        src = f.read()
    if "base_dir = chains" not in src:
        raise AssertionError(f"ini/{name}.ini has no 'base_dir = chains' line")
    src = src.replace("base_dir = chains", f"base_dir = {base}\nseed = {SEED}")
    path = os.path.join(base, f"{name}.ini")
    with open(path, "w") as f:
        f.write(src)
    return path


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the peak of their type (float32 by default; the
    double kernels pass F64_FLOPS_PER_S)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slice_epoch_bytes(B: int, R: int, D: int, cube: bool = False, counted: bool = False) -> int:
    """Bytes a slice-epoch kernel must move: x0 (D,B), n-hat (R,D,B), w
    (R,B), bound and valid (B,) read once; t, logL, nlike (R,B) written once
    (and v2's cube (R,D,B), or the counted kernel's B + B/32 counters)."""
    n = D * B + R * D * B + R * B + 2 * B + 3 * R * B
    if cube:
        n += R * D * B
    if counted:
        n += B + -(-B // 32)
    return 4 * n


def gaussian_probe_flops(D: int) -> int:
    """float32 operations of one probe of the Gaussian functor: the probe
    x0 + t n-hat and the prior's affine map (4 per coordinate), (th - mu) /
    sigma and the chi-square add (4 per coordinate), logL and the chord
    position t (about 7) — a division counted as one operation."""
    return 8 * D + 7


def data_calc(name: str, device):
    """The calc of ``ini/<name>.ini`` as ``inidriver.run_ini`` builds it: its
    BlockPrior and the likelihood on the repository's data."""
    from polychordlite_tpu_torch.models import get_likelihood
    from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
    from polychordlite_tpu_torch.priors import BlockPrior
    from polychordlite_tpu_torch.utils.inifile import read_ini

    D = DATA_RUNS[name]["D"]
    _, blocks, *_ = read_ini(os.path.join(HERE, "ini", f"{name}.ini"))
    return make_batched_calculator(
        BlockPrior(blocks, D), get_likelihood(name, D, data_dir=os.path.join(HERE, "data")),
        D, 0, device=device)


def mid_run_inputs(calc, geo: dict, device, seed: int):
    """(cfg, (x0, bound, valid, n-hat, w)) of one epoch mid-run at ``geo``'s
    B, R, D: the best B_valid of 4 B_valid prior draws as the live set,
    each lane's seed a live point and its bound the smaller logL of it and
    another, the live set's Cholesky for the directions; lanes past
    ``B_valid`` invalid."""
    import torch

    from polychordlite_tpu_torch.ops.directions import make_directions
    from polychordlite_tpu_torch.ops.slice_kernel import EpochConfig

    B, R, D, nlive = geo["B"], geo["R"], geo["D"], geo["B_valid"]
    gen = torch.Generator(device).manual_seed(seed)
    draws = torch.rand((4 * nlive, D), generator=gen, device=device)
    live = draws[torch.topk(calc(draws)[2], nlive).indices]
    live_logL = calc(live)[2]
    pick = torch.randint(0, nlive, (B,), generator=gen, device=device)
    other = torch.randint(0, nlive, (B,), generator=gen, device=device)
    x0 = live[pick]
    bnd = torch.minimum(live_logL[pick], live_logL[other])
    valid = torch.arange(B, device=device) < nlive
    chol = torch.linalg.cholesky(torch.cov(live.T)
                                 + 1e-9 * torch.eye(D, device=device)).expand(B, D, D)
    nh, w, _ = make_directions(chol, grade_dims=(D,), num_repeats=(R,), n_dims=D,
                               generator=gen)
    return EpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(R,)), (x0, bnd, valid,
                                                                               nh, w)


def fused_ops_ms(low, evals: int) -> float:
    """The least ms of ``evals`` probes' operations of a lowered model
    (``Lowered.ops_per_probe``): the float64 ones at the float64 peak, the
    rest at the float32 peak."""
    ops = low.ops_per_probe()
    f64 = ops.get("f64", 0)
    return evals * ((sum(ops.values()) - f64) / F32_FLOPS_PER_S + f64 / F64_FLOPS_PER_S) * 1e3


def fused_bound(low, B: int, R: int, D: int, evals: int):
    """(bound_ms, bound_by) of a fused epoch: the bytes of B1's epoch
    (:func:`slice_epoch_bytes`) and the constant buffer, once; or the
    operations of ``evals`` probes (:func:`fused_ops_ms`)."""
    consts = low.device_consts("cpu")
    t_bytes = (slice_epoch_bytes(B, R, D) + consts.numel() * consts.element_size()) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = fused_ops_ms(low, evals)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decisions_against(got, other) -> dict:
    """Where two routes' epochs (t, logL, nlike) on the same inputs decide
    differently (t or nlike differ; logL may differ in its last bits where
    their sums round in other orders): the count of such records, the
    lanes, and where they agree the largest relative difference of logL."""
    import torch

    diff = (got[0] != other[0]) | (got[2] != other[2])
    lanes = torch.nonzero(diff.any(1)).flatten().tolist()
    same = ~diff.any(1)
    rel = ((got[1][same].double() - other[1][same].double()).abs()
           / other[1][same].double().abs().clamp_min(1e-30))
    return {"t_or_nlike_mismatches": int(diff.sum()), "lanes": len(lanes),
            "listed": lanes[:50],
            "max_rel_logL_where_agreeing": float(rel.max()) if rel.numel() else 0.0}


def gram_schmidt_flops(NB: int, D: int, B: int) -> int:
    """float32 operations of CGS2 on NB*B bases of D vectors: two passes of
    k dot products and k updates (2D each) for vector k, and a norm and a
    scale per vector (3D + 1)."""
    per = 2 * sum(4 * D * k for k in range(D)) + D * (3 * D + 1)
    return NB * B * per


def ptxas_summary(log: str):
    """Kernels, and the largest registers, stack frame and spill bytes that
    ptxas reports for any of them."""
    import re

    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    stack = [int(m) for m in re.findall(r"(\d+) bytes stack frame", log)]
    spill = [int(a) + int(b) for a, b in
             re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    return {"kernels": len(regs), "max_registers": max(regs, default=None),
            "max_stack_bytes": max(stack, default=None),
            "max_spill_bytes": max(spill, default=None)}


def ptxas_kernels(log: str, pattern: str):
    """Registers, stack frame and spill bytes that ptxas reports for each
    kernel whose mangled name matches ``pattern``, keyed by the pattern's
    groups joined with ","."""
    import re

    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m[1]
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m[1]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props == entry and entry:
            k = re.search(pattern, entry)
            if k:
                out.setdefault(",".join(k.groups()), {}).update(
                    stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            k = re.search(pattern, entry)
            if k:
                out.setdefault(",".join(k.groups()), {})["registers"] = int(m[1])
    return out


def written_files(base: str) -> dict:
    """The bytes of every file a run wrote under ``base`` but its metrics
    (which hold its times), by path relative to ``base``."""
    out = {}
    for dirpath, _, names in os.walk(base):
        for n in names:
            if not n.endswith(".metrics.jsonl"):
                path = os.path.join(dirpath, n)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, base)] = f.read()
    return out


def read_metrics(base: str, root: str):
    with open(os.path.join(base, f"{root}.metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f.read().splitlines()]


def shell_evidences(out, base: str, root: str):
    """The local evidences of the retired clusters, grouped by the shell
    (x_1 < 0 or > 0) that each cluster's posterior mass sits on.  Cluster
    files are ranked by local evidence (utils/io.py)."""
    import numpy as np

    lz = np.asarray(out.logZs)
    sides = {-1: [], 1: []}
    for rank, c in enumerate(np.argsort(-lz, kind="stable")):
        path = os.path.join(base, "clusters", f"{root}_{rank + 1}.txt")
        if not (math.isfinite(lz[c]) and lz[c] > -1e29 and os.path.getsize(path)):
            continue
        post = np.loadtxt(path, ndmin=2)
        x = float((post[:, 0] * post[:, 2]).sum() / post[:, 0].sum())
        sides[1 if x > 0 else -1].append(float(lz[c]))
    return lz[np.isfinite(lz) & (lz > -1e29)], sides


def gaussian_batch_run(base: str, cfg: dict) -> dict:
    """gaussian.ini's likelihood through run() at ``cfg``'s settings (no
    clustering, precision_criterion 0.001) into ``base``, in this process
    (a rank of a process group where torchrun's environment names one): the
    administrator's result, which every rank holds (logZ, logZerr, ndead,
    nlike), this process's device_frac (the gather across processes left
    out) and epoch timers, and the wall seconds inside run()."""
    import polychordlite_tpu_torch as pt
    from polychordlite_tpu_torch.models import gaussian

    run_module = sys.modules["polychordlite_tpu_torch.run"]  # the package's run() hides it
    kept, sampler = {}, run_module.nested_sampling
    run_module.nested_sampling = lambda *a, **k: kept.setdefault("out", sampler(*a, **k))
    try:
        t0 = time.perf_counter()
        pt.run(gaussian(cfg["nDims"]), cfg["nDims"], nDerived=cfg["nDerived"],
               nlive=cfg["nlive"], num_repeats=cfg["num_repeats"], do_clustering=False,
               precision_criterion=0.001, read_resume=False, base_dir=base, seed=cfg["seed"],
               feedback=-1, batch_size=cfg["batch_size"], chain_epochs=cfg["chain_epochs"])
        wall = time.perf_counter() - t0
    finally:
        run_module.nested_sampling = sampler
    out = kept["out"]
    return {"logZ": out["logZ"], "logZerr": out["logZerr"], "ndead": out["ndead"],
            "nlike": out["nlike"], "wall_s": wall, "device_frac": out["metrics"]["device_frac"],
            "epoch_timers_s": out["metrics"]["epoch_timers"]}


def per_point_gaussian(theta):
    """gaussian.ini's likelihood as a user writes it per point in torch
    (sigma 0.1, mu 0.5, normalised), at the point's dimension."""
    import torch

    D = theta.shape[-1]
    return (-0.5 * torch.sum(((theta - 0.5) / 0.1) ** 2)
            - D * (math.log(0.1) + 0.5 * math.log(2 * math.pi)))


def d64_run(base: str) -> dict:
    """run_gaussian_d64's run() into ``base``, in this process: gaussian.ini's
    settings at D = 64 (D64; no clustering, precision_criterion 0.001), the
    likelihood per point in torch, warnings as errors (a replay divergence
    would warn); the wall seconds inside run()."""
    import polychordlite_tpu_torch as pt

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pt.run(per_point_gaussian, D64["nDims"], nlive=D64["nlive"],
               num_repeats=D64["num_repeats"], do_clustering=False, precision_criterion=0.001,
               read_resume=False, base_dir=base, seed=SEED, feedback=-1, device="cuda")
    return {"wall_s": time.perf_counter() - t0}


def d160_gaussian(theta):
    """The 160-D run's likelihood per point in torch: sigma 0.2 at 0.5,
    normalised over R^D."""
    import torch

    D, sigma = theta.shape[-1], D160["sigma"]
    return (-0.5 * torch.sum(((theta - 0.5) / sigma) ** 2)
            - D * (math.log(sigma) + 0.5 * math.log(2 * math.pi)))


def d160_run(base: str, nlive: int = D160["nlive"], num_repeats: int = D160["num_repeats"],
             seed: int = SEED, device: str = "cuda") -> dict:
    """run_gaussian_d160's run() into ``base``, in this process: D160 with
    engine "auto" (the default), no clustering, warnings as errors (a chain
    replay divergence would warn); the wall seconds inside run(), logZ, its
    error and its pull from D160_LOGZ.  The other arguments make it the
    study of how the evidence moves with num_repeats and nlive, on the card
    or on the CPU's plain engine, for example

        python -c "import chip_smoke as c; print(c.d160_run('d160_out', 200, 320, 7, 'cpu'))"
    """
    import polychordlite_tpu_torch as pt
    from polychordlite_tpu_torch.output import PolyChordOutput

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pt.run(d160_gaussian, D160["nDims"], nlive=nlive, num_repeats=num_repeats,
               do_clustering=False, read_resume=False, base_dir=base, seed=seed, feedback=-1,
               device=device)
    wall, out = time.perf_counter() - t0, PolyChordOutput(base, "test")
    return {"wall_s": wall, "nlive": nlive, "num_repeats": num_repeats,
            "seed": seed, "device": device, "ndead": out.ndead, "logZ": out.logZ,
            "logZerr": out.logZerr, "pull": (out.logZ - D160_LOGZ) / out.logZerr}


#: the host processes that run plain versions beside the card's phases
#: (plain_job): their checks wait in the phase plain_checks, behind the
#: card's kernel timings
PLAIN_WORKERS = 3


def plain_worker_init() -> None:
    """A worker of the plain versions: one CPU thread at a lower priority
    than the script's, the port importable; it never touches the card."""
    import torch

    os.nice(10)
    torch.set_num_threads(1)
    sys.path.insert(0, HERE)


def plain_job_file(path: str):
    """plain_job on the job that ``path`` holds (torch.save'd by the script,
    so that no large input crosses the pool's pipes while the card is
    timed): its outputs go to ``path`` + ".out"; returns (that path, wall
    ms)."""
    import torch

    out, ms = plain_job(torch.load(path, weights_only=False))
    torch.save(out, path + ".out")
    os.remove(path)
    return path + ".out", ms


def plain_job(job: dict):
    """One plain version on the host's CPU, in a worker process: job["plain"]
    names it ("v4": slice_records_plain, counting steps with
    job["count_steps"]; "v3", "v2", "v5": B4's, B5's and B3's;
    "gram_schmidt"; "while_body20": E7's body20 over job["n"] iterations
    from zeros of job["shape"]), job["like"] the likelihood that scores its probes (a
    Lowered, whose plain_logL is the fused routes' plain version, or
    ("zoo", D), the zoo Gaussian's torch calc), and the rest its CPU
    inputs.  The plain versions are elementwise torch in a fixed order, so
    the CPU gives the card's bits.  Returns (outputs, wall ms)."""
    import torch

    from polychordlite_tpu_torch.models import gaussian
    from polychordlite_tpu_torch.ops import pallas_dirs, pallas_slice, pallas_slice_v3
    from polychordlite_tpu_torch.ops import pallas_slice_v5
    from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
    from polychordlite_tpu_torch.ops.slice_kernel import slice_records_plain
    from polychordlite_tpu_torch.priors import identity_prior

    t0 = time.perf_counter()
    if job["plain"] == "while_body20":  # E7's body20 from a tile of zeros
        from polychordlite_tpu_torch.experiments import prof_pallas_while

        out = prof_pallas_while.while_loop_plain("body20", torch.zeros(job["shape"]), job["n"])
    elif job["plain"] == "gram_schmidt":
        out = pallas_dirs.gram_schmidt_plain(job["g"])
    else:
        like = job["like"]
        if isinstance(like, tuple):  # ("zoo", D): the calc of geometry()
            calc = make_batched_calculator(identity_prior, gaussian(like[1]), like[1], 2,
                                           device="cpu")
            fn = lambda p: calc(p)[2]  # noqa: E731
        else:
            fn = like.plain_logL
        plain = {"v4": lambda *a: slice_records_plain(*a, count_steps=job.get("count_steps",
                                                                               False)),
                 "v3": pallas_slice_v3.slice_records_window_plain,
                 "v2": pallas_slice.slice_records_lockstep_plain,
                 "v5": pallas_slice_v5.slice_records_packet_plain}[job["plain"]]
        out = plain(fn, job["cfg"], job["kw"], *job["args"])
    return out, (time.perf_counter() - t0) * 1e3


def lse(values) -> float:
    m = max(values)
    return m + math.log(sum(math.exp(v - m) for v in values))


def main() -> None:
    t_script = time.perf_counter()
    try:
        import numpy as np
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU", 2)
    sys.path.insert(0, HERE)
    try:
        import polychordlite_tpu_torch as pt
        from polychordlite_tpu_torch.experiments import (
            pallas_epoch_v2,
            pallas_slice_repeat,
            prof_grid_overhead,
            prof_lockstep_waste,
            prof_pallas_while,
            prof_v3_iters,
            sim_iter_distribution,
            v3_instr,
        )
        from polychordlite_tpu_torch.experiments.bench_geometry import slice_inputs
        from polychordlite_tpu_torch.inidriver import run_ini
        from polychordlite_tpu_torch.models import (
            gaussian,
            gaussian_shells,
            get_likelihood,
            himmelblau,
            random_gaussian,
        )
        from polychordlite_tpu_torch.ops import (
            fused_like,
            pallas_dirs,
            pallas_slice,
            pallas_slice_v3,
            pallas_slice_v4,
            pallas_slice_v5,
        )
        from polychordlite_tpu_torch.ops.directions import make_directions
        from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
        from polychordlite_tpu_torch.ops.precision import real_dtype_scope
        from polychordlite_tpu_torch.ops.slice_kernel import (
            EpochConfig,
            route_reason,
            slice_records_plain,
        )
        from polychordlite_tpu_torch.core.generate import assign_num_repeats, time_speeds
        from polychordlite_tpu_torch.output import PolyChordOutput
        from polychordlite_tpu_torch.parallel.mesh import GRANULE
        from polychordlite_tpu_torch.priors import (
            BlockPrior,
            GaussianPrior,
            UniformPrior,
            identity_prior,
        )
        from polychordlite_tpu_torch.settings import PolyChordSettings
        from polychordlite_tpu_torch.utils import cabi, nvcc
        from polychordlite_tpu_torch.utils.inifile import read_ini
    except ImportError as e:
        fail(f"cannot import the port beside this script ({e})")

    dev = torch.device("cuda")
    os.makedirs(OUT, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    label = f"{torch.cuda.get_device_name(0)}, power limit {card.split(',')[-1].strip()}"
    results = {}
    failed = []
    seconds = {}  # each phase's wall seconds, in order

    def phase(name):
        def wrap(fn):
            t0 = time.perf_counter()
            try:
                out = fn()
                seconds[name] = time.perf_counter() - t0
                emit({"phase": name, "ok": True, "card": label,
                      "seconds": seconds[name], **out})
            except Exception as e:  # report every phase, fail at the end
                traceback.print_exc()
                emit({"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}"})
                failed.append(name)
            return fn
        return wrap

    # the plain versions of the heaviest checks run on the host's CPU in
    # PLAIN_WORKERS worker processes beside the card's phases (plain_job):
    # a phase runs and times its kernels, hands the plain versions their
    # inputs (plain_later) and leaves its comparison to plain_checks
    # (check_later), which waits for them behind the kernel timings
    plain_pool = ProcessPoolExecutor(max_workers=PLAIN_WORKERS,
                                     mp_context=multiprocessing.get_context("spawn"),
                                     initializer=plain_worker_init)
    for _ in range(PLAIN_WORKERS):  # every worker started now, behind the build
        plain_pool.submit(time.sleep, 0.5)
    plain_dir = tempfile.mkdtemp(prefix="plain_jobs_")
    plain_ids, plain_read = itertools.count(), {}
    deferred = []  # (tag, {key: future}, check(plain outputs by key))

    def plain_later(plain, like, cfg=None, kw=None, args=(), **extra):
        """Submit a plain version (plain_job) on CPU copies of its inputs,
        written to a file here (plain_job_file): a Lowered goes without its
        device buffers."""
        if isinstance(like, fused_like.Lowered):
            like = dataclasses.replace(like, build_seconds={}, _device_consts={})
        cpu = tuple(a.cpu() for a in args)
        extra = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in extra.items()}
        path = os.path.join(plain_dir, f"job{next(plain_ids)}.pt")
        torch.save({"plain": plain, "like": like, "cfg": cfg, "kw": kw, "args": cpu, **extra},
                   path)
        return plain_pool.submit(plain_job_file, path)

    def plain_result(future):
        """(outputs, ms) of a plain_later job, read from its file once."""
        if future not in plain_read:
            path, ms = future.result()
            plain_read[future] = (torch.load(path, weights_only=False), ms)
            os.remove(path)
        return plain_read[future]

    def check_later(tag, futures, check):
        """Compare a phase's kernel outputs with its plain versions in
        plain_checks: check({key: (outputs on the card, ms)}) raises on a
        mismatch."""
        deferred.append((tag, futures, check))

    def on_card(out):
        return tuple(x.to(dev) for x in out)

    # ---- 1. build: one nvcc per library, all started together; the ring
    # engine's B1 library (RING_LIBRARY) after them, in a thread of this
    # script, behind the phases up to ring_epoch, which waits for it
    ring_lib = ThreadPoolExecutor(max_workers=1)
    ring_build = {}

    @phase("build")
    def _():
        t0 = time.perf_counter()
        nvcc.build_all({k: v for k, v in LIBRARIES.items() if k != RING_LIBRARY})
        ring_build["job"] = ring_lib.submit(
            nvcc.build_all, {RING_LIBRARY: LIBRARIES[RING_LIBRARY]})
        ptxas = {name: ptxas_summary(log) for name, log in nvcc.build_log.items()}
        with open(os.path.join(OUT, "ptxas.txt"), "w") as f:
            for name, log in nvcc.build_log.items():
                f.write(f"==== {name}\n{log}\n")
        log = nvcc.build_log.get
        # the Gaussian functor's kernels of B1, B3, B4, B5 and E2 by G in the
        # 32 bucket, and of B1, B4 and B5 by G in the 128 and the stream
        # buckets (keys "bucket,G", the stream bucket's "0,32"; the others are
        # in ptxas.txt): registers, stack, spills
        like = r"12GaussianLikeILi(32|128|0)EE"
        gaussian_kernels = {
            "B1": ptxas_kernels(log("slice_epoch", ""),
                                rf"slice_epoch_kernelI8V4Policy{like}Li(\d+)ELb([01])E"),
            "B3": ptxas_kernels(log("slice_epoch_v5", "") + log("slice_epoch_v5_wide", ""),
                                rf"slice_epoch_v5_kernelI{like}Li(\d+)EE"),
            "B4": ptxas_kernels(log("slice_epoch_v3", ""),
                                rf"slice_epoch_kernelI8V3Policy{like}Li(\d+)ELb0E"),
            "B5": ptxas_kernels(log("slice_epoch_v2", ""),
                                rf"slice_epoch_kernelI8V2Policy{like}Li(\d+)ELb0E"),
            "E3": ptxas_kernels(log("slice_epoch_v2", ""),
                                rf"slice_epoch_v2_counted_kernelI{like}E"),
            "E2": ptxas_kernels(log("slice_epoch_v3_instr", ""),
                                rf"slice_epoch_v3_instr_kernelI{like}Li(\d+)ELb([01])E"),
            "B2": ptxas_kernels(log("gram_schmidt", ""),
                                r"(gram_schmidt_wide_kernel|gram_schmidt_long_kernel|"
                                r"gsl_to_columns|gsl_from_columns|"
                                r"gram_schmidt_kernelILi(?:20|32)E)"),
        }
        results["ptxas_gaussian"] = gaussian_kernels
        return {"seconds": round(time.perf_counter() - t0, 3),
                "per_library": {k: round(v, 3) for k, v in nvcc.build_seconds.items()},
                "ptxas": ptxas,
                "gaussian_kernels_by_group": gaussian_kernels}

    # E7's body20 at full length on the host (while_cost holds the kernel to it)
    e7_plain = plain_later("while_body20", None, shape=(prof_pallas_while.SIZES["S"],
                                                         prof_pallas_while.LANE),
                           n=prof_pallas_while.SIZES["n"])

    # ---- 2. Gram-Schmidt (B2) against its plain version, bitwise: the
    # thread-per-basis kernel at the bench and gaussian.ini's shapes, the
    # wide kernel at the bases a B = 512, R = 2 D epoch draws at
    # D = 40, 64, 128 and at the bench's chains at D = 64
    @phase("gram_schmidt")
    def _():
        out = {}
        shapes = [("bench", (5, 20, 20, BENCH["B"])), ("gaussian_ini", (2, 20, 20, 512))] + [
            (f"d{d}", (2, d, d, 512)) for d in WIDE_DIMS] + [
            ("d64_run", (2, D64_RUN["D"], D64_RUN["D"], D64_RUN["B"])),
            ("d64_bench", (5, 64, 64, BENCH["B"]))]
        for tag, shape in shapes:
            wide = shape[1] > pallas_dirs.NARROW_MAXD
            g = torch.randn(shape, generator=torch.Generator(dev).manual_seed(1), device=dev)
            # the narrow shapes time the plain version over 3 calls; the wide
            # ones' takes seconds, so it runs once
            if wide:
                q_plain, plain_ms = cuda_once(
                    lambda: pallas_dirs.gram_schmidt_plain(g))  # noqa: B023
            else:
                q_plain = pallas_dirs.gram_schmidt_plain(g)
                plain_ms = cuda_ms(lambda: pallas_dirs.gram_schmidt_plain(g), 3)  # noqa: B023
            counted = dict(pallas_dirs.LAUNCHES)
            q = pallas_dirs.gram_schmidt_lanes(g)
            kernel = "gram_schmidt_wide" if wide else "gram_schmidt"
            if pallas_dirs.LAUNCHES[kernel] != counted[kernel] + 1:
                raise AssertionError(f"{tag}: {kernel} was not the kernel launched")
            mism = int((q != q_plain).sum())
            if mism:
                raise AssertionError(f"{tag}: the kernel differs from the plain version in "
                                     f"{mism} entries")
            err = (q - q_plain).abs().max().item()
            qtq = torch.einsum("nikb,nijb->nkjb", q, q)
            orth = (qtq - torch.eye(shape[1], device=dev)[None, :, :, None]).abs().max().item()
            if not (err == 0.0 and orth <= 1e-5):
                raise AssertionError(f"{tag}: max|dq| {err:.3g}, max|QtQ - I| {orth:.3g}")
            # the yardstick: one batched Householder QR of the same bases,
            # (NB*B, D, D) with the vectors as columns; the port never calls it
            mats = g.permute(0, 3, 1, 2).reshape(-1, shape[1], shape[2]).contiguous()
            out[tag] = {
                "shape": list(shape), "kernel": kernel, "max_abs_err": err, "orth_err": orth,
                "mismatches": mism,
                "ms": cuda_ms(lambda: pallas_dirs.gram_schmidt_lanes(g), 20),  # noqa: B023
                "plain_ms": plain_ms,
                # one call after a warm-up (3 s at the bench's bases)
                "library_ms": cuda_ms(lambda: torch.linalg.qr(mats), 1),  # noqa: B023
            }
            nb, d, _, b = shape
            out[tag]["bound_ms"], out[tag]["bound_by"] = bound(
                2 * 4 * nb * d * d * b, gram_schmidt_flops(nb, d, b))
            out[tag]["ms_over_library"] = out[tag]["ms"] / out[tag]["library_ms"]
            if wide:  # the wide kernel's bases a block and resident warps an SM
                nw, blocks = pallas_dirs.wide_blocks(nb, d, b)
                out[tag]["bases_a_block"], out[tag]["resident_warps"] = nw, nw * blocks
        results["gram_schmidt"] = {**out["bench"],
                                   "max_abs_err": max(o["max_abs_err"] for o in out.values())}
        results["gram_schmidt_wide"] = out["d64"]
        results["gram_schmidt_d64_run"] = out["d64_run"]
        return out

    # ---- 2b. B2 above dim 128 (the long path: blocked CGS2, four warps a
    # basis, the bases in a column-major scratch streamed through shared
    # memory): (2, dim, dim, 512) at dims 160 and 256 in float32 and 160 in
    # float64, the 160-D run's bases (5, 160, 160, 256) and dim 512 on a few
    # chains (GS_D512_FEW), each bitwise its plain version, which the host's
    # CPU workers run (plain_checks); (2, 512, 512, 512) timed and held to
    # QtQ = I; each beside torch.linalg.qr, with the kernel's resident warps
    # an SM and the scratch's bytes (GS_LONG)
    @phase("gram_schmidt_d512")
    def _():
        out = {}
        counts0 = dict(pallas_dirs.LAUNCHES)
        lib = pallas_dirs._lib()
        for tag, NB, dim, B, dt_name in GS_LONG + (("d512_few",) + GS_D512_FEW,):
            dt = getattr(torch, dt_name)
            shape = (NB, dim, dim, B)
            g = torch.randn(shape, generator=torch.Generator(dev).manual_seed(dim), device=dev,
                            dtype=dt)
            name = "gram_schmidt_long" + ("_f64" if dt == torch.float64 else "")
            before = pallas_dirs.LAUNCHES[name]
            q = pallas_dirs.gram_schmidt_lanes(g)
            torch.cuda.synchronize()
            if pallas_dirs.LAUNCHES[name] != before + 1:
                raise AssertionError(f"{tag}: {name} was not the kernel launched")
            eye = torch.eye(dim, device=dev, dtype=dt)[None, :, :, None]
            orth = (torch.einsum("nikb,nijb->nkjb", q, q) - eye).abs().max().item()
            # float32 at 512 is held to 1e-4, as the earlier order was
            tol = 1e-12 if dt == torch.float64 else (1e-5 if dim <= 256 else 1e-4)
            if not orth <= tol:
                raise AssertionError(f"{tag}: max|QtQ - I| {orth:.3g} > {tol}")
            itemsize = g.element_size()
            n_scratch = lib.gram_schmidt_scratch_values(NB, dim, B, itemsize)
            rec = {"shape": list(shape), "dtype": dt_name, "kernel": name, "orth_err": orth,
                   "scratch_values": n_scratch, "scratch_bytes": n_scratch * itemsize,
                   "resident_warps_per_sm": lib.gram_schmidt_long_resident_warps(dim, itemsize),
                   "ms": cuda_ms(lambda: pallas_dirs.gram_schmidt_lanes(g),  # noqa: B023
                                 3 if dim <= 256 else 2),
                   "library_ms": qr_ms(g), "mismatches": None, "max_abs_err": None,
                   "plain_ms": None}
            rec["bound_ms"], rec["bound_by"] = bound(
                2 * itemsize * NB * dim * dim * B, gram_schmidt_flops(NB, dim, B),
                F64_FLOPS_PER_S if dt == torch.float64 else F32_FLOPS_PER_S)
            out[tag] = rec
            if tag != "d512_float32":  # its plain version would take minutes on a core
                # the host's workers take at most 512 bases a job, split by chains
                step = max(1, 512 // NB)
                futs = {s: plain_later("gram_schmidt", None, g=g[..., s:s + step])
                        for s in range(0, B, step)}
                q_host = q.cpu()

                def check(res, q_host=q_host, rec=rec, tag=tag):
                    q_plain = torch.cat([res[s][0] for s in sorted(res)], dim=3)
                    mism = int((q_host != q_plain).sum())
                    rec.update(mismatches=mism, plain_device="cpu",
                               max_abs_err=(q_host - q_plain).abs().max().item(),
                               plain_ms=sum(ms for _, ms in res.values()))
                    if mism:
                        raise AssertionError(f"{tag}: the kernel differs from its plain "
                                             f"version on the CPU in {mism} entries")
                    return {"mismatches": mism, "plain_ms": rec["plain_ms"]}

                check_later(f"gram_schmidt_d512/{tag}", futs, check)
            del q, g
        out["launches"] = {k: v - counts0[k] for k, v in pallas_dirs.LAUNCHES.items()
                           if v > counts0[k]}
        results["gram_schmidt_long"] = out
        return out

    def ball_inputs(B, D, like, gen):
        """Seeds at 0.5 +- 0.05 inside a ball contour of radius 1.5 sigma sqrt(D)."""
        sigma = like.device_form["sigma"]
        x0 = 0.5 + 0.05 * torch.randn((B, D), generator=gen, device=dev)
        r0 = 1.5 * sigma * math.sqrt(D)
        bound = torch.full((B,), like.device_form["norm"] - 0.5 * (r0 / sigma) ** 2, device=dev)
        valid = torch.ones(B, dtype=torch.bool, device=dev)
        return x0, bound, valid, (sigma * torch.eye(D, device=dev)).expand(B, D, D)

    def live_set_inputs(B, D, calc, gen, nlive=INI["nlive"], B_valid=RUN["B_valid"]):
        """As run() feeds the kernel mid-run: seeds are picks from a live set
        of nlive points, each lane's bound is the logL of a live point at or
        below its seed's, the Cholesky is that of the live set's covariance,
        and the lanes past B_valid are invalid, seeded as lane 0."""
        live = (0.5 + 0.06 * torch.randn((nlive, D), generator=gen, device=dev)).clamp(0, 1)
        live_logL = calc(live)[2]
        pick = torch.randint(0, nlive, (B,), generator=gen, device=dev)
        other = torch.randint(0, nlive, (B,), generator=gen, device=dev)
        pick[B_valid:] = pick[0]
        x0 = live[pick]
        bound = torch.minimum(live_logL[pick], live_logL[other])
        valid = torch.arange(B, device=dev) < B_valid
        chol = torch.linalg.cholesky(torch.cov(live.T)).expand(B, D, D)
        return x0, bound, valid, chol

    def shells_inputs(B, calc, gen, nlive=500, B_valid=SHELLS["B_valid"]):
        """As run() feeds the kernels mid-run on gaussian_shells.ini: seeds
        picked from a live set of nlive points on the two shells, each
        lane's bound the logL of a live point at or below its seed's, the
        live set's Cholesky, the lanes past B_valid invalid."""
        ang = 2 * math.pi * torch.rand(nlive, generator=gen, device=dev)
        side = torch.where(torch.rand(nlive, generator=gen, device=dev) < 0.5, -3.5, 3.5)
        rad = 2.0 + 0.1 * torch.randn(nlive, generator=gen, device=dev)
        th = torch.stack([side + rad * torch.cos(ang), rad * torch.sin(ang)], 1)
        lo, span = torch.tensor([-6.0, -2.5], device=dev), torch.tensor([12.0, 5.0], device=dev)
        live = ((th - lo) / span).clamp(0, 1)
        live_logL = calc(live)[2]
        pick = torch.randint(0, nlive, (B,), generator=gen, device=dev)
        other = torch.randint(0, nlive, (B,), generator=gen, device=dev)
        pick[B_valid:] = pick[0]
        bound = torch.minimum(live_logL[pick], live_logL[other])
        valid = torch.arange(B, device=dev) < B_valid
        chol = torch.linalg.cholesky(torch.cov(live.T)).expand(B, 2, 2)
        return live[pick], bound, valid, chol

    shells_ini = os.path.join(HERE, "ini", "gaussian_shells.ini")
    _, shells_blocks, *_ = read_ini(shells_ini)

    def geometry(tag, geo):
        """(calc, cfg, kernel inputs) of one checked geometry."""
        B, R, D = geo["B"], geo["R"], geo["D"]
        gen = torch.Generator(dev).manual_seed(SEED)
        if tag == "shells_ini":
            calc = make_batched_calculator(BlockPrior(shells_blocks, D), gaussian_shells(D), D, 0)
            x0, bound, valid, chol = shells_inputs(B, calc, gen)
        else:
            like = gaussian(D)
            calc = make_batched_calculator(identity_prior, like, D, 2)
            if "B_valid" in geo:
                x0, bound, valid, chol = live_set_inputs(B, D, calc, gen, B_valid=geo["B_valid"])
            else:
                x0, bound, valid, chol = ball_inputs(B, D, like, gen)
        cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
        nh, w, _ = make_directions(chol, grade_dims=(D,), num_repeats=(R,), n_dims=D,
                                   generator=gen)
        return calc, cfg, (x0, bound, valid, nh, w)

    GEOMETRIES = (("small", SMALL), ("gaussian_ini", RUN), ("bench", BENCH),
                  ("shells_ini", SHELLS))
    GROUPS = pallas_slice_v4.GROUPS
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    # the data inis' functors, lowered here and built at the route's G
    # (pallas_slice_v4.route_group) behind the phases that follow, as the
    # ring library is; the ini runs load the same libraries from disk
    data_lib = ThreadPoolExecutor(max_workers=1)

    def data_form(name, geo):
        """(calc, Lowered, the route's G, its build's future) of a data ini's
        model, or None where the lowering refuses it."""
        calc = data_calc(name, dev)
        low = fused_like.lowering(calc)
        if not isinstance(low, fused_like.Lowered):
            return None
        G = pallas_slice_v4.route_group(calc, geo["B"], geo["D"], dev)
        return calc, low, G, data_lib.submit(low.build, [G])

    data_forms = {k: data_form(k, g) for k, g in DATA_RUNS.items()}

    def mismatches(got, want):
        return {k: int((a != b).sum()) for k, a, b in zip(("t", "logL", "nlike"), got, want)}

    def decisions(tag, pairs):
        """Mismatch counts of (name, got, want) triples; raises on any."""
        mism = {name: int((a != b).sum()) for name, a, b in pairs}
        if any(mism.values()):
            raise AssertionError(f"{tag}: {mism}")
        return mism

    # ---- 3. what B1's micro-step costs (the redesign's step 0) --------------
    @phase("measure_first")
    def _():
        w = prof_pallas_while
        S, n = w.SIZES["S"], w.SIZES["n"]
        x = 0.2 + 0.6 * torch.rand((S, w.LANE), generator=torch.Generator(dev).manual_seed(SEED),
                                   device=dev)
        zeros = torch.zeros((S, w.LANE), device=dev)
        bodies = {}
        for v in ("body20", "body20_div", "body20_hash"):
            decisions(f"E7 {v} differs from its plain version",
                      [(v, w.while_loop(v, x, 2000), w.while_loop_plain(v, x, 2000))])
            ms = cuda_ms(lambda v=v: w.while_loop(v, zeros, n), 3)
            bodies[v] = {"ms": ms, "us_per_iter": ms * 1e3 / n}
        by_group = {}
        kw = (0x01234567, 0x89ABCDEF)
        for tag, geo in (("gaussian_ini", RUN), ("zoo_d4", ZOO_D4), ("zoo_d8", ZOO_D8),
                         ("bench", BENCH), ("bench_x4", BENCH_X4)):
            calc, cfg, args = geometry(tag, geo)
            one = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args, group=1)
            for G in GROUPS:
                decisions(f"{tag}: B1 at G={G} differs from G=1", [
                    (f"{k}_G{G}", a, b) for k, a, b in zip(
                        ("t", "logL", "nlike"),
                        pallas_slice_v4.slice_epoch(calc, cfg, kw, *args, group=G), one)])
            lane_max = int(pallas_slice_v4.slice_epoch_counted(calc, cfg, kw, *args)[3].max())
            ms = {G: cuda_ms(lambda G=G: pallas_slice_v4.slice_epoch(  # noqa: B023
                calc, cfg, kw, *args, group=G), 5) for G in GROUPS}  # noqa: B023
            B, D = geo["B"], geo["D"]
            by_group[tag] = {
                "B": B, "R": geo["R"], "D": D, "evals": int(one[2].sum()),
                "lane_steps_max": lane_max, "chosen_group": pallas_slice_v4.choose_group(B, D, n_sm),
                "ms_by_group": ms, "us_per_micro_step_by_group":
                    {G: t * 1e3 / lane_max for G, t in ms.items()},
                "best_group": min(ms, key=ms.get)}
            if tag in ("zoo_d4", "zoo_d8"):  # B3, B4 and B5 by G beside B1
                for name, fn, groups, chosen in (
                        ("b3", pallas_slice_v5.slice_epoch_v5, pallas_slice_v5.PACKET_GROUPS,
                         pallas_slice_v5.packet_group_for(calc, B, D, dev)),
                        ("b4", pallas_slice_v3.slice_epoch_v3, GROUPS,
                         pallas_slice_v4.choose_group(B, D, n_sm)),
                        ("b5", pallas_slice.slice_epoch_v2, GROUPS,
                         pallas_slice_v4.choose_group(B, D, n_sm))):
                    decisions(f"{tag}: {name} at some G differs from B1", [
                        (f"{k}_G{G}", a, b) for G in groups for k, a, b in zip(
                            ("t", "logL", "nlike"), fn(calc, cfg, kw, *args, group=G), one)])
                    t_by_g = {G: cuda_ms(lambda G=G, fn=fn: fn(  # noqa: B023
                        calc, cfg, kw, *args, group=G), 5) for G in groups}  # noqa: B023
                    by_group[tag].update({f"{name}_chosen_group": chosen,
                                          f"{name}_ms_by_group": t_by_g,
                                          f"{name}_best_group": min(t_by_g, key=t_by_g.get)})
        x4 = by_group["bench_x4"]["ms_by_group"][1] / by_group["bench"]["ms_by_group"][1]
        sass = sass_report(str(nvcc.library_path("slice_epoch", LIBRARIES["slice_epoch"])),
                           os.path.join(OUT, "slice_epoch_gaussian.sass"))
        results["measure_first"] = {"bodies": bodies, "b1_by_group": by_group}
        return {"n_sm": n_sm, "bodies": bodies,
                "body20_div_minus_body20_us": bodies["body20_div"]["us_per_iter"]
                - bodies["body20"]["us_per_iter"],
                "body20_hash_minus_body20_us": bodies["body20_hash"]["us_per_iter"]
                - bodies["body20"]["us_per_iter"],
                "b1_by_group": by_group, "b1_g1_x4_chains_time_ratio": x4,
                "sass": sass if sass is not None else "cuobjdump not found on this machine"}

    # ---- 4. slice epoch (B1) at every G against the plain torch engine -----
    @phase("slice_epoch")
    def _():
        out = {}
        for tag, geo in GEOMETRIES:
            B, R, D = geo["B"], geo["R"], geo["D"]
            calc, cfg, args = geometry(tag, geo)
            pallas_slice_v4.validate_functor(calc, cfg, dev)
            kw = (0x01234567, 0x89ABCDEF)
            valid = args[2]
            t, l, n = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
            want, plain_ms = cuda_once(lambda: slice_records_plain(  # noqa: B023
                lambda p: calc(p)[2], cfg, kw, *args))  # noqa: B023
            tp, lp, n_p = want
            one = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args, group=1)
            mism = {"default_vs_plain": mismatches((t, l, n), want),
                    "default_vs_G1": mismatches((t, l, n), one)}
            for G in GROUPS:
                mism[f"G{G}_vs_plain"] = mismatches(
                    pallas_slice_v4.slice_epoch(calc, cfg, kw, *args, group=G), want)
            if any(v for m in mism.values() for v in m.values()):
                raise AssertionError(f"{tag}: kernel and plain engine differ {mism}")
            err = max((t - tp).abs().max().item(), (l - lp).abs().max().item())
            evals = int(n.sum())
            ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args), 5)  # noqa: B023
            g1_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(  # noqa: B023
                calc, cfg, kw, *args, group=1), 5)  # noqa: B023
            out[tag] = {
                "B": B, "R": R, "D": D, "valid_lanes": int(valid.sum()),
                "group": pallas_slice_v4.choose_group(B, D, n_sm),
                "evals": evals, "max_abs_err": err, "mismatches": mism,
                "ms": ms, "g1_ms": g1_ms, "plain_ms": plain_ms,
                "evals_per_s": evals / (ms / 1e3), "plain_evals_per_s": evals / (plain_ms / 1e3),
            }
        results["slice_epoch"] = {**out["bench"],
                                  "max_abs_err": max(o["max_abs_err"] for o in out.values())}
        return out

    # ---- 4. speculative slice epoch (B3) at every G against its plain version,
    # its G = 1 form and B1
    PACKET_GROUPS = pallas_slice_v5.PACKET_GROUPS

    @phase("slice_epoch_v5")
    def _():
        out = {}
        for tag, geo in GEOMETRIES:
            B, R, D = geo["B"], geo["R"], geo["D"]
            calc, cfg, args = geometry(tag, geo)
            pallas_slice_v4.validate_functor(calc, cfg, dev, pallas_slice_v5.slice_epoch_v5)
            kw = (0x01234567, 0x89ABCDEF)

            def v5(G=None, calc=calc, cfg=cfg, args=args):
                return pallas_slice_v5.slice_epoch_v5(calc, cfg, kw, *args, group=G)

            got = v5()
            want, plain_ms = cuda_once(
                lambda: pallas_slice_v5.slice_records_packet_plain(  # noqa: B023
                    lambda p: calc(p)[2], cfg, kw, *args))  # noqa: B023
            v4 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
            one = v5(1)
            pairs = [(f"{k}_vs_{other}", a, b) for other, ref in
                     (("plain", want), ("v4", v4), ("G1", one))
                     for k, a, b in zip(("t", "logL", "nlike"), got, ref)]
            for G in PACKET_GROUPS:
                pairs += [(f"{k}_G{G}_vs_plain", a, b) for k, a, b in
                          zip(("t", "logL", "nlike"), v5(G), want)]
            mism = decisions(f"{tag}: B3 differs", pairs)
            err = max((got[0] - want[0]).abs().max().item(),
                      (got[1] - want[1]).abs().max().item())
            evals = int(got[2].sum())
            ms_by_group = {G: cuda_ms(lambda G=G: v5(G), 5) for G in PACKET_GROUPS}  # noqa: B023
            ms = cuda_ms(v5, 5)
            v4_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args), 5)  # noqa: B023
            out[tag] = {
                "B": B, "R": R, "D": D, "valid_lanes": int(args[2].sum()),
                "group": pallas_slice_v5.packet_group_for(calc, B, D, dev),
                "resident_warps_by_group": {G: pallas_slice_v5.resident_warps(calc, D, dev, G)
                                            for G in PACKET_GROUPS},
                "evals": evals, "mismatches": mism, "max_abs_err": err,
                "ms": ms, "g1_ms": ms_by_group[1], "ms_by_group": ms_by_group,
                "best_group": min(ms_by_group, key=ms_by_group.get),
                "plain_ms": plain_ms, "v4_ms": v4_ms, "over_v4": ms / v4_ms,
                "evals_per_s": evals / (ms / 1e3), "plain_evals_per_s": evals / (plain_ms / 1e3),
            }
        results["slice_epoch_v5"] = {**out["bench"],
                                     "max_abs_err": max(o["max_abs_err"] for o in out.values())}
        return out

    # ---- 5. v3 (B4) and v2 (B5) at every G against their plain versions,
    # their G = 1 forms and B1
    @phase("slice_epoch_v3")
    def _():
        out = {}
        for tag, geo in GEOMETRIES:
            B, R, D = geo["B"], geo["R"], geo["D"]
            calc, cfg, args = geometry(tag, geo)
            pallas_slice_v4.validate_functor(calc, cfg, dev, pallas_slice_v3.slice_epoch_v3)
            kw = (0x01234567, 0x89ABCDEF)

            def v3(G=None, calc=calc, cfg=cfg, args=args):
                return pallas_slice_v3.slice_epoch_v3(calc, cfg, kw, *args, group=G)

            got = v3()
            want, plain_ms = cuda_once(
                lambda: pallas_slice_v3.slice_records_window_plain(  # noqa: B023
                    lambda p: calc(p)[2], cfg, kw, *args))  # noqa: B023
            v4 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
            one = v3(1)
            names = ("t", "logL", "nlike")
            pairs = [(f"{k}_vs_{other}", a, b) for other, ref in
                     (("plain", want), ("v4", v4), ("G1", one))
                     for k, a, b in zip(names, got, ref)]
            for G in GROUPS:
                got_g = v3(G)
                pairs += [(f"{k}_G{G}_vs_{other}", a, b) for other, ref in
                          (("plain", want), ("v4", v4)) for k, a, b in zip(names, got_g, ref)]
            mism = decisions(f"{tag}: B4 differs", pairs)
            err = max((got[0] - want[0]).abs().max().item(),
                      (got[1] - want[1]).abs().max().item())
            ms_by_group = {G: cuda_ms(lambda G=G: v3(G), 5) for G in GROUPS}  # noqa: B023
            ms = cuda_ms(v3, 5)
            v4_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args), 5)  # noqa: B023
            evals = int(got[2].sum())
            out[tag] = {
                "B": B, "R": R, "D": D, "group": pallas_slice_v4.choose_group(B, D, n_sm),
                "evals": evals, "mismatches": mism, "max_abs_err": err,
                "ms": ms, "g1_ms": ms_by_group[1], "ms_by_group": ms_by_group,
                "best_group": min(ms_by_group, key=ms_by_group.get),
                "plain_ms": plain_ms, "v4_ms": v4_ms, "over_v4": ms / v4_ms,
                "evals_per_s": evals / (ms / 1e3),
            }
        results["slice_epoch_v3"] = {**out["bench"],
                                     "max_abs_err": max(o["max_abs_err"] for o in out.values())}
        return out

    @phase("slice_epoch_v2")
    def _():
        out = {}
        for tag, geo in GEOMETRIES:
            B, R, D = geo["B"], geo["R"], geo["D"]
            calc, cfg, args = geometry(tag, geo)
            pallas_slice_v4.validate_functor(calc, cfg, dev, pallas_slice.slice_epoch_v2)
            kw = (0x01234567, 0x89ABCDEF)

            def v2(G=None, calc=calc, cfg=cfg, args=args):
                return pallas_slice.slice_epoch_v2(calc, cfg, kw, *args, group=G)

            got = v2()
            want, plain_ms = cuda_once(
                lambda: pallas_slice.slice_records_lockstep_plain(  # noqa: B023
                    lambda p: calc(p)[2], cfg, kw, *args))  # noqa: B023
            v4 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
            one = v2(1)
            names = ("t", "logL", "nlike", "cube")
            pairs = [(f"{k}_vs_{other}", a, b) for other, ref in
                     (("plain", want), ("v4", v4), ("G1", one))
                     for k, a, b in zip(names, got, ref)]
            for G in GROUPS:
                pairs += [(f"{k}_G{G}_vs_plain", a, b) for k, a, b in zip(names, v2(G), want)]
            mism = decisions(f"{tag}: B5 differs", pairs)
            rebuilt = args[0][:, None, :] + torch.cumsum(v4[0][:, :, None] * args[3], dim=1)
            cube_vs_v4 = (got[3] - rebuilt).abs().max().item()
            if not cube_vs_v4 <= 1e-5:
                raise AssertionError(f"{tag}: B5's cube is {cube_vs_v4} from B1's rebuild")
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            ms_by_group = {G: cuda_ms(lambda G=G: v2(G), 5) for G in GROUPS}  # noqa: B023
            ms = cuda_ms(v2, 5)
            v4_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args), 5)  # noqa: B023
            evals = int(got[2].sum())
            out[tag] = {
                "B": B, "R": R, "D": D, "group": pallas_slice_v4.choose_group(B, D, n_sm),
                "evals": evals, "mismatches": mism,
                "max_abs_err": err, "max_abs_cube_vs_v4_rebuild": cube_vs_v4,
                "ms": ms, "g1_ms": ms_by_group[1], "ms_by_group": ms_by_group,
                "best_group": min(ms_by_group, key=ms_by_group.get),
                "plain_ms": plain_ms, "v4_ms": v4_ms, "over_v4": ms / v4_ms,
                "evals_per_s": evals / (ms / 1e3),
            }
        results["slice_epoch_v2"] = {**out["bench"],
                                     "max_abs_err": max(o["max_abs_err"] for o in out.values())}
        return out

    # ---- 6. E1: B1 with its micro-steps counted, and the lane efficiency --
    @phase("lane_efficiency")
    def _():
        out = {}
        for tag, geo in (("bench", BENCH), ("gaussian_ini", RUN)):
            calc, cfg, args = geometry(tag, geo)
            kw = (0x01234567, 0x89ABCDEF)
            got = pallas_slice_v4.slice_epoch_counted(calc, cfg, kw, *args)
            v4 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
            plain_steps = slice_records_plain(lambda p: calc(p)[2], cfg, kw, *args,  # noqa: B023
                                              count_steps=True)[3]
            mism = {k: int((a != b).sum()) for k, a, b in
                    zip(("t", "logL", "nlike", "lane_steps"), got, (*v4, plain_steps))}
            mism["warp_max"] = int((got[4] != pallas_slice_v4.warp_maxima(plain_steps)).sum())
            if any(mism.values()):
                raise AssertionError(f"{tag}: E1 differs {mism}")
            # the study: its own launches (the comparison above does not count)
            pallas_slice_v4.LAUNCHES["slice_epoch_counted"] = 0
            ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch_counted(calc, cfg, kw, *args), 5)  # noqa: B023
            study = pallas_slice_v4.LAUNCHES["slice_epoch_counted"]
            v4_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args), 5)  # noqa: B023
            steps, wmax = got[3].to(torch.int64), got[4].to(torch.int64)
            evals = int(got[2].sum())
            out[tag] = {
                "B": geo["B"], "R": geo["R"], "D": geo["D"], "valid_lanes": int(args[2].sum()),
                "sum_lane_steps": int(steps.sum()), "sum_warp_max": int(wmax.sum()),
                "lane_efficiency": pallas_slice_v4.lane_efficiency(got[3], got[4]),
                "lane_steps_max": int(steps.max()), "lane_steps_mean_valid":
                    float(steps[args[2]].float().mean()),
                "evals": evals, "evals_per_step": evals / max(int(steps.sum()), 1),
                "ms": ms, "v4_ms": v4_ms, "study_launches": study,
            }
        results["lane_efficiency"] = {**out["bench"], "max_abs_err": 0.0,
                                      "launches": sum(o["study_launches"] for o in out.values())}
        return out

    # ---- 6b. B1's route for a likelihood evaluated in torch ----------------
    def slice_step_bytes(B: int, D: int, launches: int, R: int, real: int = 4) -> int:
        """Bytes the traced route must move: per launch and lane the state
        read and written (ten int32, one int64, three floats: 120 bytes in
        float32) and logL, bound and w read, x and its direction read and
        the probe written (3 D floats), plus the (R, B) records written once;
        floats of ``real`` bytes (8 for the double kernel)."""
        return (launches * B * (2 * (48 + 3 * real) + 3 * real + 3 * D * real)
                + (2 * real + 4) * R * B)

    @phase("slice_step")
    def _():
        out = {}
        kw = (0x01234567, 0x89ABCDEF)
        for tag, geo in (("gaussian_ini", RUN), ("bench", BENCH), ("d40", TRACED_D40)):
            B, R, D = geo["B"], geo["R"], geo["D"]
            calc, cfg, args = geometry(tag, geo)  # D = 40: B2's wide kernel
            want, plain_ms = cuda_once(lambda: slice_records_plain(  # noqa: B023
                lambda p: calc(p)[2], cfg, kw, *args))  # noqa: B023
            pairs = []
            for rounds in (1, 7, 32):
                got = pallas_slice_v4.slice_epoch_traced(calc, cfg, kw, *args, rounds=rounds)
                pairs += [(f"{k}_rounds{rounds}_vs_plain", a, b)
                          for k, a, b in zip(("t", "logL", "nlike"), got, want)]
            b1_ms = None
            if D <= pallas_slice_v4.SLICE_MAXD_WIDE:  # the same decisions as B1's functor
                pairs += [(f"{k}_vs_B1", a, b) for k, a, b in zip(
                    ("t", "logL", "nlike"), want, pallas_slice_v4.slice_epoch(calc, cfg, kw, *args))]
                b1_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args), 5)  # noqa: B023
            mism = decisions(f"{tag}: the traced route differs", pairs)
            before = (pallas_slice_v4.LAUNCHES["slice_step"], dict(pallas_slice_v4.TRACED))
            pallas_slice_v4.slice_epoch_traced(calc, cfg, kw, *args)
            per_epoch = pallas_slice_v4.LAUNCHES["slice_step"] - before[0]
            replays = pallas_slice_v4.TRACED["replays"] - before[1]["replays"]
            ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch_traced(calc, cfg, kw, *args), 3)  # noqa: B023
            # the kernel's own share of a round: the same graph of rounds
            # with a calc that is one copy of a constant logL (every probe
            # below every bound: each repeat shrinks max_shrink times)
            fixed = torch.full((B,), float(args[1].min()) - 1.0, device=dev)

            def const(p, fixed=fixed):
                return None, None, fixed

            runner = pallas_slice_v4.TracedEpoch(const, cfg, B, R, D, pallas_slice_v4.ROUNDS, dev)
            before = pallas_slice_v4.LAUNCHES["slice_step"]
            runner(const, kw, *args)
            const_rounds = pallas_slice_v4.LAUNCHES["slice_step"] - before - 1
            const_ms = cuda_ms(lambda: runner(const, kw, *args), 3)  # noqa: B023
            evals = int(want[2].sum())
            out[tag] = {
                "B": B, "R": R, "D": D, "valid_lanes": int(args[2].sum()), "evals": evals,
                "mismatches": mism, "launches_per_epoch": per_epoch,
                "replays_per_epoch": replays, "rounds_per_replay": pallas_slice_v4.ROUNDS,
                "ms": ms, "plain_ms": plain_ms, "b1_ms": b1_ms,
                "plain_over_route": plain_ms / ms, "route_over_b1": ms / b1_ms if b1_ms else None,
                "us_per_round": ms * 1e3 / max(per_epoch - 1, 1),
                "const_calc_rounds": const_rounds, "const_calc_ms": const_ms,
                "kernel_us_per_round": const_ms * 1e3 / max(const_rounds, 1),
                "kernel_share_of_round": (const_ms / max(const_rounds, 1))
                / (ms / max(per_epoch - 1, 1)),
                "evals_per_s": evals / (ms / 1e3),
                "bound": bound(slice_step_bytes(B, D, per_epoch, R), 0),
            }
        results["slice_step"] = {**out["bench"], "max_abs_err": 0.0}
        return out

    def torch_gaussian(n_dims, mu=0.5, sigma=0.1):
        """gaussian.ini's likelihood as a user writes it in torch: batched,
        with its two derived parameters and no device form."""
        norm = -n_dims * (math.log(sigma) + 0.5 * math.log(2 * math.pi))
        log_vn = 0.5 * n_dims * math.log(math.pi) - math.lgamma(1 + 0.5 * n_dims)

        def loglikelihood(theta):
            r2 = ((theta - mu) ** 2).sum(-1)
            r = torch.sqrt(r2)
            return norm - 0.5 * r2 / sigma ** 2, torch.stack([r, n_dims * torch.log(r) + log_vn], -1)

        return loglikelihood

    # the forced engines' fused libraries of slice_forced_fused (gaussian.ini's
    # likelihood in torch: B3's at every G, its launch rule reads their
    # resident warps, B4's and B5's at the bench's and gaussian.ini's G) and
    # of run_forced_torch (the per-point Gaussian at that run's batch: B1's,
    # B3's at every G, B4's and B5's), built one after another in the ring
    # library's thread behind the phases up to slice_forced_fused, which
    # waits for them; each lowered here, on the CPU (a library is named by
    # its graph, not its device)
    def forced_prebuild(wanted):
        t0 = time.perf_counter()
        for low, g, engine in wanted:
            low.library(g, engine)
        return {"libraries": len(wanted), "seconds": time.perf_counter() - t0}

    D_INI = INI["nDims"]
    ini_low = fused_like.lowering(make_batched_calculator(identity_prior, torch_gaussian(D_INI), D_INI,
                                                          2, device="cpu"))
    run_low = fused_like.lowering(make_batched_calculator(identity_prior, per_point_gaussian, D_INI,
                                                          0, device="cpu"))
    ring_build["forced"] = ring_lib.submit(forced_prebuild, [
        (ini_low, g, "cuda5") for g in pallas_slice_v5.PACKET_GROUPS] + [
        (ini_low, pallas_slice_v4.choose_group(geo["B"], D_INI, n_sm), e)
        for geo in (RUN, BENCH) for e in ("cuda3", "cuda2")] + [
        (run_low, g, "cuda5") for g in pallas_slice_v5.PACKET_GROUPS] + [
        (run_low, pallas_slice_v4.choose_group(FORCED_RUN_B, D_INI, n_sm), e)
        for e in ("cuda", "cuda3", "cuda2")])

    # ---- 6c. B1's fused route: the likelihood lowered into the kernel -------
    # slice_fused's models, inputs and B1 fused outputs by geometry, which
    # slice_forced_fused holds B3, B4 and B5 to: (calc, Lowered, cfg, args,
    # B1's fused output, its G, its lane steps)
    fused_refs = {}

    @phase("slice_fused")
    def _():
        out = {}
        kw = (0x01234567, 0x89ABCDEF)
        builds = {}
        for tag, geo in (("gaussian_ini", RUN), ("bench", BENCH)):
            B, R, D = geo["B"], geo["R"], geo["D"]
            zoo_calc, cfg, args = geometry(tag, geo)  # the zoo Gaussian: B1's functor
            calc = make_batched_calculator(identity_prior, torch_gaussian(D), D, 2, device=dev)
            low = fused_like.lowering(calc)
            zoo_low = fused_like.lower(zoo_calc)  # the zoo's own torch form, lowered
            if not isinstance(low, fused_like.Lowered):
                raise AssertionError(f"gaussian.ini in torch was not lowered: {low.reason}")
            G = pallas_slice_v4.choose_group(B, D, n_sm)
            t0 = time.perf_counter()
            low.build(GROUPS)
            zoo_low.build([G])
            names = [low.library_name(g) for g in GROUPS] + [zoo_low.library_name(G)]
            with open(os.path.join(OUT, "ptxas.txt"), "a") as f:
                for n in names:
                    if n in nvcc.build_log:
                        f.write(f"==== {n}\n{nvcc.build_log[n]}\n")
            builds[tag] = {"seconds": time.perf_counter() - t0,
                           "by_group": dict(low.build_seconds), "zoo": dict(zoo_low.build_seconds),
                           "ptxas": {n: ptxas_summary(nvcc.build_log[n]) for n in names
                                     if n in nvcc.build_log}}
            res, plain_ms = cuda_once(lambda: slice_records_plain(  # noqa: B023
                low.plain_logL, cfg, kw, *args, count_steps=True))  # noqa: B023
            want, steps = res[:3], res[3]
            pairs = []
            for g in GROUPS:
                pairs += [(f"{k}_G{g}_vs_plain", a, b) for k, a, b in zip(
                    ("t", "logL", "nlike"),
                    pallas_slice_v4.slice_epoch_fused(calc, cfg, kw, *args, group=g), want)]
            mism = decisions(f"{tag}: the fused kernel differs from its plain version", pairs)
            got = pallas_slice_v4.slice_epoch_fused(calc, cfg, kw, *args)
            zoo_calc.__dict__["fused"] = zoo_low
            zoo_fused = pallas_slice_v4.slice_epoch_fused(zoo_calc, cfg, kw, *args)
            b1 = pallas_slice_v4.slice_epoch(zoo_calc, cfg, kw, *args)
            mism.update(decisions(f"{tag}: the zoo Gaussian lowered differs from B1", [
                (f"{k}_zoo_fused_vs_B1", a, b) for k, a, b in zip(("t", "logL", "nlike"),
                                                                 zoo_fused, b1)]))
            traced = pallas_slice_v4.slice_epoch_traced(calc, cfg, kw, *args)
            against = {}
            for name, other in (("traced_route", traced), ("b1_functor", b1)):
                diff = (got[0] != other[0]) | (got[2] != other[2])
                lanes = torch.nonzero(diff.any(1)).flatten().tolist()
                listed = []
                for b in lanes:
                    r = int(torch.nonzero(diff[b]).flatten()[0])
                    listed.append({"lane": b, "repeat": r,
                                   "abs_logL_minus_bound": abs(float(got[1][b, r])
                                                               - float(args[1][b])),
                                   "other_abs_logL_minus_bound": abs(float(other[1][b, r])
                                                                     - float(args[1][b]))})
                against[name] = {"t_or_nlike_mismatches": int(diff.sum()),
                                 "lanes": len(lanes), "listed": listed[:50]}
            ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch_fused(calc, cfg, kw, *args), 5)  # noqa: B023
            ms_by_group = {g: cuda_ms(lambda g=g: pallas_slice_v4.slice_epoch_fused(  # noqa: B023
                calc, cfg, kw, *args, group=g), 5) for g in GROUPS}  # noqa: B023
            zoo_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch_fused(zoo_calc, cfg, kw, *args), 5)  # noqa: B023
            b1_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(zoo_calc, cfg, kw, *args), 5)  # noqa: B023
            traced_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch_traced(  # noqa: B023
                calc, cfg, kw, *args), 3)  # noqa: B023
            lane_max = int(steps.max())
            evals = int(want[2].sum())
            fused_refs[tag] = (calc, low, cfg, args, got, G, int(steps.to(torch.int64).sum()))
            out[tag] = {
                "B": B, "R": R, "D": D, "group": G, "valid_lanes": int(args[2].sum()),
                "evals": evals, "lowered": {"terms": low.n_terms, "term_ops": len(low.term),
                                            "combine_ops": len(low.combine),
                                            "consts": len(low.consts),
                                            "flops_per_probe": low.flops_per_probe()},
                "mismatches": mism, "decisions_against": against,
                "ms": ms, "ms_by_group": ms_by_group, "zoo_lowered_ms": zoo_ms, "b1_ms": b1_ms,
                "traced_ms": traced_ms, "plain_ms": plain_ms,
                "fused_over_b1": ms / b1_ms, "zoo_lowered_over_b1": zoo_ms / b1_ms,
                "traced_over_fused": traced_ms / ms,
                "lane_steps_max": lane_max, "us_per_micro_step": ms * 1e3 / lane_max,
                "evals_per_s": evals / (ms / 1e3), "build": builds[tag],
                "bound": bound(slice_epoch_bytes(B, R, D),
                               int(steps.to(torch.int64).sum()) * low.flops_per_probe()),
            }
        results["slice_fused"] = {**out["bench"], "max_abs_err": 0.0}
        return out

    # ---- 6d. the wide bucket (32 < D <= 128): B1 (functor and fused), B4
    # and B5 at every G it has, bitwise their plain versions and G = 32
    # slice_epoch_d128's plain versions by D (futures), which
    # slice_epoch_v5_buckets holds B3 to
    wide_plain = {}

    @phase("slice_epoch_d128")
    def _():
        out = {}
        kw = (0x01234567, 0x89ABCDEF)
        wide = pallas_slice_v4.BUCKET_GROUPS[pallas_slice_v4.SLICE_MAXD_WIDE]
        fused = {}
        for D in WIDE_DIMS:
            calc = make_batched_calculator(identity_prior, per_point_gaussian, D, 0, device=dev)
            low = fused_like.lowering(calc)
            if not isinstance(low, fused_like.Lowered):
                raise AssertionError(f"the {D}-D per-point Gaussian was not lowered: {low.reason}")
            fused[D] = (calc, low)
        t0 = time.perf_counter()  # every fused library of the phase, one nvcc each
        names = {low.library_name(G): low.source(G) for _, low in fused.values() for G in wide}
        nvcc.build_all({n: [fused_like.SOURCE] for n in names}, headers=names)
        fused_build = {"seconds": time.perf_counter() - t0,
                       "ptxas": {n: ptxas_summary(nvcc.build_log[n]) for n in names
                                 if n in nvcc.build_log}}
        with open(os.path.join(OUT, "ptxas.txt"), "a") as f:
            for n in names:
                if n in nvcc.build_log:
                    f.write(f"==== {n}\n{nvcc.build_log[n]}\n")
        ptx = results.get("ptxas_gaussian", {})
        for D in WIDE_DIMS:
            B, R = 512, 2 * D
            geo = dict(B=B, R=R, D=D, B_valid=RUN["B_valid"])
            calc, cfg, args = geometry(f"d{D}", geo)  # the zoo Gaussian, B2's directions
            pp_calc, low = fused[D]
            # the plain versions on the host, compared in plain_checks
            futs = {"B1": plain_later("v4", ("zoo", D), cfg, kw, args, count_steps=True),
                    "B4": plain_later("v3", ("zoo", D), cfg, kw, args),
                    "B5": plain_later("v2", ("zoo", D), cfg, kw, args),
                    "fused": plain_later("v4", low, cfg, kw, args, count_steps=True)}
            wide_plain[D] = futs
            kernels = {
                "B1": lambda G: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args, group=G),  # noqa: B023
                "B4": lambda G: pallas_slice_v3.slice_epoch_v3(calc, cfg, kw, *args, group=G),  # noqa: B023
                "B5": lambda G: pallas_slice.slice_epoch_v2(calc, cfg, kw, *args, group=G),  # noqa: B023
                "fused": lambda G: pallas_slice_v4.slice_epoch_fused(  # noqa: B023
                    pp_calc, cfg, kw, *args, group=G),  # noqa: B023
            }
            G_rule = pallas_slice_v4.choose_group(B, D, n_sm)
            rec = {"B": B, "R": R, "D": D, "valid_lanes": int(args[2].sum()), "group": G_rule}
            pairs, outs = [], {}
            for name, fn in kernels.items():
                g32 = fn(32)
                for G in wide:
                    got = fn(G)
                    outs[name, G] = tuple(x.cpu() for x in got)
                    pairs += [(f"{name}_{k}_G{G}_vs_G32", a, b)
                              for k, a, b in zip(("t", "logL", "nlike", "cube"), got, g32)]
                ms_by_group = {G: cuda_ms(lambda G=G: fn(G), 5) for G in wide}  # noqa: B023
                key = "128," + "{G}" + (",0" if name == "B1" else "")
                rec[name] = {
                    "ms": ms_by_group[G_rule], "ms_by_group": ms_by_group,
                    "ptxas_by_group": ({G: ptx.get(name, {}).get(key.format(G=G)) for G in wide}
                                       if name != "fused" else fused_build["ptxas"]),
                }
            rec["mismatches"] = decisions(f"d{D}: a wide-bucket kernel differs", pairs)
            rec["b1_bench_32_bucket_ms"] = results.get("slice_epoch", {}).get("ms")
            out[f"d{D}"] = rec

            def check(res, D=D, B=B, R=R, rec=rec, outs=outs, G_rule=G_rule, low=low):
                (want, steps), (pp_want, pp_steps) = ((r[0][:3], r[0][3]) for r in (
                    res["B1"], res["fused"]))
                refs = {"B1": want, "B4": res["B4"][0], "B5": res["B5"][0], "fused": pp_want}
                pairs = [(f"{name}_{k}_G{G}_vs_plain", a, b)
                         for (name, G), got in outs.items()
                         for k, a, b in zip(("t", "logL", "nlike", "cube"), got, refs[name])]
                if D > 32:  # the same decisions as B1's functor: B4 at the rule's G
                    pairs += [(f"B4_{k}_vs_B1", a, b) for k, a, b in zip(
                        ("t", "logL", "nlike"), outs["B4", G_rule], want)]
                rec["mismatches"].update(decisions(f"d{D}: a wide-bucket kernel differs "
                                                   "from its plain version", pairs))
                flops = int(steps.to(torch.int64).sum()) * gaussian_probe_flops(D)
                rec.update(evals=int(want[2].sum()), lane_steps_max=int(steps.max()))
                for name in refs:
                    rec[name].update(
                        plain_ms=res[name][1], plain_device="cpu",
                        bound=bound(slice_epoch_bytes(B, R, D, cube=name == "B5"),
                                    flops if name != "fused" else
                                    int(pp_steps.to(torch.int64).sum()) * low.flops_per_probe()),
                        us_per_micro_step=rec[name]["ms"] * 1e3 / int(steps.max()))
                return {"mismatches": rec["mismatches"], "lane_steps_max": int(steps.max())}

            check_later(f"slice_epoch_d128/d{D}", futs, check)
        # the fused route at the 64-D run's geometry (run_gaussian_d64: B =
        # 256, R = 128), at every G of the bucket, bitwise its plain version
        B, R, D = D64_RUN["B"], D64_RUN["R"], D64_RUN["D"]
        _, cfg, args = geometry("d64_run", D64_RUN)
        pp_calc, low = fused[D]
        futs = {"fused": plain_later("v4", low, cfg, kw, args, count_steps=True)}
        outs = {G: tuple(x.cpu() for x in pallas_slice_v4.slice_epoch_fused(
            pp_calc, cfg, kw, *args, group=G)) for G in wide}
        run_rec = out["d64_run_fused"] = {
            "B": B, "R": R, "D": D, "valid_lanes": int(args[2].sum()),
            "group": pallas_slice_v4.choose_group(B, D, n_sm),
            "ms": cuda_ms(lambda: pallas_slice_v4.slice_epoch_fused(pp_calc, cfg, kw, *args), 5),
        }

        def check_run(res, B=B, R=R, D=D, outs=outs, low=low, rec=run_rec):
            (out4, plain_ms) = res["fused"]
            want, steps = out4[:3], out4[3]
            rec.update(mismatches=decisions("d64_run: the fused kernel differs", [
                (f"fused_{k}_G{G}_vs_plain", a, b) for G, got in outs.items()
                for k, a, b in zip(("t", "logL", "nlike"), got, want)]),
                plain_ms=plain_ms, plain_device="cpu", lane_steps_max=int(steps.max()),
                bound=bound(slice_epoch_bytes(B, R, D),
                            int(steps.to(torch.int64).sum()) * low.flops_per_probe()))
            return {"mismatches": rec["mismatches"]}

        check_later("slice_epoch_d128/d64_run_fused", futs, check_run)
        out["fused_build"] = fused_build
        results["slice_epoch_d128"] = {**out["d64"], "d64_run_fused": out["d64_run_fused"]}
        return out

    # ---- 6e. the double kernels (precision='highest'): B1's fused route on
    # gaussian.ini's likelihood per point in torch, the traced route on a
    # model the lowering refuses, and B2 narrow and wide, each bitwise its
    # float64 plain version and timed beside its float32 twin on the same
    # (rounded) inputs
    def vector_norm_gaussian(theta):
        """A normalised Gaussian (mu 0.5, sigma 0.1) written with
        torch.linalg.vector_norm, outside the lowering's table."""
        D = theta.shape[-1]
        return (-D * (math.log(0.1) + 0.5 * math.log(2 * math.pi))
                - 0.5 * (torch.linalg.vector_norm(theta - 0.5, dim=-1) / 0.1) ** 2)

    def dtype_calc(like, n_dims, dtype, prior=identity_prior, n_derived=0):
        with real_dtype_scope(dtype):
            return make_batched_calculator(prior, like, n_dims, n_derived, device=dev)

    def f64_inputs(geo, calc64, calc32):
        """gaussian.ini's mid-run inputs (live_set_inputs) in float64, and
        the same values rounded to float32 with the float32 calc's bounds."""
        B, R, D = geo["B"], geo["R"], geo["D"]
        gen = torch.Generator(dev).manual_seed(SEED)
        x0, bnd, valid, chol = live_set_inputs(B, D, calc64, gen, B_valid=geo.get("B_valid", B))
        x0, chol = x0.double(), chol.double()
        nh, w, _ = make_directions(chol, grade_dims=(D,), num_repeats=(R,), n_dims=D,
                                   generator=gen)
        args64 = (x0, bnd, valid, nh, w)
        x32 = x0.float()
        args32 = (x32, bnd.float(), valid, nh.float(), w.float())
        return args64, args32

    def slice_epoch_bytes64(B: int, R: int, D: int) -> int:
        """slice_epoch_bytes with every float array in float64 (nlike int32)."""
        return 8 * (D * B + R * D * B + R * B + 2 * B + 2 * R * B) + 4 * R * B

    @phase("f64_kernels")
    def _():
        out = {"f64_flops_per_s": F64_FLOPS_PER_S}
        kw = (0x01234567, 0x89ABCDEF)
        # B2 in double: the thread-per-basis kernel at the bench and
        # gaussian.ini's bases, the wide kernel at (2, 64, 64, 512)
        # and at the 40-D run's bases
        for tag, shape in (("bench", (5, 20, 20, BENCH["B"])), ("gaussian_ini", (2, 20, 20, 512)),
                           ("wide_d64", (2, 64, 64, 512)),
                           ("wide_d40_run", (2, D40_RUN["D"], D40_RUN["D"], D40_RUN["B"]))):
            g = torch.randn(shape, generator=torch.Generator(dev).manual_seed(1), device=dev,
                            dtype=torch.float64)
            wide = shape[1] > pallas_dirs.NARROW_MAXD
            kernel = "gram_schmidt_wide_f64" if wide else "gram_schmidt_f64"
            q_plain, plain_ms = cuda_once(lambda: pallas_dirs.gram_schmidt_plain(g))  # noqa: B023
            before = pallas_dirs.LAUNCHES[kernel]
            q = pallas_dirs.gram_schmidt_lanes(g)
            if pallas_dirs.LAUNCHES[kernel] != before + 1 or q.dtype != torch.float64:
                raise AssertionError(f"gs {tag}: {kernel} was not the kernel launched")
            mism = int((q != q_plain).sum())
            if mism:
                raise AssertionError(f"gs {tag}: the double kernel differs from its plain "
                                     f"version in {mism} entries")
            qtq = torch.einsum("nikb,nijb->nkjb", q, q)
            orth = (qtq - torch.eye(shape[1], device=dev, dtype=torch.float64)[
                None, :, :, None]).abs().max().item()
            if not orth <= 1e-12:
                raise AssertionError(f"gs {tag}: max|QtQ - I| {orth:.3g}")
            g32 = g.float()
            nb, d, _, b = shape
            # the yardstick: one batched Householder QR of the same bases in
            # float64, once (the port never calls it)
            mats = g.permute(0, 3, 1, 2).reshape(-1, d, d).contiguous()
            out[f"gram_schmidt_{tag}"] = {
                "shape": list(shape), "kernel": kernel, "mismatches": mism, "orth_err": orth,
                "max_abs_err": (q - q_plain).abs().max().item(),
                "ms": cuda_ms(lambda: pallas_dirs.gram_schmidt_lanes(g), 20),  # noqa: B023
                "f32_twin_ms": cuda_ms(lambda: pallas_dirs.gram_schmidt_lanes(g32), 20),  # noqa: B023
                "plain_ms": plain_ms,
                "library_ms": cuda_once(lambda: torch.linalg.qr(mats))[1],  # noqa: B023
                "bound": bound(2 * 8 * nb * d * d * b, gram_schmidt_flops(nb, d, b), F64_FLOPS_PER_S),
            }
            if wide:
                nw, blocks = pallas_dirs.wide_blocks(nb, d, b, torch.float64)
                out[f"gram_schmidt_{tag}"].update(bases_a_block=nw, resident_warps=nw * blocks)
        # B1's fused route and the traced route in double, at gaussian.ini's
        # shape and the bench geometry
        calc64 = dtype_calc(per_point_gaussian, 20, torch.float64)
        calc32 = dtype_calc(per_point_gaussian, 20, torch.float32)
        vn64 = dtype_calc(vector_norm_gaussian, 20, torch.float64)
        vn32 = dtype_calc(vector_norm_gaussian, 20, torch.float32)
        low64, low32 = fused_like.lowering(calc64), fused_like.lowering(calc32)
        for low in (low64, low32):
            if not isinstance(low, fused_like.Lowered):
                raise AssertionError(f"gaussian.ini per point was not lowered: {low.reason}")
        for calc in (vn64, vn32):
            if not isinstance(fused_like.lowering(calc), fused_like.Refused):
                raise AssertionError("the vector_norm Gaussian was lowered")
        t0 = time.perf_counter()
        Gs = sorted({pallas_slice_v4.choose_group(g["B"], 20, n_sm) for g in (RUN, BENCH)})
        names = {low.library_name(G): low.source(G) for low in (low64, low32) for G in Gs}
        nvcc.build_all({n: [fused_like.SOURCE] for n in names}, headers=names)
        out["fused_build"] = {"seconds": time.perf_counter() - t0,
                              "ptxas": {n: ptxas_summary(nvcc.build_log[n]) for n in names
                                        if n in nvcc.build_log}}
        with open(os.path.join(OUT, "ptxas.txt"), "a") as f:
            for n in names:
                if n in nvcc.build_log:
                    f.write(f"==== {n}\n{nvcc.build_log[n]}\n")
        for tag, geo in (("gaussian_ini", RUN), ("bench", BENCH)):
            B, R, D = geo["B"], geo["R"], geo["D"]
            cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(R,))
            args64, args32 = f64_inputs(geo, calc64, calc32)
            res, plain_ms = cuda_once(lambda: slice_records_plain(  # noqa: B023
                low64.plain_logL, cfg, kw, *args64, count_steps=True))  # noqa: B023
            want, steps = res[:3], res[3]
            got = pallas_slice_v4.slice_epoch_fused(calc64, cfg, kw, *args64)
            if got[0].dtype != torch.float64:
                raise AssertionError(f"{tag}: the fused route did not run in double")
            pairs = [(f"fused_{k}_vs_plain", a, b) for k, a, b in zip(("t", "logL", "nlike"),
                                                                      got, want)]
            # the traced route in double on the refused model, its plain version
            # the plain engine on its calc
            vn_want, vn_plain_ms = cuda_once(lambda: slice_records_plain(  # noqa: B023
                lambda p: vn64(p)[2], cfg, kw, *args64))  # noqa: B023
            before = pallas_slice_v4.LAUNCHES["slice_step_f64"]
            vn_got = pallas_slice_v4.slice_epoch_traced(vn64, cfg, kw, *args64)
            step_launches = pallas_slice_v4.LAUNCHES["slice_step_f64"] - before
            pairs += [(f"traced_{k}_vs_plain", a, b) for k, a, b in zip(("t", "logL", "nlike"),
                                                                        vn_got, vn_want)]
            mism = decisions(f"{tag}: a double kernel differs from its plain version", pairs)
            errs = {k: max((a.double() - b.double()).abs().max().item() for a, b in
                           ((got[0], want[0]), (got[1], want[1]))) for k, got, want in
                    (("fused", got, want), ("traced", vn_got, vn_want))}
            G = pallas_slice_v4.choose_group(B, D, n_sm)
            evals = int(want[2].sum())
            ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch_fused(calc64, cfg, kw, *args64), 5)  # noqa: B023
            ms32 = cuda_ms(lambda: pallas_slice_v4.slice_epoch_fused(calc32, cfg, kw, *args32), 5)  # noqa: B023
            vn_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch_traced(vn64, cfg, kw, *args64), 3)  # noqa: B023
            vn_ms32 = cuda_ms(lambda: pallas_slice_v4.slice_epoch_traced(vn32, cfg, kw, *args32), 3)  # noqa: B023
            flops = int(steps.to(torch.int64).sum()) * low64.flops_per_probe()
            out[tag] = {
                "B": B, "R": R, "D": D, "group": G, "evals": evals, "mismatches": mism,
                "fused": {"ms": ms, "f32_twin_ms": ms32, "plain_ms": plain_ms,
                          "max_abs_err": errs["fused"],
                          "lane_steps_max": int(steps.max()),
                          "us_per_micro_step": ms * 1e3 / int(steps.max()),
                          "bound": bound(slice_epoch_bytes64(B, R, D), flops, F64_FLOPS_PER_S)},
                "traced": {"ms": vn_ms, "f32_twin_ms": vn_ms32, "plain_ms": vn_plain_ms,
                           "max_abs_err": errs["traced"],
                           "launches_per_epoch": step_launches,
                           "route_reason": fused_like.lowering(vn64).reason,
                           "bound": bound(slice_step_bytes(B, D, step_launches, R, real=8), 0,
                                          F64_FLOPS_PER_S)},
            }
        # the traced route in double at the 40-D run's geometry
        # (run_traced_highest_d40), its directions through B2's wide kernel
        B, R, D = D40_RUN["B"], D40_RUN["R"], D40_RUN["D"]
        vn64, vn32 = (dtype_calc(vector_norm_gaussian, D, dt)
                      for dt in (torch.float64, torch.float32))
        cfg = EpochConfig(n_dims=D, n_phi=vn64.n_phi, grade_dims=(D,), num_repeats=(R,))
        args64, args32 = f64_inputs(D40_RUN, vn64, vn32)
        want, plain_ms = cuda_once(lambda: slice_records_plain(
            lambda p: vn64(p)[2], cfg, kw, *args64))
        before = pallas_slice_v4.LAUNCHES["slice_step_f64"]
        got = pallas_slice_v4.slice_epoch_traced(vn64, cfg, kw, *args64)
        step_launches = pallas_slice_v4.LAUNCHES["slice_step_f64"] - before
        mism = decisions("d40_run: the double traced route differs from its plain version",
                         [(f"traced_{k}_vs_plain", a, b)
                          for k, a, b in zip(("t", "logL", "nlike"), got, want)])
        out["d40_run"] = {
            "B": B, "R": R, "D": D, "valid_lanes": int(args64[2].sum()), "mismatches": mism,
            "traced": {
                "ms": cuda_ms(lambda: pallas_slice_v4.slice_epoch_traced(
                    vn64, cfg, kw, *args64), 3),
                "f32_twin_ms": cuda_ms(lambda: pallas_slice_v4.slice_epoch_traced(
                    vn32, cfg, kw, *args32), 3),
                "plain_ms": plain_ms, "launches_per_epoch": step_launches,
                "max_abs_err": max((a - b).abs().max().item()
                                   for a, b in zip(got[:2], want[:2])),
                "bound": bound(slice_step_bytes(B, D, step_launches, R, real=8), 0,
                               F64_FLOPS_PER_S)},
        }
        results["f64_kernels"] = out
        return out

    # ---- 6f. the ring engine (engine="ring"): B1 under RingPolicy (the
    # functor kernel on the zoo Gaussian, the fused route on gaussian.ini's
    # likelihood in torch) and the traced route under the ring's budget (the
    # vector_norm Gaussian), each bitwise its plain version with the
    # overflow flags, at gaussian.ini's shape and the bench at ring_factor
    # 12, and at gaussian.ini's shape at ring_factor 2, where lanes
    # overflow; there the ring's epoch re-run (build_epoch_fn's rerun, on
    # the same directions) is the "cuda" epoch bit for bit, each route
    def ring_bytes(B, R, D):
        """slice_epoch_bytes and the (B,) int32 flags written."""
        return slice_epoch_bytes(B, R, D) + 4 * B

    @phase("ring_epoch")
    def _():
        from polychordlite_tpu_torch.ops.slice_kernel import build_epoch_fn, epoch_overflowed

        t0 = time.perf_counter()
        ring_build["job"].result()  # raises if the library did not build
        log = nvcc.build_log.get(RING_LIBRARY, "")
        with open(os.path.join(OUT, "ptxas.txt"), "a") as f:
            f.write(f"==== {RING_LIBRARY}\n{log}\n")
        kw = (0x0BADCAFE, 0x600DF00D)
        out = {"library": {
            "wait_s": time.perf_counter() - t0,
            "build_s": nvcc.build_seconds[RING_LIBRARY], "ptxas": ptxas_summary(log),
            "gaussian_kernels_by_group": ptxas_kernels(
                log, r"slice_epoch_kernelI10RingPolicy12GaussianLikeILi(32|128|0)EELi(\d+)ELb0E")}}
        wrappers = {"functor": pallas_slice_v4.slice_epoch,
                    "fused": pallas_slice_v4.slice_epoch_fused,
                    "traced": pallas_slice_v4.slice_epoch_traced}
        for tag, geo, factors in (("gaussian_ini", RUN, (12, 2)), ("bench", BENCH, (12,))):
            B, R, D = geo["B"], geo["R"], geo["D"]
            zoo, cfg, args = geometry(tag, geo)
            tcalc = make_batched_calculator(identity_prior, torch_gaussian(D), D, 2, device=dev)
            vcalc = make_batched_calculator(identity_prior, vector_norm_gaussian, D, 0,
                                            device=dev)
            low = fused_like.lowering(tcalc)
            G = pallas_slice_v4.choose_group(B, D, n_sm)
            t0 = time.perf_counter()
            low.build([G], ring=True)
            build_s = time.perf_counter() - t0
            models = {"functor": (zoo, lambda p: zoo(p)[2], gaussian_probe_flops(D)),
                      "fused": (tcalc, low.plain_logL, low.flops_per_probe()),
                      "traced": (vcalc, lambda p: vcalc(p)[2], None)}
            for rf in factors:
                c = cfg._replace(ring_factor=rf)
                cap = c.ring_budget
                for route, (calc, plain_fn, flops) in models.items():
                    wrap = wrappers[route]
                    res, plain_ms = cuda_once(lambda: slice_records_plain(  # noqa: B023
                        plain_fn, c, kw, *args, count_steps=True, ring_cap=cap))  # noqa: B023
                    want, steps = res[:3] + res[4:], res[3]
                    groups = GROUPS if (route == "functor" and tag == "gaussian_ini") else (G,)
                    pairs = []
                    for g in groups:
                        extra = {} if route == "traced" else {"group": g}
                        got = wrap(calc, c, kw, *args, ring_cap=cap, **extra)
                        pairs += [(f"{k}_G{g}_vs_plain", a, b) for k, a, b in zip(
                            ("t", "logL", "nlike", "overflow"), got, want)]
                    mism = decisions(f"{tag} ring_factor {rf}: the ring's {route} differs "
                                     "from its plain version", pairs)
                    rec = {"B": B, "R": R, "D": D, "ring_factor": rf, "budget": cap,
                           "group": G, "valid_lanes": int(args[2].sum()),
                           "lanes_overflowed": int(want[3].sum()),
                           "slowest_lane_steps": int(steps.max()), "mismatches": mism,
                           "plain_ms": plain_ms}
                    if rf == 12:  # timed, beside the same route at its own budget
                        before = dict(pallas_slice_v4.LAUNCHES)
                        rec["ms"] = cuda_ms(lambda: wrap(calc, c, kw, *args,  # noqa: B023
                                                         ring_cap=cap), 3)  # noqa: B023
                        rec["launches_per_epoch"] = {
                            k: (v - before[k]) // 4 for k, v in pallas_slice_v4.LAUNCHES.items()
                            if v > before[k]}
                        rec["route_ms"] = cuda_ms(lambda: wrap(calc, c, kw, *args), 3)  # noqa: B023
                        n_launch = sum(rec["launches_per_epoch"].values())
                        rec["bound"] = (bound(slice_step_bytes(B, D, n_launch, R) + 4 * B, 0)
                                        if flops is None else
                                        bound(ring_bytes(B, R, D),
                                              int(steps.to(torch.int64).sum()) * flops))
                    else:  # the re-run of the starved epoch is the "cuda" epoch
                        if not want[3].any():
                            raise AssertionError(f"{route}: no lane overflowed at ring_factor "
                                                 f"{rf}")
                        chol = (0.1 * torch.eye(D, device=dev)).expand(B, D, D)
                        dirs = (args[3], args[4], torch.zeros((B, R), dtype=torch.int64,
                                                              device=dev))
                        ep_in = (kw, args[0], args[1], chol, args[2])
                        cm = c._replace(n_phi=calc.n_phi)
                        ring_ep = build_epoch_fn(calc, cm._replace(engine="ring"))
                        cuda_ep = build_epoch_fn(calc, cm._replace(engine="cuda"))
                        flagged = ring_ep(*ep_in, directions=dirs)
                        again = ring_ep(*ep_in, directions=dirs, rerun=True)
                        ref = cuda_ep(*ep_in, directions=dirs)
                        if not epoch_overflowed(flagged) or epoch_overflowed(again):
                            raise AssertionError(f"{route}: the packed flags are wrong")
                        rec["rerun_vs_cuda_mismatches"] = int((again != ref).sum())
                        if rec["rerun_vs_cuda_mismatches"]:
                            raise AssertionError(f"{route}: the re-run differs from the "
                                                 "cuda epoch")
                    out[f"{tag}/rf{rf}/{route}"] = rec
            out[f"{tag}/fused_ring_build_s"] = build_s
        results["ring_epoch"] = out
        return out

    # ---- 6e'. the stream bucket (D > 128): B1's functor kernel (the zoo
    # Gaussian and random_gaussian), the fused route (float32, and float64
    # at D = 160), the traced route (float32 and float64 at D = 160), B4 and
    # B5, at B = 512 chains: bitwise their plain versions at R = 4 (B1 also
    # as a shard at lane0 = 256), each kernel alone timed at R = 2 D with
    # CUDA events (random_gaussian there at D = 160 only: its D^2 combine on
    # every lane takes seconds an epoch at 512), the plain versions at R = 4
    def fast_random_gaussian(like, logzero):
        """The logL of random_gaussian's calc under the identity prior (its
        torch form a D x D double loop of scalar operations, D^2 launches a
        call) vectorised over the rows in the same order: row_i accumulates
        d_j M_ij over j, then q over i; the same rounded operations, and the
        calc's logzero outside [0, 1]^D or at a NaN, so the same logL bit for
        bit (checked against the calc)."""
        form = like.device_form
        M = torch.tensor(np.asarray(form["invcov"], np.float32), device=dev)
        M = M.reshape(int(math.isqrt(M.numel())), -1)
        mu, norm = float(form["mu"]), float(form["norm"])

        def fast(cube):
            d = cube - mu
            row = torch.zeros_like(d)
            for j in range(d.shape[1]):
                row = row + d[:, j:j + 1] * M[:, j]
            quad = torch.zeros_like(d[:, 0])
            for i in range(d.shape[1]):
                quad = quad + d[:, i] * row[:, i]
            logL = norm - 0.5 * quad
            zero = torch.full_like(logL, logzero)
            inside = ((cube >= 0.0) & (cube <= 1.0)).all(dim=1)
            return torch.where(inside & ~torch.isnan(logL), logL, zero)
        return fast

    def stream_inputs(logL, B, R, D, seed, dtype=torch.float32, width=0.2):
        """Seeds at 0.5 +- 0.05, each lane's contour 2 below its seed's logL,
        the first B / 8 lanes invalid, unit directions (B2 is held apart) and
        widths ``width``."""
        gen = torch.Generator(dev).manual_seed(seed)
        x0 = (0.5 + 0.05 * torch.randn((B, D), generator=gen, device=dev, dtype=dtype)).clamp(0, 1)
        nh = torch.randn((B, R, D), generator=gen, device=dev, dtype=dtype)
        return (x0, logL(x0) - 2.0, torch.arange(B, device=dev) >= B // 8,
                nh / nh.norm(dim=2, keepdim=True),
                torch.full((B, R), width, device=dev, dtype=dtype))

    @phase("slice_epoch_d512")
    def _():
        out = {}
        kw = (0x01234567, 0x89ABCDEF)
        B = STREAM_B
        stream = pallas_slice_v4.STREAM
        counts0 = {"B1": pallas_slice_v4.LAUNCHES["slice_epoch"],
                   "B4": pallas_slice_v3.GROUP_LAUNCHES[stream, 32],
                   "B5": pallas_slice.GROUP_LAUNCHES[stream, 32],
                   **{k: pallas_slice_v4.LAUNCHES[k] for k in (
                       "slice_epoch_fused", "slice_epoch_fused_f64", "slice_step",
                       "slice_step_f64")}}
        fused = {}
        for D in STREAM_DIMS:
            for dt in (torch.float32, torch.float64) if D == STREAM_DIMS[0] else (torch.float32,):
                calc = dtype_calc(per_point_gaussian, D, dt)
                low = fused_like.lowering(calc)
                if not isinstance(low, fused_like.Lowered):
                    raise AssertionError(f"the {D}-D per-point Gaussian was not lowered: "
                                         f"{low.reason}")
                if "#define FUSED_MAXD SLICE_MAXD_STREAM" not in low.source(32):
                    raise AssertionError(f"the {D}-D lowering does not name the stream bucket")
                fused[D, dt] = (calc, low)
        # ... and the 160-D run's model (run_gaussian_d160), held at its geometry
        run_calc = dtype_calc(d160_gaussian, D160["nDims"], torch.float32)
        run_low = fused_like.lowering(run_calc)
        if not isinstance(run_low, fused_like.Lowered):
            raise AssertionError(f"the 160-D run's model was not lowered: {run_low.reason}")
        t0 = time.perf_counter()  # every fused library of the phase, one nvcc each
        names = {low.library_name(32): low.source(32)
                 for _, low in list(fused.values()) + [(run_calc, run_low)]}
        nvcc.build_all({n: [fused_like.SOURCE] for n in names}, headers=names)
        fused_build = {"seconds": time.perf_counter() - t0,
                       "ptxas": {n: ptxas_summary(nvcc.build_log[n]) for n in names
                                 if n in nvcc.build_log}}
        with open(os.path.join(OUT, "ptxas.txt"), "a") as f:
            for n in names:
                if n in nvcc.build_log:
                    f.write(f"==== {n}\n{nvcc.build_log[n]}\n")
        ptx = results.get("ptxas_gaussian", {})
        f32, f64 = torch.float32, torch.float64
        for D in STREAM_DIMS:
            zoo = make_batched_calculator(identity_prior, gaussian(D), D, 2, device=dev)
            rg_like = random_gaussian(D)
            rg = make_batched_calculator(identity_prior, rg_like, D, 0, device=dev)
            rg_fast = fast_random_gaussian(rg_like, rg.logzero)
            probe = 0.5 + 0.1 * torch.randn((256, D), generator=torch.Generator(dev)
                                            .manual_seed(D), device=dev)
            probe[:128] = probe[:128].clamp(0, 1)  # the others partly outside the cube
            if not torch.equal(rg(probe)[2], rg_fast(probe)):
                raise AssertionError(f"d{D}: the vectorised random_gaussian differs from its "
                                     "torch form")
            models = {"B1": zoo, "B1_random_gaussian": rg, "B4": zoo, "B5": zoo,
                      "fused": fused[D, f32][0],
                      "traced": dtype_calc(vector_norm_gaussian, D, f32)}
            plains = {"B1_random_gaussian": rg_fast,
                      "fused": fused[D, f32][1].plain_logL}
            if D == STREAM_DIMS[0]:
                models["fused_f64"] = fused[D, f64][0]
                models["traced_f64"] = dtype_calc(vector_norm_gaussian, D, f64)
                plains["fused_f64"] = fused[D, f64][1].plain_logL
            rec = {"B": B, "D": D, "R_checked": 4, "R_timed": 2 * D}
            pairs = []
            for name, calc in models.items():
                dt = calc.dtype
                logL = plains.get(name, lambda p, c=calc: c(p)[2])
                kernel = {
                    "B1": lambda c, a: pallas_slice_v4.slice_epoch(zoo, c, kw, *a),  # noqa: B023
                    "B1_random_gaussian": lambda c, a: pallas_slice_v4.slice_epoch(  # noqa: B023
                        rg, c, kw, *a),  # noqa: B023
                    "B4": lambda c, a: pallas_slice_v3.slice_epoch_v3(zoo, c, kw, *a),  # noqa: B023
                    "B5": lambda c, a: pallas_slice.slice_epoch_v2(zoo, c, kw, *a),  # noqa: B023
                }.get(name)
                if kernel is None and name.startswith("fused"):
                    kernel = lambda c, a, m=calc: pallas_slice_v4.slice_epoch_fused(  # noqa: E731
                        m, c, kw, *a)
                elif kernel is None:
                    kernel = lambda c, a, m=calc: pallas_slice_v4.slice_epoch_traced(  # noqa: E731
                        m, c, kw, *a)
                plain = {"B4": lambda c, a, f=logL: pallas_slice_v3.slice_records_window_plain(
                             f, c, kw, *a),
                         "B5": lambda c, a, f=logL: pallas_slice.slice_records_lockstep_plain(
                             f, c, kw, *a)}.get(
                    name, lambda c, a, f=logL: slice_records_plain(f, c, kw, *a))
                cfg4 = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(4,))
                a4 = stream_inputs(logL, B, 4, D, SEED + D, dt)
                want, plain_ms = cuda_once(lambda: plain(cfg4, a4))  # noqa: B023
                got = kernel(cfg4, a4)
                keys = ("t", "logL", "nlike", "cube")
                pairs += [(f"{name}_{k}_vs_plain", x, y) for k, x, y in zip(keys, got, want)]
                if name == "B1":  # the second half of the batch as a shard
                    half = B // 2
                    shard = pallas_slice_v4.slice_epoch(zoo, cfg4, kw, *(x[half:] for x in a4),
                                                        lane0=half)
                    pairs += [(f"B1_{k}_lane0_{half}_vs_whole", x, y[half:])
                              for k, x, y in zip(keys, shard, got)]
                r = {"ms_r4": cuda_ms(lambda: kernel(cfg4, a4), 3),  # noqa: B023
                     "plain_ms": plain_ms, "dtype": str(dt).replace("torch.", ""),
                     "evals_r4": int(want[2].sum()),
                     "max_abs_err": max((x.double() - y.double()).abs().max().item()
                                        for x, y in zip(got[:2], want[:2]))}
                if name != "B1_random_gaussian" or D == STREAM_DIMS[0]:
                    R = 2 * D
                    cfgT = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,),
                                       num_repeats=(R,))
                    aT = stream_inputs(logL, B, R, D, SEED + D + 1, dt)
                    evals = int(kernel(cfgT, aT)[2].to(torch.int64).sum())
                    r["ms"] = cuda_ms(lambda: kernel(cfgT, aT), 2)  # noqa: B023
                    del aT
                else:
                    R, evals = 4, r["evals_r4"]
                    r["ms"] = r["ms_r4"]
                per_probe = (2 * D * D + 8 * D + 7 if name == "B1_random_gaussian" else
                             fused[D, dt][1].flops_per_probe() if name.startswith("fused")
                             else gaussian_probe_flops(D))
                real = 8 if dt == f64 else 4
                r.update(R=R, evals=evals, bound=bound(
                    slice_epoch_bytes(B, R, D, cube=name == "B5") * real // 4, evals * per_probe,
                    F64_FLOPS_PER_S if dt == f64 else F32_FLOPS_PER_S))
                if name in ("B1", "B4", "B5"):
                    r["ptxas"] = ptx.get(name, {}).get("0,32" + (",0" if name == "B1" else ""))
                elif name.startswith("fused"):
                    r["ptxas"] = fused_build["ptxas"].get(fused[D, dt][1].library_name(32))
                rec[name] = r
            rec["mismatches"] = decisions(f"d{D}: a stream-bucket kernel differs", pairs)
            out[f"d{D}"] = rec
        # the fused route at the 160-D run's geometry (run_gaussian_d160: B =
        # 256, 200 valid, R = 800) on the run's model, as run() feeds it
        # mid-run (live_set_inputs, B2's long kernel drawing the directions),
        # bitwise its plain version
        B, R, D = D160_RUN["B"], D160_RUN["R"], D160_RUN["D"]
        gen = torch.Generator(dev).manual_seed(SEED)
        x0, bnd, valid, chol = live_set_inputs(B, D, run_calc, gen, nlive=D160["nlive"],
                                               B_valid=D160_RUN["B_valid"])
        cfg = EpochConfig(n_dims=D, n_phi=run_calc.n_phi, grade_dims=(D,), num_repeats=(R,))
        nh, w, _ = make_directions(chol, grade_dims=(D,), num_repeats=(R,), n_dims=D,
                                   generator=gen)
        args = (x0, bnd, valid, nh, w)
        futs = {"fused": plain_later("v4", run_low, cfg, kw, args, count_steps=True)}
        got = tuple(x.cpu() for x in pallas_slice_v4.slice_epoch_fused(run_calc, cfg, kw, *args))
        run_rec = out["d160_run_fused"] = {
            "B": B, "R": R, "D": D, "valid_lanes": int(valid.sum()), "evals": int(got[2].sum()),
            "ms": cuda_ms(lambda: pallas_slice_v4.slice_epoch_fused(run_calc, cfg, kw, *args), 3),
            "ptxas": fused_build["ptxas"].get(run_low.library_name(32)),
        }

        def check_run(res, B=B, R=R, D=D, got=got, rec=run_rec):
            out4, plain_ms = res["fused"]
            want, steps = out4[:3], out4[3]
            rec.update(
                mismatches=decisions("d160_run: the fused kernel differs", [
                    (f"fused_{k}_vs_plain", a, b) for k, a, b in zip(("t", "logL", "nlike"),
                                                                      got, want)]),
                max_abs_err=max((a.double() - b.double()).abs().max().item()
                                for a, b in zip(got[:2], want[:2])),
                plain_ms=plain_ms, plain_device="cpu", lane_steps_max=int(steps.max()),
                bound=bound(slice_epoch_bytes(B, R, D),
                            int(steps.to(torch.int64).sum()) * run_low.flops_per_probe()))
            return {"mismatches": rec["mismatches"]}

        check_later("slice_epoch_d512/d160_run_fused", futs, check_run)
        del args, nh, w
        # at the bucket's bound (float32, one term): 232,440 of a block's
        # 232,448 bytes, past the 48 KB a launch gets without the attribute
        D = pallas_slice_v4.stream_max_d(1, torch.float32)
        zoo = make_batched_calculator(identity_prior, gaussian(D, sigma=0.2), D, 2, device=dev)
        cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(2,))
        a = stream_inputs(lambda p: zoo(p)[2], 64, 2, D, SEED, width=0.02)
        got = pallas_slice_v4.slice_epoch(zoo, cfg, kw, *a)
        want = slice_records_plain(lambda p: zoo(p)[2], cfg, kw, *a)
        out[f"d{D}_bound"] = {
            "B": 64, "R": 2, "smem_bytes": 3 * D * 4, "evals": int(want[2].sum()),
            "ms": cuda_ms(lambda: pallas_slice_v4.slice_epoch(zoo, cfg, kw, *a), 3),
            "mismatches": decisions(f"d{D}: B1 at the bucket's bound differs", [
                (f"B1_{k}_vs_plain", x, y) for k, x, y in zip(("t", "logL", "nlike"), got, want)])}
        out["fused_build"] = fused_build
        out["launches"] = {
            "B1": pallas_slice_v4.LAUNCHES["slice_epoch"] - counts0["B1"],
            "B4": pallas_slice_v3.GROUP_LAUNCHES[stream, 32] - counts0["B4"],
            "B5": pallas_slice.GROUP_LAUNCHES[stream, 32] - counts0["B5"],
            **{k: pallas_slice_v4.LAUNCHES[k] - counts0[k] for k in (
                "slice_epoch_fused", "slice_epoch_fused_f64", "slice_step", "slice_step_f64")}}
        results["slice_epoch_d512"] = out
        return out

    # ---- 6e'. B3 above D = 32 (a chain on a whole warp, the four slots in
    # turn) and the forced engines' fused routes (B3, B4, B5 with a torch
    # likelihood lowered into them)
    @phase("slice_epoch_v5_buckets")
    def _():
        """B3 in the wide bucket at slice_epoch_d128's d64 geometry (B 512, R
        128, D 64, the zoo Gaussian, B2's directions) and in the stream bucket
        at D = 160 (B 512; slice_epoch_d512's inputs, checked at R = 4 and
        timed at R = 320), at the buckets' one G: bitwise its plain version
        (on the host, plain_checks) and B1 on the same inputs; ms beside B1's,
        registers, resident warps, bound."""
        out = {}
        kw = (0x01234567, 0x89ABCDEF)
        ptx = results.get("ptxas_gaussian", {}).get("B3", {})
        counts0 = dict(pallas_slice_v5.GROUP_LAUNCHES)
        D, B, R = 64, 512, 128
        calc, cfg, args = geometry(f"d{D}", dict(B=B, R=R, D=D, B_valid=RUN["B_valid"]))
        G = pallas_slice_v5.packet_group_for(calc, B, D, dev)
        if G != 32:
            raise AssertionError(f"B3 picks G = {G} at D = {D}, not 32")
        got = pallas_slice_v5.slice_epoch_v5(calc, cfg, kw, *args)
        b1 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
        wide = out["d64"] = {
            "B": B, "R": R, "D": D, "group": G, "valid_lanes": int(args[2].sum()),
            "evals": int(got[2].sum()),
            "mismatches": decisions("d64: B3 differs from B1", [
                (f"B3_{k}_vs_B1", a, b) for k, a, b in zip(("t", "logL", "nlike"), got, b1)]),
            "ms": cuda_ms(lambda: pallas_slice_v5.slice_epoch_v5(calc, cfg, kw, *args), 5),
            "b1_ms": cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args), 5),
            "ptxas": ptx.get("128,32"), "resident_warps": pallas_slice_v5.resident_warps(
                calc, D, dev, G)}
        got = tuple(x.cpu() for x in got)

        def check_wide(res, rec=wide, got=got, D=D, B=B, R=R):
            want, plain_ms = res["v5"]
            b1_plain, steps = res["B1"][0][:3], res["B1"][0][3]
            rec["mismatches"].update(decisions("d64: B3 differs from its plain version", [
                (f"B3_{k}_vs_plain", a, b) for k, a, b in zip(("t", "logL", "nlike"), got, want)]
                + [(f"plain_{k}_vs_B1_plain", a, b) for k, a, b in zip(
                    ("t", "logL", "nlike"), want, b1_plain)]))
            rec.update(plain_ms=plain_ms, plain_device="cpu",
                       max_abs_err=max((a.double() - b.double()).abs().max().item()
                                       for a, b in zip(got[:2], want[:2])),
                       bound=bound(slice_epoch_bytes(B, R, D),
                                   int(steps.to(torch.int64).sum()) * gaussian_probe_flops(D)))
            return {"mismatches": rec["mismatches"]}

        check_later("slice_epoch_v5_buckets/d64",
                    {"v5": plain_later("v5", ("zoo", D), cfg, kw, args), "B1": wide_plain[D]["B1"]},
                    check_wide)
        # the stream bucket at D = 160: checked at R = 4, timed at R = 2 D
        D, B = STREAM_DIMS[0], STREAM_B
        zoo = make_batched_calculator(identity_prior, gaussian(D), D, 2, device=dev)
        logL = lambda p: zoo(p)[2]  # noqa: E731
        cfg4 = EpochConfig(n_dims=D, n_phi=zoo.n_phi, grade_dims=(D,), num_repeats=(4,))
        a4 = stream_inputs(logL, B, 4, D, SEED + D)
        got = pallas_slice_v5.slice_epoch_v5(zoo, cfg4, kw, *a4)
        b1 = pallas_slice_v4.slice_epoch(zoo, cfg4, kw, *a4)
        R = 2 * D
        cfgT = EpochConfig(n_dims=D, n_phi=zoo.n_phi, grade_dims=(D,), num_repeats=(R,))
        aT = stream_inputs(logL, B, R, D, SEED + D + 1)
        evals = int(pallas_slice_v5.slice_epoch_v5(zoo, cfgT, kw, *aT)[2].to(torch.int64).sum())
        stream = out[f"d{D}"] = {
            "B": B, "D": D, "R": R, "R_checked": 4, "group": pallas_slice_v5.packet_group_for(
                zoo, B, D, dev), "evals": evals,
            "mismatches": decisions(f"d{D}: B3 differs from B1", [
                (f"B3_{k}_vs_B1", a, b) for k, a, b in zip(("t", "logL", "nlike"), got, b1)]),
            "ms_r4": cuda_ms(lambda: pallas_slice_v5.slice_epoch_v5(zoo, cfg4, kw, *a4), 3),
            "ms": cuda_ms(lambda: pallas_slice_v5.slice_epoch_v5(zoo, cfgT, kw, *aT), 2),
            "b1_ms": cuda_ms(lambda: pallas_slice_v4.slice_epoch(zoo, cfgT, kw, *aT), 2),
            "bound": bound(slice_epoch_bytes(B, R, D), evals * gaussian_probe_flops(D)),
            "ptxas": ptx.get("0,32"), "resident_warps": pallas_slice_v5.resident_warps(
                zoo, D, dev, 32)}
        del aT
        got = tuple(x.cpu() for x in got)

        def check_stream(res, rec=stream, got=got, D=D):
            want, plain_ms = res["v5"]
            rec["mismatches"].update(decisions(f"d{D}: B3 differs from its plain version", [
                (f"B3_{k}_vs_plain", a, b) for k, a, b in zip(("t", "logL", "nlike"), got,
                                                                 want)]))
            rec.update(plain_ms=plain_ms, plain_device="cpu", plain_at_R=4,
                       max_abs_err=max((a.double() - b.double()).abs().max().item()
                                       for a, b in zip(got[:2], want[:2])))
            return {"mismatches": rec["mismatches"]}

        check_later(f"slice_epoch_v5_buckets/d{D}",
                    {"v5": plain_later("v5", ("zoo", D), cfg4, kw, a4)}, check_stream)
        out["launches"] = {"/".join(map(str, k)): v - counts0[k]
                           for k, v in pallas_slice_v5.GROUP_LAUNCHES.items() if v > counts0[k]}
        results["slice_epoch_v5_buckets"] = out
        return out

    @phase("slice_forced_fused")
    def _():
        """The forced engines' fused routes on gaussian.ini's likelihood in
        torch (slice_fused's model, lowering and inputs) at gaussian.ini's
        shape and the bench: B3 (FUSED_V5) at every G of its groups (whose
        resident warps its launch rule reads), B4 (FUSED_V3) and B5
        (FUSED_V2) at B1's G, their libraries built behind the earlier
        phases (forced_prebuild); bitwise their plain versions on
        Lowered.plain_logL (on the host, plain_checks), B3 and B4 also
        B1's fused route on the same inputs; each timed at its rule's G
        beside B1's fused route."""
        out = {}
        kw = (0x01234567, 0x89ABCDEF)
        low = fused_refs["bench"][1]
        t0 = time.perf_counter()
        prebuilt = ring_build["forced"].result()  # raises if a library did not build
        G_rule = {tag: fused_refs[tag][5] for tag in fused_refs}
        names = {low.library_name(g, e): low.source(g, e) for e, gs in (
            ("cuda5", pallas_slice_v5.PACKET_GROUPS), ("cuda3", set(G_rule.values())),
            ("cuda2", set(G_rule.values()))) for g in gs}
        nvcc.build_all({n: [fused_like.SOURCE] for n in names}, headers=names)
        out["build"] = {"wait_s": time.perf_counter() - t0, "prebuilt": prebuilt,
                        "ptxas": {n: ptxas_summary(nvcc.build_log[n]) for n in names
                                  if n in nvcc.build_log}}
        with open(os.path.join(OUT, "ptxas.txt"), "a") as f:
            for n in names:
                if n in nvcc.build_log:
                    f.write(f"==== {n}\n{nvcc.build_log[n]}\n")
        for tag in ("gaussian_ini", "bench"):
            calc, low, cfg, args, b1_fused, G1, steps_sum = fused_refs[tag]
            B, R, D = args[0].shape[0], cfg.total_repeats, cfg.n_dims
            G5 = pallas_slice_v5.packet_group_for(calc, B, D, dev)
            kernels = {
                "B3": (lambda g: pallas_slice_v5.slice_epoch_v5(  # noqa: B023
                    calc, cfg, kw, *args, group=g), pallas_slice_v5.PACKET_GROUPS, G5, "v5"),  # noqa: B023
                "B4": (lambda g: pallas_slice_v3.slice_epoch_v3(  # noqa: B023
                    calc, cfg, kw, *args, group=g), (G1,), G1, "v3"),  # noqa: B023
                "B5": (lambda g: pallas_slice.slice_epoch_v2(  # noqa: B023
                    calc, cfg, kw, *args, group=g), (G1,), G1, "v2"),  # noqa: B023
            }
            futs = {name: plain_later(plain, low, cfg, kw, args)
                    for name, (_, _, _, plain) in kernels.items()}
            rec = {"B": B, "R": R, "D": D, "valid_lanes": int(args[2].sum()),
                   "b1_fused_group": G1}
            pairs, outs = [], {}
            for name, (fn, gs, G, _) in kernels.items():
                for g in gs:
                    got = fn(g)
                    outs[name, g] = tuple(x.cpu() for x in got)
                    if name != "B5":  # B1's decisions, bit for bit
                        pairs += [(f"{name}_{k}_G{g}_vs_B1_fused", a, b) for k, a, b in zip(
                            ("t", "logL", "nlike"), got, b1_fused)]
                ms_by_group = {g: cuda_ms(lambda g=g: fn(g), 5) for g in gs}  # noqa: B023
                rec[name] = {"group": G, "ms": ms_by_group[G], "ms_by_group": ms_by_group,
                             "bound": bound(slice_epoch_bytes(B, R, D, cube=name == "B5"),
                                            steps_sum * low.flops_per_probe())}
            rec["b1_fused_ms"] = cuda_ms(lambda: pallas_slice_v4.slice_epoch_fused(  # noqa: B023
                calc, cfg, kw, *args, group=G1), 5)  # noqa: B023
            rec["mismatches"] = decisions(f"{tag}: a forced engine's fused route differs "
                                          "from B1's", pairs)
            out[tag] = rec

            def check(res, tag=tag, rec=rec, outs=outs):
                pairs = [(f"{name}_{k}_G{g}_vs_plain", a, b)
                         for (name, g), got in outs.items()
                         for k, a, b in zip(("t", "logL", "nlike", "cube"), got, res[name][0])]
                rec["mismatches"].update(decisions(
                    f"{tag}: a forced engine's fused route differs from its plain version", pairs))
                for name in res:
                    got, want = outs[name, rec[name]["group"]], res[name][0]
                    rec[name].update(plain_ms=res[name][1], plain_device="cpu",
                                     max_abs_err=max((a.double() - b.double()).abs().max().item()
                                                     for a, b in zip(got[:2], want[:2])))
                return {"mismatches": rec["mismatches"]}

            check_later(f"slice_forced_fused/{tag}", futs, check)
        results["slice_forced_fused"] = out
        return out

    # ---- 6f. the graded route (engine "scan"): slice_step.cu's repeat
    # barrier, the slow part of a GradedLikelihood cached across fast-grade
    # repeats
    def graded_model(dtype=torch.float32):
        """run_graded's 20-D likelihood (a normalised Gaussian, mu 0.5, sigma
        0.1): a GradedLikelihood whose slow part is the fixed-point loop of
        tests/test_graded.py on the 6 slow coordinates (c <- c/2 + r^2/2,
        200 steps, exactly r^2 at every step) and whose fast part adds the
        14 fast coordinates' chi^2; the same likelihood as one callable per
        point (lambda theta: graded(theta)); the graded calc, and the calc of
        the one batched callable fast(slow(theta[:, :6]), theta), the
        monolithic form the kernel checks hold the graded route to."""
        n_slow, norm = GRADED["grade_dims"][0], -GRADED["nDims"] * (
            math.log(0.1) + 0.5 * math.log(2 * math.pi))

        def slow(th_s):
            r2 = (((th_s - 0.5) / 0.1) ** 2).sum(-1)
            c = r2
            for _ in range(200):
                c = c * 0.5 + r2 * 0.5
            return {"chi2_slow": c}

        def fast(aux, th):
            return norm - 0.5 * (aux["chi2_slow"] + (((th[..., n_slow:] - 0.5) / 0.1) ** 2)
                                 .sum(-1))

        graded = pt.GradedLikelihood(slow, fast, n_slow)

        def monolithic(theta):
            return graded(theta)

        def batched(theta):
            return fast(slow(theta[:, :n_slow]), theta)

        return (graded, monolithic, dtype_calc(graded, GRADED["nDims"], dtype),
                dtype_calc(batched, GRADED["nDims"], dtype))

    def graded_step_bytes(B: int, D: int, launches: int, R: int, slow_rows: int,
                          real: int = 4) -> int:
        """The traced route's bytes (slice_step_bytes) plus the slow
        intermediate: one value a chain written at each refresh and read by
        each fast round (counted as the rows of slow_fn evaluated)."""
        return slice_step_bytes(B, D, launches, R, real) + 2 * real * slow_rows

    @phase("graded_step")
    def _():
        """At the bench's chains (B 8,192, D 20, grade_dims (6, 14),
        num_repeats (8, 32)) on gaussian.ini's mid-run inputs, in float32
        and float64, and at run_graded's chains (B 256, all valid) in
        float32: the graded route against its plain version, the traced
        route on the monolithic form and the plain engine (t, logL, nlike, 0
        mismatches); its ms per epoch, launches and replays per epoch; the
        rows slow_fn evaluated, the epoch record's (assemble_epoch) counted
        in, against the monolithic route's; B2 at the dims speed grades give
        it (1, 2, 14, 20) against its plain version, at the bench's chains
        and at run_graded's bases."""
        out = {}
        kw = (0x01234567, 0x89ABCDEF)
        D = GRADED["nDims"]
        grade_dims, num_repeats = tuple(GRADED["grade_dims"]), tuple(GRADED["grade_frac"])
        R = sum(num_repeats)
        for tag, geo, dtype, reps in (("f32", GRADED_STEP, torch.float32, 3),
                                      ("f64", GRADED_STEP, torch.float64, 3),
                                      ("run", GRADED_RUN, torch.float32, 2)):
            B = geo["B"]
            _, _, calc, mono = graded_model(dtype)
            if not (calc.graded and calc.form == "batched" and not mono.graded):
                raise AssertionError(f"graded form {calc.form}, monolithic {mono.form}")
            gen = torch.Generator(dev).manual_seed(SEED)
            x0, bnd, valid, chol = live_set_inputs(B, D, mono, gen, B_valid=geo["B_valid"])
            x0, chol = x0.to(dtype), chol.to(dtype)
            nh, w, sp = make_directions(chol, grade_dims=grade_dims, num_repeats=num_repeats,
                                        n_dims=D, generator=gen)
            args = (x0, bnd, valid, nh, w)
            cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=grade_dims, num_repeats=num_repeats)
            grades = pallas_slice_v4.repeat_grades(sp)
            want, plain_engine_ms = cuda_once(lambda: slice_records_plain(  # noqa: B023
                lambda p: mono(p)[2], cfg, kw, *args))  # noqa: B023
            plain, plain_ms = cuda_once(
                lambda: pallas_slice_v4.slice_records_graded_plain(  # noqa: B023
                    calc, cfg, kw, *args, grades, pallas_slice_v4.GRADED_ROUNDS))  # noqa: B023
            counter = "slice_step_graded" + ("_f64" if tag == "f64" else "")
            before = (pallas_slice_v4.LAUNCHES[counter], dict(pallas_slice_v4.GRADED))
            got = pallas_slice_v4.slice_epoch_graded(calc, cfg, kw, *args, sp)
            launches = pallas_slice_v4.LAUNCHES[counter] - before[0]
            g = {k: v - before[1][k] for k, v in pallas_slice_v4.GRADED.items()}
            traced0 = pallas_slice_v4.TRACED["rounds"]
            traced = pallas_slice_v4.slice_epoch_traced(mono, cfg, kw, *args)
            traced_rounds = pallas_slice_v4.TRACED["rounds"] - traced0
            pairs = [(f"{k}_vs_{what}", a, b)
                     for what, ref in (("plain", plain), ("traced", traced),
                                       ("plain_engine", want))
                     for k, a, b in zip(("t", "logL", "nlike"), got, ref)]
            mism = decisions(f"graded_step {tag}: the graded route differs", pairs)
            ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch_graded(  # noqa: B023
                calc, cfg, kw, *args, sp), reps)  # noqa: B023
            traced_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch_traced(  # noqa: B023
                mono, cfg, kw, *args), reps - 1)  # noqa: B023
            # the epoch record: a fast repeat's babies from the fast part on
            # that repeat's intermediate, a slow repeat's from the full calc
            *rec, aux = pallas_slice_v4.slice_epoch_graded(calc, cfg, kw, *args, sp,
                                                           with_aux=True)
            assembly0 = dict(pallas_slice_v4.GRADED)
            pallas_slice_v4.assemble_epoch(calc, cfg, x0, valid, nh, sp, *rec, None, aux)
            assembly_rows, assembly_fast = (pallas_slice_v4.GRADED[k] - assembly0[k]
                                            for k in ("assembly_rows", "assembly_fast_rows"))
            if (assembly_rows, assembly_fast) != (grades.count(0) * B, (R - grades.count(0)) * B):
                raise AssertionError(f"graded_step {tag}: the epoch record took {assembly_rows} "
                                     f"rows of the full calc and {assembly_fast} of the fast "
                                     f"part, not {grades.count(0)} and {R - grades.count(0)} "
                                     "repeats' babies")
            assembly_ms = cuda_ms(lambda: pallas_slice_v4.assemble_epoch(  # noqa: B023
                calc, cfg, x0, valid, nh, sp, *rec, None, aux), reps)  # noqa: B023
            assembly_mono_ms = cuda_ms(lambda: pallas_slice_v4.assemble_epoch(  # noqa: B023
                mono, cfg, x0, valid, nh, sp, *traced), reps)  # noqa: B023
            rounds = g["rounds_full"] + g["rounds_fast"]
            slow_rows = g["rounds_full"] * B + g["aux_rows"] + assembly_rows
            rows = (rounds + R) * B  # the probes and the epoch's babies
            real = 8 if tag == "f64" else 4
            out[tag] = {
                "B": B, "R": R, "D": D, "grade_dims": list(grade_dims),
                "num_repeats": list(num_repeats), "repeat_grades": grades,
                "valid_lanes": int(valid.sum()), "evals": int(want[2].sum()),
                "mismatches": mism, "launches_per_epoch": launches,
                "rounds_per_replay": pallas_slice_v4.GRADED_ROUNDS, "replays_full":
                g["replays_full"], "replays_fast": g["replays_fast"],
                "openings": g["openings"], "rounds_per_epoch": rounds,
                "slow_fn_rows": slow_rows, "assembly_slow_rows": assembly_rows, "rows": rows,
                "slow_fn_rows_monolithic": (traced_rounds + R) * B,
                "slow_share": slow_rows / rows,
                "slow_rows_over_monolithic": slow_rows / ((traced_rounds + R) * B),
                "ms": ms, "plain_ms": plain_ms, "plain_engine_ms": plain_engine_ms,
                "traced_monolithic_ms": traced_ms, "traced_rounds": traced_rounds,
                "traced_over_graded": traced_ms / ms, "assembly_ms": assembly_ms,
                "assembly_monolithic_ms": assembly_mono_ms,
                "max_abs_err": max((a - b).abs().max().item() for a, b in zip(got[:2], plain[:2])),
                "bound": bound(graded_step_bytes(B, D, launches, R, slow_rows, real), 0,
                               F64_FLOPS_PER_S if tag == "f64" else F32_FLOPS_PER_S),
            }
        out["f32"]["f64_twin_ms"] = out["f64"]["ms"]
        results["slice_step_graded"] = {k: out["f32"][k] for k in ("ms", "plain_ms",
                                                                   "max_abs_err", "bound")}
        # B2 at the dims speed grades give it, at the bases the bench's chains
        # draw, and at the bases run_graded draws
        nb14, nb20 = -(-num_repeats[1] // 14), -(-num_repeats[0] // 20)
        for name, dim, nb, B in (("dim1", 1, 8, GRADED_STEP["B"]), ("dim2", 2, 4, GRADED_STEP["B"]),
                                 ("dim14", 14, nb14, GRADED_STEP["B"]),
                                 ("dim20", 20, nb20, GRADED_STEP["B"]),
                                 ("run_dim14", 14, nb14, GRADED_RUN["B"]),
                                 ("run_dim20", 20, nb20, GRADED_RUN["B"])):
            g = torch.randn((nb, dim, dim, B), generator=torch.Generator(dev).manual_seed(dim),
                            device=dev)
            q_plain, plain_ms = cuda_once(lambda: pallas_dirs.gram_schmidt_plain(g))  # noqa: B023
            before = pallas_dirs.LAUNCHES["gram_schmidt"]
            q = pallas_dirs.gram_schmidt_lanes(g)
            if pallas_dirs.LAUNCHES["gram_schmidt"] != before + 1:
                raise AssertionError(f"B2 at dim {dim}: gram_schmidt was not launched")
            mism = int((q != q_plain).sum())
            if mism or (dim == 1 and not torch.equal(q, torch.sign(g))):
                raise AssertionError(f"B2 at dim {dim}: {mism} entries differ from its plain "
                                     "version (or a dim-1 basis is not the sign)")
            out[f"gram_schmidt_{name}"] = {
                "shape": [nb, dim, dim, B], "mismatches": mism, "plain_ms": plain_ms,
                "ms": cuda_ms(lambda: pallas_dirs.gram_schmidt_lanes(g), 20),  # noqa: B023
                "library_ms": qr_ms(g),
                "bound": bound(2 * 4 * nb * dim * dim * B, gram_schmidt_flops(nb, dim, B))}
        results["graded_step"] = out
        return out

    # ---- 6f. the host route: a host-callback likelihood on slice_step.cu,
    # round by round, the user's function called between two launches
    def numpy_gaussian(D):
        """A normalised Gaussian at 0.5 (sigma 0.1) written with numpy for
        one point: a host callback.  Its chi-square is summed over the
        coordinates in order in float64, as numpy_gaussian_torch's is."""
        norm = -D * math.log(0.1 * math.sqrt(2 * math.pi))

        def like(theta):
            theta = np.asarray(theta, dtype=np.float64)
            r2 = 0.0
            for d in range(theta.shape[0]):
                x = theta[d] - 0.5
                r2 = r2 + x * x
            return norm - r2 * 50.0  # 1 / (2 sigma^2), exact

        return like

    def numpy_gaussian_torch(D):
        """numpy_gaussian's torch form, batched, in float64 in the same
        order: the same logL bit for bit."""
        norm = -D * math.log(0.1 * math.sqrt(2 * math.pi))

        def like(theta):
            t = theta.double()
            r2 = torch.zeros(t.shape[0], dtype=torch.float64, device=t.device)
            for d in range(t.shape[1]):
                x = t[:, d] - 0.5
                r2 = r2 + x * x
            return norm - r2 * 50.0

        return like

    def host_delta(before):
        return {k: v - before[k] for k, v in pallas_slice_v4.HOST.items()}

    def gram_schmidt_hold(name, nb, dim, B):
        """B2 at (nb, dim, dim, B) bitwise its plain version, launched once."""
        g = torch.randn((nb, dim, dim, B), generator=torch.Generator(dev).manual_seed(dim),
                        device=dev)
        q_plain, plain_ms = cuda_once(lambda: pallas_dirs.gram_schmidt_plain(g))
        before = pallas_dirs.LAUNCHES["gram_schmidt"]
        q = pallas_dirs.gram_schmidt_lanes(g)
        if pallas_dirs.LAUNCHES["gram_schmidt"] != before + 1:
            raise AssertionError(f"B2 at {name}: gram_schmidt was not launched")
        mism = int((q != q_plain).sum())
        if mism:
            raise AssertionError(f"B2 at {name}: {mism} entries differ from its plain version")
        return {"shape": [nb, dim, dim, B], "mismatches": mism, "plain_ms": plain_ms,
                "ms": cuda_ms(lambda: pallas_dirs.gram_schmidt_lanes(g), 20),
                "library_ms": qr_ms(g),
                "bound": bound(2 * 4 * nb * dim * dim * B, gram_schmidt_flops(nb, dim, B))}

    @phase("host_route")
    def _():
        """The host route (pallas_slice_v4.slice_epoch_host: csrc/slice_step.cu
        launched round by round, the probes and the lanes' rows copied to
        pinned memory, the numpy likelihood called on the pending probes)
        on a numpy Gaussian at gaussian.ini's chains (B 512, 504 valid, R
        40, D 20), two epochs (the second seeded from the first's babies),
        in float32 and float64, and at run_callback's and capi_cc's batches:
        against its plain version, the traced route on the torch form, and
        (at RUN, float32) the plain engine on the same callback model (t,
        logL, nlike; 0 mismatches); the babies (the accepted probes, their
        cube, theta and phi) against the plain version's, their theta and
        phi against the calc's re-evaluation of their cubes, their cubes
        within R rounding steps of the rebuilt seed + cumsum(t n), and the
        epoch record built from them with no call of the user's function.
        User calls against nlike, ms per epoch of the three (the second
        epoch's), the per-round split of the host time.  B2 at the two
        runs' bases."""
        out = {}
        for tag, geo, dtype, epochs in (("run", RUN, torch.float32, 2),
                                        ("run_f64", RUN, torch.float64, 2),
                                        ("quickstart", QUICK_RUN, torch.float32, 1),
                                        ("capi_cc", CC_RUN, torch.float32, 1)):
            B, R, D = geo["B"], geo["R"], geo["D"]
            calc = dtype_calc(numpy_gaussian(D), D, dtype)
            form = dtype_calc(numpy_gaussian_torch(D), D, dtype)
            if not (calc.form == "callback" and form.form == "batched"):
                raise AssertionError(f"forms {calc.form}, {form.form}")
            gen = torch.Generator(dev).manual_seed(SEED)
            x0, bnd, valid, chol = live_set_inputs(B, D, form, gen, B_valid=geo["B_valid"])
            x0, bnd, chol = x0.to(dtype), bnd.to(dtype), chol.to(dtype)
            nh, w, sp = make_directions(chol, grade_dims=(D,), num_repeats=(R,), n_dims=D,
                                        generator=gen)
            cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(R,))
            counter = "slice_step_host" + ("_f64" if dtype == torch.float64 else "")
            recs = []
            for epoch in range(epochs):
                kw = (0x01234567 + epoch, 0x89ABCDEF)
                args = (x0, bnd, valid, nh, w)
                before = (pallas_slice_v4.LAUNCHES[counter], dict(pallas_slice_v4.HOST),
                          calc.user_calls)
                (*got, babies), ms = cuda_once(
                    lambda: pallas_slice_v4.slice_epoch_host(calc, cfg, kw, *args))  # noqa: B023
                launches = pallas_slice_v4.LAUNCHES[counter] - before[0]
                host = host_delta(before[1])
                user_calls = calc.user_calls - before[2]
                (*plain, plain_babies), plain_ms = cuda_once(
                    lambda: pallas_slice_v4.slice_records_host_plain(  # noqa: B023
                        calc, cfg, kw, *args))  # noqa: B023
                traced, traced_ms = cuda_once(
                    lambda: pallas_slice_v4.slice_epoch_traced(form, cfg, kw, *args))  # noqa: B023
                pairs = [(f"{k}_vs_{what}", a, b)
                         for what, ref in (("plain", plain), ("traced_torch_form", traced))
                         for k, a, b in zip(("t", "logL", "nlike"), got, ref)]
                pairs += [(f"baby_{k}_vs_plain", a, b.to(a.device)) for k, a, b in
                          zip(("cube", "theta", "phi"), babies, plain_babies)]
                rec = {}
                if tag == "run":  # the plain engine (engine="torch") on the same model
                    engine, engine_ms = cuda_once(lambda: slice_records_plain(  # noqa: B023
                        lambda p: calc(p)[2], cfg, kw, *args, count_steps=True))  # noqa: B023
                    pairs += [(f"{k}_vs_plain_engine", a, b)
                              for k, a, b in zip(("t", "logL", "nlike"), got, engine[:3])]
                    if host["probe_calls"] != int(engine[3].sum()):
                        raise AssertionError(f"host_route: {host['probe_calls']} user calls, "
                                             f"{int(engine[3].sum())} consumed probes")
                    rec["plain_engine_ms"] = engine_ms
                # the babies' theta and phi against the calc's re-evaluation of
                # their cubes, on the rows an accepted probe reached
                cube, theta, phi = babies
                rows = valid[:, None] & (torch.cummax((got[0] != 0).int(), dim=1).values > 0)
                th_all, ph_all, _ = calc(cube.reshape(B * R, D))
                pairs += [("baby_theta_vs_re_evaluation", theta[rows],
                           th_all.reshape(B, R, D)[rows]),
                          ("baby_phi_vs_re_evaluation", phi[rows], ph_all.reshape(B, R, 1)[rows])]
                mism = decisions(f"host_route {tag} epoch {epoch}", pairs)
                rebuilt = x0[:, None, :] + torch.cumsum(got[0][:, :, None] * nh, dim=1)
                gap = (cube - rebuilt).abs().max().item()
                if gap > R * torch.finfo(dtype).eps:
                    raise AssertionError(f"host_route {tag}: a kept probe lies {gap} from the "
                                         "rebuilt cube")
                calls0 = calc.user_calls
                record, assembly_ms = cuda_once(lambda: pallas_slice_v4.assemble_epoch(  # noqa: B023
                    calc, cfg, x0, valid, nh, sp, *got, cube=cube,  # noqa: B023
                    theta_phi=(theta, phi)))  # noqa: B023
                if calc.user_calls != calls0:
                    raise AssertionError(f"host_route {tag}: the epoch record called the "
                                         "user's function")
                nlike = int(got[2].sum())
                rounds = max(host["rounds"], 1)
                rec.update({
                    "epoch": epoch, "mismatches": mism, "ms": ms, "plain_ms": plain_ms,
                    "traced_torch_form_ms": traced_ms, "launches": launches,
                    "rounds": host["rounds"], "user_calls": user_calls,
                    "probe_calls": host["probe_calls"], "nlike": nlike,
                    "calls_over_nlike": host["probe_calls"] / max(nlike, 1),
                    "calls_if_every_lane": rounds * B,
                    "us_per_round": {k[:-2]: host[k] * 1e6 / rounds
                                     for k in ("launch_s", "copy_out_s", "user_s", "copy_in_s")},
                    "us_per_user_call": host["user_s"] * 1e6 / max(host["probe_calls"], 1),
                    "assembly_ms": assembly_ms, "record_user_calls": calc.user_calls - calls0,
                    "baby_rows_reached": int(rows.sum()), "cube_gap_vs_rebuilt": gap,
                })
                recs.append(rec)
                last = record[:, (R - 1) * (2 * D + 2):(R - 1) * (2 * D + 2) + D]
                x0 = torch.where(valid[:, None], last, x0)
                bnd = torch.minimum(calc(x0)[2], bnd + 1.0)
            out[tag] = {"B": B, "R": R, "D": D, "valid_lanes": int(valid.sum()),
                        "dtype": str(dtype).replace("torch.", ""), "epochs": recs,
                        "bound": bound(slice_step_bytes(B, D, recs[-1]["launches"], R,
                                                        8 if dtype == torch.float64 else 4), 0,
                                       F64_FLOPS_PER_S if dtype == torch.float64
                                       else F32_FLOPS_PER_S)}
        for k in ("quickstart", "capi_cc"):
            geo = QUICK_RUN if k == "quickstart" else CC_RUN
            out[f"gram_schmidt_{k}"] = gram_schmidt_hold(
                k, -(-geo["R"] // geo["D"]), geo["D"], geo["B"])
        timed = out["run"]["epochs"][-1]
        results["slice_step_host"] = {
            "ms": timed["ms"], "plain_ms": timed["plain_ms"], "max_abs_err": 0.0,
            "bound": out["run"]["bound"], "f64_twin_ms": out["run_f64"]["epochs"][-1]["ms"],
            "plain_engine_ms": timed["plain_engine_ms"],
            "traced_torch_form_ms": timed["traced_torch_form_ms"],
            "us_per_round": timed["us_per_round"], "calls_over_nlike": timed["calls_over_nlike"],
            "record_user_calls": timed["record_user_calls"]}
        return out

    # ---- 6f'. the graded and the host routes at D = 160 (B2's long kernel
    # draws their directions): one epoch each at the 160-D run's chains,
    # bitwise its plain version and the plain engine
    @phase("stream_routes_d160")
    def _():
        from polychordlite_tpu_torch import GradedLikelihood

        D, B, B_valid = D160_RUN["D"], D160_RUN["B"], D160_RUN["B_valid"]
        kw = (0x0BADCAFE, 0x5EED)
        out = {}
        grades, reps = (16, D - 16), (16, 2 * (D - 16))  # repeats 2 D in all, as the run's
        n_slow = grades[0]

        def slow(th_s):
            return (((th_s - 0.5) / 0.2) ** 2).sum(-1)

        def fast(aux, th):
            return -0.5 * (aux + (((th[:, n_slow:] - 0.5) / 0.2) ** 2).sum(-1))

        calc = make_batched_calculator(identity_prior, GradedLikelihood(slow, fast, n_slow), D, 0,
                                       device=dev)
        mono = make_batched_calculator(identity_prior, lambda th: fast(slow(th[:, :n_slow]), th),
                                       D, 0, device=dev)
        gen = torch.Generator(dev).manual_seed(SEED)
        x0 = (0.5 + 0.03 * torch.randn((B, D), generator=gen, device=dev)).clamp(0, 1)
        valid = torch.arange(B, device=dev) < B_valid
        before = dict(pallas_dirs.LAUNCHES)
        nh, w, sp = make_directions((0.05 * torch.eye(D, device=dev)).expand(B, D, D),
                                    grade_dims=grades, num_repeats=reps, n_dims=D,
                                    generator=gen)
        dirs = {k: v - before[k] for k, v in pallas_dirs.LAUNCHES.items() if v > before[k]}
        if not dirs.get("gram_schmidt_long"):
            raise AssertionError(f"the 144-D grade's directions did not take B2's long kernel: "
                                 f"{dirs}")
        cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=grades, num_repeats=reps)
        args = (x0, mono(x0)[2] - 3.0, valid, nh, w)
        want, plain_ms = cuda_once(lambda: slice_records_plain(lambda p: mono(p)[2], cfg, kw,
                                                               *args))
        plain = pallas_slice_v4.slice_records_graded_plain(
            calc, cfg, kw, *args, pallas_slice_v4.repeat_grades(sp), pallas_slice_v4.GRADED_ROUNDS)
        before = pallas_slice_v4.LAUNCHES["slice_step_graded"]
        got, ms = cuda_once(lambda: pallas_slice_v4.slice_epoch_graded(calc, cfg, kw, *args, sp))
        out["graded"] = {
            "B": B, "valid_lanes": B_valid, "D": D, "grade_dims": list(grades),
            "num_repeats": list(reps), "directions": dirs, "ms": ms, "plain_ms": plain_ms,
            "launches": pallas_slice_v4.LAUNCHES["slice_step_graded"] - before,
            "mismatches": decisions("d160: the graded route differs", [
                (f"{k}_{n}", a, ref) for k, a, b, c in zip(("t", "logL", "nlike"), got, plain,
                                                            want)
                for n, ref in (("vs_plain_version", b), ("vs_plain_engine", c))])}
        # the host route: numpy_gaussian at D = 160, one point a call
        host = make_batched_calculator(identity_prior, numpy_gaussian(D), D, 0, device=dev)
        R = 8
        gen = torch.Generator(dev).manual_seed(SEED + 1)
        x0 = (0.5 + 0.05 * torch.randn((B, D), generator=gen, device=dev)).clamp(0, 1)
        before = dict(pallas_dirs.LAUNCHES)
        nh, w, _ = make_directions((0.06 * torch.eye(D, device=dev)).expand(B, D, D),
                                   grade_dims=(D,), num_repeats=(R,), n_dims=D, generator=gen)
        dirs = {k: v - before[k] for k, v in pallas_dirs.LAUNCHES.items() if v > before[k]}
        cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(R,))
        args = (x0, host(x0)[2] - 3.0, valid, nh, w)
        want, plain_ms = cuda_once(lambda: slice_records_plain(lambda p: host(p)[2], cfg, kw,
                                                               *args))
        *plain, _ = pallas_slice_v4.slice_records_host_plain(host, cfg, kw, *args)
        before = pallas_slice_v4.LAUNCHES["slice_step_host"]
        res, ms = cuda_once(lambda: pallas_slice_v4.slice_epoch_host(host, cfg, kw, *args))
        got = res[:3]
        out["host"] = {
            "B": B, "valid_lanes": B_valid, "D": D, "R": R, "directions": dirs, "ms": ms,
            "plain_ms": plain_ms,
            "launches": pallas_slice_v4.LAUNCHES["slice_step_host"] - before,
            "mismatches": decisions("d160: the host route differs", [
                (f"{k}_{n}", a, ref) for k, a, b, c in zip(("t", "logL", "nlike"), got, plain,
                                                            want)
                for n, ref in (("vs_plain_version", b), ("vs_plain_engine", c))])}
        results["stream_routes_d160"] = out
        return out

    # ---- 6g. the data-driven models on the fused route (their functors'
    # data loops) and on the traced route, at the batches their inis' runs
    # give them
    @phase("data_driven_step")
    def _():
        """fitting and object_detection with their inis' block priors, at the
        batches run_fitting_ini and run_object_detection_ini give the
        kernels, on mid-run inputs (:func:`mid_run_inputs`): the fused route
        (both lower, one data loop each) at the route's G
        (``pallas_slice_v4.route_group``: the rows split over a chain's
        lanes) bitwise its plain version; its decisions against the traced
        route counted and listed; the traced route against the plain engine,
        0 mismatches; ms per epoch of both routes, launches, evals, bounds,
        the functor's source lines, nvcc seconds, registers and spills; B2
        at object_detection's bases."""
        out = {}
        kw = (0x01234567, 0x89ABCDEF)
        for name, geo in DATA_RUNS.items():
            B, R, D = geo["B"], geo["R"], geo["D"]
            if data_forms[name] is None:
                raise AssertionError(f"{name}: {fused_like.lowering(data_calc(name, dev))}")
            calc, low, G, building = data_forms[name]
            if calc.form != "batched":
                raise AssertionError(f"{name}: form {calc.form}")
            building.result()
            lib = low.library_name(G)
            cfg, args = mid_run_inputs(calc, geo, dev, SEED)
            want_f, fused_plain_ms = cuda_once(lambda: slice_records_plain(  # noqa: B023
                low.plain_logL, cfg, kw, *args))  # noqa: B023
            before = pallas_slice_v4.LAUNCHES["slice_epoch_fused"]
            got = pallas_slice_v4.slice_epoch_fused(calc, cfg, kw, *args)
            fused = {
                "group": G,
                "launches_per_epoch": pallas_slice_v4.LAUNCHES["slice_epoch_fused"] - before,
                "mismatches": decisions(f"data_driven_step {name} fused", [
                    (f"{k}_vs_plain", a, b) for k, a, b in zip(("t", "logL", "nlike"), got,
                                                              want_f)]),
                "ms": cuda_ms(lambda: pallas_slice_v4.slice_epoch_fused(  # noqa: B023
                    calc, cfg, kw, *args), 3),  # noqa: B023
                "plain_ms": fused_plain_ms,
                "nvcc_s": nvcc.build_seconds.get(lib, 0.0),
                "ptxas": ptxas_summary(nvcc.build_log.get(lib, "")),
                "source_lines": len(low.source(G).splitlines())}
            want, plain_ms = cuda_once(lambda: slice_records_plain(  # noqa: B023
                lambda p: calc(p)[2], cfg, kw, *args))  # noqa: B023
            before = (pallas_slice_v4.LAUNCHES["slice_step"], dict(pallas_slice_v4.TRACED))
            traced = pallas_slice_v4.slice_epoch_traced(calc, cfg, kw, *args)
            launches = pallas_slice_v4.LAUNCHES["slice_step"] - before[0]
            replays = pallas_slice_v4.TRACED["replays"] - before[1]["replays"]
            mism = decisions(f"data_driven_step {name} traced", [
                (f"{k}_vs_plain", a, b) for k, a, b in zip(("t", "logL", "nlike"), traced, want)])
            ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch_traced(calc, cfg, kw, *args), 3)  # noqa: B023
            against = decisions_against(want_f, traced)
            evals = int(want_f[2].sum())
            fused["bound"] = fused_bound(low, B, R, D, evals)
            out[name] = {
                "B": B, "R": R, "D": D, "valid_lanes": geo["B_valid"], "group": G,
                "route_reason": route_reason("cuda", calc), "evals": evals,
                "loops": [(lp.n_rows, len(lp.body)) for lp in low.loops],
                "ops_per_probe": low.ops_per_probe(),
                "fused": fused,
                "traced": {"mismatches": mism, "launches_per_epoch": launches,
                           "replays_per_epoch": replays, "ms": ms, "plain_ms": plain_ms,
                           "plain_over_route": plain_ms / ms,
                           "bound": bound(slice_step_bytes(B, D, launches, R), 0),
                           "bound_ops_ms": fused_ops_ms(low, evals)},
                "fused_vs_traced": against,
                "traced_over_fused": ms / fused["ms"]}
        ob = DATA_RUNS["object_detection"]
        out["gram_schmidt_object_detection"] = gram_schmidt_hold(
            "object_detection", -(-ob["R"] // ob["D"]), ob["D"], ob["B"])
        results["data_driven_step"] = out
        return out

    # ---- 6h. the chain batch over shards (parallel/mesh.py): every engine
    # and route over 2 and 4 shards on this card, bitwise its one-shard
    # epoch at the same logical B; every kernel at a non-zero lane0 bitwise
    # its plain version; B1 at the bench at lane0 = 0 and at a shard's lane0
    @phase("sharded_epoch")
    def _():
        """The runner of each route (the plain engine; B1's functor, fused and
        traced routes; the graded and host routes; B3, B4, B5) at
        gaussian.ini's chains (batch 504, which 2 and 4 shards round to B
        512; R 40, D 20) and the bench's (B 8,192, R 100) (the plain engine
        and the host route, a numpy Gaussian, which take a second or more an
        epoch, at gaussian.ini's chains only), the graded route at run_graded's (B 256,
        grade_dims (6, 14), repeats (8, 32)), on gaussian.ini's mid-run
        inputs: over [cuda] * 2 and [cuda] * 4, cube, theta, phi, logL and
        nlike equal to the one-shard epoch's (0 mismatches), the epoch's wall
        ms for each.  Then each kernel's wrapper at lane0 = 3 B against its
        plain version at the same lane0 (the host route at run_callback's
        chains), and B1 at the bench at lane0 0 and 8,192."""
        from polychordlite_tpu_torch.ops.pallas_slice import seed_key
        from polychordlite_tpu_torch.ops.slice_kernel import epoch_route
        from polychordlite_tpu_torch.parallel import mesh

        D = INI["nDims"]
        zoo = dtype_calc(gaussian(D), D, torch.float32, n_derived=2)
        graded_calc = graded_model()[2]
        models = {
            "plain": (zoo, "torch", None),
            "B1": (zoo, "cuda", "slice_epoch"),
            "fused": (dtype_calc(torch_gaussian(D), D, torch.float32, n_derived=2), "cuda",
                      "slice_epoch_fused"),
            "traced": (dtype_calc(vector_norm_gaussian, D, torch.float32), "cuda", "slice_step"),
            "graded": (graded_calc, "scan", "slice_step_graded"),
            "host": (dtype_calc(numpy_gaussian(D), D, torch.float32), "scan", "slice_step_host"),
            "B3": (zoo, "cuda5", "slice_epoch_v5"),
            "B4": (zoo, "cuda3", "slice_epoch_v3"),
            "B5": (zoo, "cuda2", "slice_epoch_v2"),
        }
        out = {"routes": {}, "lane0": {}}
        for name, (calc, engine, route) in models.items():
            shapes = ((("run_graded", GRADED_RUN["B"], GRADED["grade_dims"], GRADED["grade_frac"]),)
                      if name == "graded" else
                      (("gaussian_ini", 504, [D], [RUN["R"]]), ("bench", BENCH["B"], [D],
                                                                [BENCH["R"]])))
            if name in ("plain", "host"):
                shapes = shapes[:1]
            for tag, batch, grade_dims, reps in shapes:
                D = calc.n_dims
                cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=tuple(grade_dims),
                                  num_repeats=tuple(reps), engine=engine)
                if engine != "torch" and epoch_route(engine, calc) != route:
                    raise AssertionError(f"{name}: route {epoch_route(engine, calc)}")
                B = mesh.shard_layout(batch, 4)[0]
                gen = torch.Generator(dev).manual_seed(SEED)
                # the host route's inputs from its model's torch twin (the same logL)
                icalc = (dtype_calc(numpy_gaussian_torch(D), D, torch.float32)
                         if name == "host" else calc)
                x0, bnd, _, chol = live_set_inputs(B, D, icalc, gen, B_valid=B)
                host = [a.double().cpu().numpy() for a in (x0, bnd, chol)]
                rec = {"B": B, "R": sum(reps)}
                epochs = {}
                for n in (1, 2, 4):
                    g = torch.Generator(dev).manual_seed(SEED)
                    run, Bn = mesh.make_epoch_runner(calc, cfg, B, dev, g, devices=[dev] * n)
                    if Bn != B or run.n_shards != n:
                        raise AssertionError(f"{name}/{tag}: B {Bn}, {run.n_shards} shards")
                    if name not in ("plain", "host"):  # warm-up: graphs, fused libraries,
                        # first launches
                        run(seed_key(SEED), *host)
                        g.manual_seed(SEED)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    epochs[n] = run(seed_key(SEED), *host)
                    rec[f"ms_{n}"] = (time.perf_counter() - t0) * 1e3
                for n in (2, 4):
                    mism = {k: int((a != b).sum()) for k, a, b in zip(
                        ("cube", "theta", "phi", "logL", "nlike"), epochs[1], epochs[n])}
                    rec[f"mismatches_{n}"] = mism
                    if any(mism.values()):
                        raise AssertionError(f"{name}/{tag}: {n} shards differ from one {mism}")
                rec["nlike"] = int(epochs[1][4].sum())
                out["routes"][f"{name}/{tag}"] = rec
        # each kernel at a shard's lane0 against its plain version
        L = 3 * RUN["B"]
        kw = (0x01234567, 0x89ABCDEF)
        calc, cfg, args = geometry("gaussian_ini", RUN)
        f = lambda p: calc(p)[2]  # noqa: E731
        tcalc = models["fused"][0]
        low = fused_like.lowering(tcalc)
        vcalc = models["traced"][0]
        checks = {
            "B1": (lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args, lane0=L),
                   lambda: slice_records_plain(f, cfg, kw, *args, lane0=L)),
            "fused": (lambda: pallas_slice_v4.slice_epoch_fused(tcalc, cfg, kw, *args, lane0=L),
                      lambda: slice_records_plain(low.plain_logL, cfg, kw, *args, lane0=L)),
            "traced": (lambda: pallas_slice_v4.slice_epoch_traced(vcalc, cfg, kw, *args,
                                                                  lane0=L),
                       lambda: pallas_slice_v4.slice_records_rounds_plain(
                           lambda p: vcalc(p)[2], cfg, kw, *args, lane0=L)),
            "B3": (lambda: pallas_slice_v5.slice_epoch_v5(calc, cfg, kw, *args, lane0=L),
                   lambda: pallas_slice_v5.slice_records_packet_plain(f, cfg, kw, *args,
                                                                      lane0=L)),
            "B4": (lambda: pallas_slice_v3.slice_epoch_v3(calc, cfg, kw, *args, lane0=L),
                   lambda: pallas_slice_v3.slice_records_window_plain(f, cfg, kw, *args,
                                                                      lane0=L)),
            "B5": (lambda: pallas_slice.slice_epoch_v2(calc, cfg, kw, *args, lane0=L),
                   lambda: pallas_slice.slice_records_lockstep_plain(f, cfg, kw, *args,
                                                                     lane0=L)),
        }
        gD = GRADED["nDims"]
        ggen = torch.Generator(dev).manual_seed(SEED)
        gx0, gbnd, gvalid, gchol = live_set_inputs(GRADED_RUN["B"], gD, graded_calc, ggen,
                                                   B_valid=GRADED_RUN["B"])
        gcfg = EpochConfig(n_dims=gD, n_phi=graded_calc.n_phi,
                           grade_dims=tuple(GRADED["grade_dims"]),
                           num_repeats=tuple(GRADED["grade_frac"]))
        gnh, gw, gsp = make_directions(gchol, grade_dims=gcfg.grade_dims,
                                       num_repeats=gcfg.num_repeats, n_dims=gD, generator=ggen)
        gargs = (gx0, gbnd, gvalid, gnh, gw)
        checks["graded"] = (
            lambda: pallas_slice_v4.slice_epoch_graded(graded_calc, gcfg, kw, *gargs, gsp,
                                                       lane0=L),
            lambda: pallas_slice_v4.slice_records_graded_plain(
                graded_calc, gcfg, kw, *gargs, pallas_slice_v4.repeat_grades(gsp), lane0=L))
        qB, qR, qD = QUICK_RUN["B"], QUICK_RUN["R"], QUICK_RUN["D"]
        hcalc = dtype_calc(numpy_gaussian(qD), qD, torch.float32)
        hgen = torch.Generator(dev).manual_seed(SEED)
        hx0, hbnd, hvalid, hchol = live_set_inputs(qB, qD, dtype_calc(numpy_gaussian_torch(qD),
                                                                      qD, torch.float32),
                                                   hgen, B_valid=QUICK_RUN["B_valid"])
        hcfg = EpochConfig(n_dims=qD, n_phi=hcalc.n_phi, grade_dims=(qD,), num_repeats=(qR,))
        hnh, hw, _ = make_directions(hchol, grade_dims=(qD,), num_repeats=(qR,), n_dims=qD,
                                     generator=hgen)
        hargs = (hx0, hbnd.float(), hvalid, hnh, hw)
        checks["host"] = (
            lambda: pallas_slice_v4.slice_epoch_host(hcalc, hcfg, kw, *hargs, lane0=L)[:3],
            lambda: pallas_slice_v4.slice_records_host_plain(hcalc, hcfg, kw, *hargs,
                                                             lane0=L)[:3])
        for name, (kernel, plain) in checks.items():
            got, want = kernel(), plain()
            mism = [int((a != b).sum()) for a, b in zip(got, want)]
            if any(mism):
                raise AssertionError(f"{name} at lane0 = {L}: {mism} entries differ from its "
                                     "plain version")
            out["lane0"][name] = {"lane0": L, "mismatches": mism}
        # B1 at the bench, at lane0 = 0 and at the second of two shards' lane0
        calc, cfg, args = geometry("bench", BENCH)
        out["b1_bench_ms"] = {
            str(l0): cuda_ms(lambda: pallas_slice_v4.slice_epoch(  # noqa: B023
                calc, cfg, kw, *args, lane0=l0), 5)  # noqa: B023
            for l0 in (0, BENCH["B"])}
        results["sharded_epoch"] = out
        return out

    # ---- 7-. the 160-D run (run_gaussian_d160, the longest of the runs in
    # processes of their own) starts here, in a thread of this script, behind
    # the runs of section 7 and after the last kernel timing before them; its
    # phase waits for it.  A function of this module in a process of its own
    # (its arguments and its result in JSON): the 160-D and the 64-D runs
    # and the two processes' runs
    tmpdirs = []
    worker = os.path.join(tempfile.mkdtemp(prefix="worker_"), "worker.py")
    tmpdirs.append(os.path.dirname(worker))
    with open(worker, "w") as f:
        f.write(r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
out = getattr(chip_smoke, sys.argv[2])(*(json.loads(a) for a in sys.argv[3:]))
print("RESULT " + json.dumps(out), flush=True)
''')

    def cli(args, cwd=HERE, env=None, timeout=600):
        """A process of its own, waited for: (CompletedProcess, wall s)."""
        t0 = time.perf_counter()
        proc = subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True,
                              timeout=timeout)
        return proc, time.perf_counter() - t0

    def d160_job():
        """d160_run in a process of its own: (base, CompletedProcess, wall s)."""
        base = tempfile.mkdtemp(prefix="gaussian_d160_")
        tmpdirs.append(base)
        return (base, *cli([sys.executable, worker, HERE, "d160_run", json.dumps(base)],
                           timeout=1000))

    d160_jobs = ThreadPoolExecutor(max_workers=1)
    jobs = {"d160": d160_jobs.submit(d160_job)}

    # ---- 7. the main path: run() on ini/gaussian.ini ----------------------
    counters = (pallas_dirs.LAUNCHES, pallas_slice_v4.LAUNCHES, pallas_slice_v5.LAUNCHES,
                pallas_slice_v3.LAUNCHES, pallas_slice.LAUNCHES, v3_instr.LAUNCHES,
                prof_grid_overhead.LAUNCHES, prof_pallas_while.LAUNCHES,
                pallas_epoch_v2.LAUNCHES, pallas_slice_repeat.LAUNCHES)
    launches = {k: 0 for c in counters for k in c}

    group_counters = (pallas_slice_v4.GROUP_LAUNCHES, pallas_slice_v5.GROUP_LAUNCHES,
                      pallas_slice_v3.GROUP_LAUNCHES, pallas_slice.GROUP_LAUNCHES)

    def reset_launches():
        for c in counters + group_counters:
            for k in c:
                c[k] = 0

    def ran_above_one(name, counts):
        """The launches by G (by "bucket/G" where the counts are kept by
        (bucket, G)) of a path's kernel, which must have run at G > 1 only."""
        groups = {"/".join(map(str, k)) if isinstance(k, tuple) else k: c
                  for k, c in counts.items() if c}
        if not groups or any((k[1] if isinstance(k, tuple) else k) == 1
                             for k, c in counts.items() if c):
            raise AssertionError(f"{name} ran at G = 1 on the path: launches by G {groups}")
        return groups

    def read_launches():
        return {k: v for c in counters for k, v in c.items()}

    def only(ran, kernels):
        """Whether exactly ``kernels`` of the path ran (each at least once)."""
        return all((ran.get(k, 0) > 0) == (k in kernels) for k in launches)

    def add_launches(ran):
        for k, v in ran.items():
            launches[k] += v

    @phase("run_gaussian_ini")
    def _():
        like = gaussian(INI["nDims"])
        with tempfile.TemporaryDirectory() as base:
            reset_launches()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("error")  # a replay divergence would warn
                pt.run(
                    like, INI["nDims"], nDerived=INI["nDerived"], nlive=INI["nlive"],
                    num_repeats=INI["num_repeats"], do_clustering=False,
                    precision_criterion=0.001, read_resume=False, base_dir=base,
                    seed=SEED, feedback=-1, device="cuda",
                )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = read_launches()
            stats = PolyChordOutput(base, "test")
            with open(os.path.join(base, "test.metrics.jsonl")) as f:
                last = json.loads(f.read().splitlines()[-1])
        if last.get("engine") != "cuda":
            raise AssertionError(f"engine_used is {last.get('engine')!r}, not 'cuda'")
        if last.get("chained_epochs") is not True:
            raise AssertionError("chained epochs were switched off during the run")
        if not only(ran, ("gram_schmidt", "slice_epoch")):
            raise AssertionError(f"the path did not run B1 and B2 (only): {ran}")
        groups = ran_above_one("B1", pallas_slice_v4.GROUP_LAUNCHES)
        add_launches(ran)
        if not (math.isfinite(stats.logZ) and abs(stats.logZ - 0.0) < 3 * stats.logZerr):
            raise AssertionError(f"logZ {stats.logZ} +/- {stats.logZerr} is not within 3 sigma of 0")
        if stats.ndead != last["ndead"] or stats.ndead < INI["nlive"]:
            raise AssertionError(".stats does not match the run")
        results["run_gaussian_ini"] = {"wall_s": wall, "dead_per_s": stats.ndead / wall,
                                       "device_frac": last.get("device_frac"),
                                       "epoch_timers_s": last.get("epoch_timers")}
        return {
            "engine_used": last["engine"], "chained_epochs": last["chained_epochs"],
            "ndead": stats.ndead, "logZ": stats.logZ,
            "logZerr": stats.logZerr, "wall_s": wall, "dead_per_s": stats.ndead / wall,
            "launches": ran, "slice_epoch_launches_by_group": groups,
            "device_frac": last.get("device_frac"),
            "host_totals_s": last.get("host_totals"),
            "epoch_timers_s": last.get("epoch_timers"),
        }

    # ---- 7a. the chain batch over two processes on this card, and
    # dispatch-ahead mode (synchronous=False)
    @phase("run_two_process")
    def _():
        """gaussian.ini's settings at batch_size 512 through run() in two
        processes on this card, joined by torch.distributed over gloo (the
        environment torchrun gives: RANK, WORLD_SIZE, MASTER_ADDR,
        MASTER_PORT, LOCAL_RANK; each process waited for with its own
        timeout), against one process (this one) at the same batch, one
        epoch at a time (chain_epochs = 0: a run over shards never chains):
        the same logZ, logZerr, ndead and nlike on both ranks and the one
        process, rank 0's .stats and .txt byte for byte the one process's,
        no file from rank 1, rank 0's metrics naming 2 shards in 2 processes
        and B1's and B2's launches; dead/s of both runs, and each rank's
        device_frac (the gloo gather left out) and epoch timers (the gather's
        seconds among them)."""
        import socket

        cfg = {**INI, "seed": SEED, "batch_size": 512, "chain_epochs": 0}
        with tempfile.TemporaryDirectory() as base:
            env = {k: v for k, v in os.environ.items()
                   if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}

            def start(d, extra):
                return subprocess.Popen(
                    [sys.executable, worker, HERE, "gaussian_batch_run",
                     json.dumps(os.path.join(base, d)), json.dumps({**cfg, "chain_epochs": -1})],
                    env={**env, **extra}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)

            def result(procs):
                outs = []
                try:
                    for p in procs:
                        so, se = p.communicate(timeout=400)
                        if p.returncode != 0:
                            raise AssertionError(f"a process exited {p.returncode}: {se[-3000:]}")
                        line = [ln for ln in so.splitlines() if ln.startswith("RESULT ")]
                        outs.append(json.loads(line[-1][len("RESULT "):]))
                finally:
                    for p in procs:
                        if p.poll() is None:
                            p.kill()
                            p.communicate()
                return outs

            reset_launches()
            one = gaussian_batch_run(os.path.join(base, "one"), cfg)
            one_ran = read_launches()
            if not only(one_ran, ("gram_schmidt", "slice_epoch")):
                raise AssertionError(f"the one process did not run B1 and B2 (only): {one_ran}")
            add_launches(one_ran)
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = str(s.getsockname()[1])
            ranks = result([start(f"rank{i}", {"RANK": str(i), "LOCAL_RANK": str(i),
                                               "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
                                               "MASTER_PORT": port}) for i in range(2)])
            wall2 = max(r["wall_s"] for r in ranks)  # inside run(), as the one process's
            for i, r in enumerate(ranks):
                for k in ("logZ", "logZerr", "ndead", "nlike"):
                    if r[k] != one[k]:
                        raise AssertionError(f"rank {i}: {k} {r[k]} is not the one process's "
                                             f"{one[k]}")
            same = {}
            for suffix in (".stats", ".txt"):
                with open(os.path.join(base, "one", "test" + suffix), "rb") as f:
                    a = f.read()
                with open(os.path.join(base, "rank0", "test" + suffix), "rb") as f:
                    same[suffix] = a == f.read()
            if not all(same.values()):
                raise AssertionError(f"rank 0's files differ from the one process's: {same}")
            rank1 = [os.path.join(d, n) for d, _, ns in os.walk(os.path.join(base, "rank1"))
                     for n in ns]
            if rank1:
                raise AssertionError(f"rank 1 wrote {rank1}")
            last = read_metrics(os.path.join(base, "rank0"), "test")[-1]
            one_last = read_metrics(os.path.join(base, "one"), "test")[-1]
        ran = {k: v for k, v in last["kernel_launches"].items() if v}
        if (last["shards"], last["processes"], last["route"]) != (2, 2, "slice_epoch") or \
                set(ran) != {"slice_epoch", "gram_schmidt"}:
            raise AssertionError(f"rank 0 ran {last['shards']} shards in {last['processes']} "
                                 f"processes, route {last['route']}, launches {ran}")
        if abs(one["logZ"]) >= 3 * one["logZerr"]:
            raise AssertionError(f"logZ {one['logZ']} +/- {one['logZerr']} is not within 3 "
                                 "sigma of 0")
        one = {**one, "dead_per_s": one["ndead"] / one["wall_s"],
               "host_totals_s": one_last.get("host_totals")}
        results["run_two_process"] = {"one_process": one}
        return {"one_process": one,
                "two_processes": {"ranks": ranks, "wall_s": wall2,
                                  "dead_per_s": ranks[0]["ndead"] / wall2,
                                  "rank0_launches": ran},
                "files_equal": same}

    @phase("run_async")
    def _():
        """gaussian.ini's settings at batch_size 512 through
        run(engine="cuda") with synchronous=False (dispatch-ahead: the next
        epoch is dispatched when one is collected, before the host consumes
        it): it warns that it biases logZ high, runs B1 and B2 only, no
        chain, within 3 sigma of 0; dead/s, device_frac and the epoch timers
        beside the synchronous runs of this call at the same settings: one
        epoch at a time (run_two_process's one process, batch_size 512) and
        chained (run_gaussian_ini)."""
        with tempfile.TemporaryDirectory() as base:
            reset_launches()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                pt.run(gaussian(INI["nDims"]), INI["nDims"], nDerived=INI["nDerived"],
                       nlive=INI["nlive"], num_repeats=INI["num_repeats"], do_clustering=False,
                       precision_criterion=0.001, read_resume=False, base_dir=base, seed=SEED,
                       feedback=-1, device="cuda", engine="cuda", batch_size=512,
                       synchronous=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = read_launches()
            stats = PolyChordOutput(base, "test")
            last = read_metrics(base, "test")[-1]
        said = [str(w.message) for w in caught]
        if not any("biases logZ high" in m for m in said) or len(said) != 1:
            raise AssertionError(f"the warnings were {said}, not the bias warning alone")
        if not only(ran, ("gram_schmidt", "slice_epoch")) or last["chained_epochs"]:
            raise AssertionError(f"launches {ran}, chained {last['chained_epochs']}")
        add_launches(ran)
        if not (math.isfinite(stats.logZ) and abs(stats.logZ) < 3 * stats.logZerr):
            raise AssertionError(f"logZ {stats.logZ} +/- {stats.logZerr} is not within 3 sigma "
                                 "of 0")
        recs = {"async": {"logZ": stats.logZ, "logZerr": stats.logZerr, "ndead": stats.ndead,
                          "wall_s": wall, "dead_per_s": stats.ndead / wall,
                          "synchronous": last["synchronous"],
                          "device_frac": last.get("device_frac"),
                          "epoch_timers_s": last.get("epoch_timers"),
                          "host_totals_s": last.get("host_totals"),
                          "launches": {k: v for k, v in ran.items() if v}}}
        recs["sync"] = results["run_two_process"]["one_process"]
        recs["sync_chained"] = results["run_gaussian_ini"]
        results["run_async"] = recs
        return recs

    # ---- 7b. any torch likelihood through run(): the fused route, and the
    # traced route for a model the lowering refuses
    def prebuild(like, n_dims, nlive, nDerived=0, prior=identity_prior, dtype=torch.float32):
        """Lower the model as run() will (in ``dtype``: float64 for a run at
        precision='highest') and build its fused libraries at every G up to
        D (the run's batch picks one), before the run's clock starts: a
        second run of the same model finds them built."""
        calc = dtype_calc(like, n_dims, dtype, prior, nDerived)
        low = fused_like.lowering(calc)
        if not isinstance(low, fused_like.Lowered):
            raise AssertionError(f"the model was not lowered: {low.reason}")
        B_phys = -(-(-(-nlive // 8) * 8) // GRANULE) * GRANULE
        t0 = time.perf_counter()
        buckets = pallas_slice_v4.BUCKET_GROUPS[pallas_slice_v4.bucket(n_dims)]
        low.build([g for g in buckets if g <= n_dims])
        return {"seconds": time.perf_counter() - t0, "by_group": dict(low.build_seconds),
                "run_group": pallas_slice_v4.choose_group(B_phys, n_dims, n_sm)}

    def route_run(name, like, n_dims, route="slice_epoch_fused", dirs="gram_schmidt",
                  kernels=None, engine_used="cuda", files=None, **kw):
        """run() on the card with every launch count at 0 before it: (the
        final metrics record, the output, wall seconds, the launches).  The
        path must take ``route`` (the fused route, or the traced route) and
        launch B2's kernel ``dirs`` (its wide kernel above D = 32)
        and the route's kernel only (``kernels``, the counters' names, where
        they are not ``dirs`` and ``route``: the double instantiations at
        precision='highest'), with chained epochs kept (a replay divergence
        would warn, and warnings are errors); ``engine_used`` is the engine
        the metrics must name (a forced one, passed as ``engine=``).  A dict
        ``files`` takes the bytes of every file the run wrote but its
        metrics (which hold its times), by name."""
        with tempfile.TemporaryDirectory() as base:
            reset_launches()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                pt.run(like, n_dims, read_resume=False, base_dir=base, seed=SEED, feedback=-1,
                       device="cuda", **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = read_launches()
            stats = PolyChordOutput(base, "test")
            last = read_metrics(base, "test")[-1]
            chains = np.loadtxt(os.path.join(base, "test.txt"), ndmin=2)
            if files is not None:
                files.update(written_files(base))
        if (last.get("engine"), last.get("route")) != (engine_used, route):
            raise AssertionError(f"{name}: engine {last.get('engine')!r}, route "
                                 f"{last.get('route')!r} ({last.get('route_reason')}), "
                                 f"not {route}")
        if last.get("chained_epochs") is not True:
            raise AssertionError(f"{name}: chained epochs were switched off during the run")
        kernels = kernels or (dirs, route)
        if not only(ran, kernels):
            raise AssertionError(f"{name}: the path did not run {kernels} (only): {ran}")
        add_launches(ran)
        return last, stats, wall, ran, chains

    def route_record(last, stats, wall, ran, truth):
        pull = (stats.logZ - truth) / stats.logZerr
        if not (math.isfinite(stats.logZ) and abs(pull) < 3.0):
            raise AssertionError(f"logZ {stats.logZ} +/- {stats.logZerr} is {pull:.2f} sigma "
                                 f"from {truth} ({stats.ndead} dead in {wall:.1f} s)")
        return {"engine_used": last["engine"], "route": last["route"],
                "route_reason": last.get("route_reason"),
                "fused_build_seconds": last.get("fused_build_seconds"), "form": last["form"],
                "chained_epochs": last["chained_epochs"], "ndead": stats.ndead,
                "logZ": stats.logZ, "logZerr": stats.logZerr, "oracle": truth,
                "pull_sigma": pull, "wall_s": wall, "dead_per_s": stats.ndead / wall,
                "launches": {k: v for k, v in ran.items() if v},
                "traced_route": last.get("traced_route"), "device_frac": last.get("device_frac"),
                "host_totals_s": last.get("host_totals"),
                "epoch_timers_s": last.get("epoch_timers")}

    # ---- 7a'. the ring engine through run(): gaussian.ini on B1's functor
    # kernel under RingPolicy (cut at RING_MAX_NDEAD dead points), its torch
    # form on the fused route's ring library and the vector_norm Gaussian on
    # the traced route under the ring's budget (nlive 100, to the end), each
    # gated at 3 sigma of logZ = 0; an overflowed epoch is re-run on the
    # same route at its own budget
    @phase("run_ring")
    def _():
        out = {}
        D = INI["nDims"]
        # the fused route's libraries at the run's G, its own and the ring's,
        # before the clock
        G = pallas_slice_v4.choose_group(-(-100 // GRANULE) * GRANULE, D, n_sm)
        t_build = time.perf_counter()
        low = fused_like.lowering(dtype_calc(torch_gaussian(D), D, torch.float32, n_derived=2))
        low.build([G])
        low.build([G], ring=True)
        build_s = time.perf_counter() - t_build
        for name, like, n_derived, nlive, max_ndead, route, ring_kernel in (
                ("functor", gaussian(D), INI["nDerived"], INI["nlive"], RING_MAX_NDEAD,
                 "slice_epoch", "slice_epoch_ring"),
                ("fused", torch_gaussian(D), 2, 100, -1, "slice_epoch_fused",
                 "slice_epoch_fused_ring"),
                ("traced", vector_norm_gaussian, 0, 100, -1, "slice_step", "slice_step_ring")):
            with tempfile.TemporaryDirectory() as base:
                reset_launches()
                t0 = time.perf_counter()
                pt.run(like, D, nDerived=n_derived, nlive=nlive, num_repeats=INI["num_repeats"],
                       do_clustering=False, precision_criterion=0.001, max_ndead=max_ndead,
                       read_resume=False, base_dir=base, seed=SEED, feedback=-1,
                       device="cuda", engine="ring")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                ran = read_launches()
                stats = PolyChordOutput(base, "test")
                last = read_metrics(base, "test")[-1]
            if (last.get("engine"), last.get("route")) != ("ring", route):
                raise AssertionError(f"{name}: engine {last.get('engine')!r}, route "
                                     f"{last.get('route')!r}, not ring on {route}")
            if last.get("chained_epochs") is not False:
                raise AssertionError(f"{name}: the ring run chained its epochs")
            reruns = last["ring_reruns"]
            # the ring's kernel and B2, and the route's own kernel where an
            # epoch was re-run (the functor and fused routes' also in their
            # checks before the run)
            kernels = {"gram_schmidt", ring_kernel}
            if reruns or name != "traced":
                kernels.add(route)
            if not only(ran, kernels):
                raise AssertionError(f"{name}: the path did not run {sorted(kernels)} (only): "
                                     f"{ran}")
            if not ran[ring_kernel] >= last["epochs"] - reruns:
                raise AssertionError(f"{name}: {ran[ring_kernel]} ring launches for "
                                     f"{last['epochs']} epochs")
            add_launches(ran)
            pull = stats.logZ / stats.logZerr
            if not (math.isfinite(stats.logZ) and abs(pull) < 3.0):
                raise AssertionError(f"{name}: logZ {stats.logZ} +/- {stats.logZerr} is "
                                     f"{pull:.2f} sigma from 0")
            out[name] = {"route": last["route"], "route_reason": last.get("route_reason"),
                         "nlive": nlive, "ndead": stats.ndead, "logZ": stats.logZ,
                         "logZerr": stats.logZerr, "pull_sigma": pull,
                         "epochs": last["epochs"], "ring_reruns": reruns, "wall_s": wall,
                         "dead_per_s": stats.ndead / wall,
                         "device_frac": last.get("device_frac"),
                         "launches": {k: v for k, v in ran.items() if v},
                         "epoch_timers_s": last.get("epoch_timers")}
        out["fused_build_s"] = build_s
        results["run_ring"] = out
        return out

    # ---- 7b'. the runs in processes of their own start here, in two threads
    # of this script, and go on behind the in-process runs below: the CLI
    # runs and the C++ example one after another, the 64-D run beside them
    # (the 160-D run started before section 7); each phase waits for its
    # own.  They share the card and the host with
    # the in-process runs (their dead/s are taken under that load); every
    # kernel timing comes before them or after the last
    def ini_job(prefix, make_ini, timeout=600):
        """``python -m polychordlite_tpu_torch`` on the ini ``make_ini(base)``
        writes into a new directory: (base, ini, CompletedProcess, wall s)."""
        base = tempfile.mkdtemp(prefix=prefix)
        tmpdirs.append(base)
        ini = make_ini(base)
        return (base, ini, *cli([sys.executable, "-m", "polychordlite_tpu_torch", ini],
                                timeout=timeout))

    def graded_ini_copy(base: str) -> str:
        """ini/gaussian.ini (ini_copy) with p1-p6 at speed 1, p7-p20 at speed
        2 and ``grade_frac = 8 32``: literal repeats, 40 in all as the ini's
        num_repeats, so the run does not depend on a timing."""
        path = ini_copy(base, "gaussian")
        lines = []
        with open(path) as f:
            for ln in f.read().splitlines():
                if ln.startswith("P :"):
                    fields = ln.split("|")
                    k = int(fields[0].split()[-1][1:])  # p<k>
                    fields[2] = f" {1 if k <= GRADED['grade_dims'][0] else 2} "
                    ln = "|".join(fields)
                elif ln.startswith("num_repeats"):
                    ln += "\ngrade_frac = " + " ".join(str(g) for g in GRADED["grade_frac"])
                lines.append(ln)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path

    def capi_job():
        """examples/cc/gaussian_cc.cpp built into a program that embeds the
        interpreter, and run in a new directory: (base, build s,
        CompletedProcess, wall s); None where this Python has no shared
        libpython to embed (the phase then runs the example in this
        process)."""
        if not cabi.embedding_possible():
            return None
        base = tempfile.mkdtemp(prefix="capi_cc_")
        tmpdirs.append(base)
        t0 = time.perf_counter()
        exe = cabi.build("cc_example")
        build_s = time.perf_counter() - t0
        return (base, build_s, *cli([str(exe)], cwd=base, env=cabi.embedded_env(),
                                    timeout=900))

    def d64_job():
        """d64_run in a process of its own: (base, CompletedProcess, wall s)."""
        base = tempfile.mkdtemp(prefix="gaussian_d64_")
        tmpdirs.append(base)
        return (base, *cli([sys.executable, worker, HERE, "d64_run", json.dumps(base)],
                           timeout=900))

    def quickstart_example_job():
        """The port's examples/quickstart.py, as a user runs it, in a new
        directory: (base, CompletedProcess, wall s)."""
        base = tempfile.mkdtemp(prefix="quickstart_example_")
        tmpdirs.append(base)
        env = {**os.environ, "PYTHONPATH": HERE}
        return (base, *cli([sys.executable, "-m", "polychordlite_tpu_torch.examples.quickstart",
                            "--seed", str(SEED), "--no-plot"], cwd=base, env=env, timeout=600))

    def job_result(name):
        """A job's result; a process that failed raises."""
        out = jobs[name].result()
        proc = out[-2]
        if proc.returncode != 0 or (name == "capi_cc" and "Traceback" in proc.stderr):
            raise AssertionError(f"{name}: the process exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        return out

    cli_jobs, side_jobs = ThreadPoolExecutor(max_workers=1), ThreadPoolExecutor(max_workers=1)
    jobs["d64"] = side_jobs.submit(d64_job)
    jobs["quickstart_example"] = side_jobs.submit(quickstart_example_job)
    for name, job in (
            ("shells", lambda: ini_job("shells_cli_", lambda b: ini_copy(b, "gaussian_shells"))),
            ("eggbox", lambda: ini_job("eggbox_cli_", lambda b: ini_copy(b, "eggbox"))),
            ("grades", lambda: ini_job("gaussian_grades_", graded_ini_copy)),
            ("capi_cc", capi_job),
            ("fitting", lambda: ini_job("fitting_cli_", lambda b: ini_copy(b, "fitting"), 900)),
            ("object_detection", lambda: ini_job("object_detection_cli_",
                                                 lambda b: ini_copy(b, "object_detection"), 900))):
        jobs[name] = cli_jobs.submit(job)

    @phase("run_gaussian_ini_torch")
    def _():
        built = prebuild(torch_gaussian(INI["nDims"]), INI["nDims"], INI["nlive"],
                         INI["nDerived"])
        last, stats, wall, ran, _ = route_run(
            "gaussian.ini", torch_gaussian(INI["nDims"]), INI["nDims"], nDerived=INI["nDerived"],
            nlive=INI["nlive"], num_repeats=INI["num_repeats"], do_clustering=False,
            precision_criterion=0.001)
        if last["form"] != "batched":
            raise AssertionError(f"the batched likelihood was read as {last['form']!r}")
        rec = {**route_record(last, stats, wall, ran, 0.0), "prebuild": built}
        functor = results.get("run_gaussian_ini", {})
        rec["functor_run_dead_per_s"] = functor.get("dead_per_s")
        rec["functor_run_wall_s"] = functor.get("wall_s")
        return rec

    def quickstart(theta):
        """The reference quickstart, per point (examples/quickstart.py)."""
        r2 = torch.sum(theta ** 2)
        return -math.log(2 * math.pi * 0.1 * 0.1) * 4 / 2.0 - r2 / 2 / 0.1 ** 2, [r2]

    @phase("run_quickstart_torch")
    def _():
        built = prebuild(quickstart, 4, 200, 1, UniformPrior(-1, 1))
        last, stats, wall, ran, chains = route_run(
            "quickstart", quickstart, 4, nDerived=1, prior=UniformPrior(-1, 1), nlive=200,
            do_clustering=True)
        if last["form"] != "per_point":
            raise AssertionError(f"the per-point quickstart was read as {last['form']!r}")
        # weight, -2 logL, theta (4), r^2: the derived column is r^2 of its row
        if chains.shape[1] != 2 + 4 + 1:
            raise AssertionError(f"the chains have {chains.shape[1]} columns, not 7")
        r2_err = float(np.abs(chains[:, 6] - (chains[:, 2:6] ** 2).sum(1)).max())
        if not r2_err < 1e-5:
            raise AssertionError(f"the r^2 column is {r2_err} from theta's")
        return {**route_record(last, stats, wall, ran, -4 * math.log(2.0)),
                "chain_rows": int(chains.shape[0]), "max_abs_r2_err": r2_err,
                "prebuild": built}

    @phase("run_gaussian_prior")
    def _():
        D, s_like, mu_p, s_p = 5, 0.5, 1.0, 1.0
        norm = -D * (math.log(s_like) + 0.5 * math.log(2 * math.pi))

        def like(theta):
            return norm - 0.5 * ((theta / s_like) ** 2).sum(-1)

        # Z = prod_d N(mu_p; 0, s_like^2 + s_p^2)
        var = s_like ** 2 + s_p ** 2
        truth = D * (-0.5 * math.log(2 * math.pi * var) - 0.5 * mu_p ** 2 / var)
        built = prebuild(like, D, 200, 0, GaussianPrior(mu_p, s_p))
        last, stats, wall, ran, _ = route_run(
            "gaussian_prior", like, D, prior=GaussianPrior(mu_p, s_p), nlive=200)
        return {**route_record(last, stats, wall, ran, truth), "prebuild": built}

    @phase("run_traced_route")
    def _():
        D, mu, sigma = 4, 0.5, 0.1
        norm = -D * (math.log(sigma) + 0.5 * math.log(2 * math.pi))

        def like(theta):  # torch.linalg.vector_norm: outside the lowering's table
            return norm - 0.5 * (torch.linalg.vector_norm(theta - mu, dim=-1) / sigma) ** 2

        last, stats, wall, ran, _ = route_run("vector_norm", like, D, route="slice_step",
                                               nlive=200)
        if "linalg_vector_norm" not in str(last.get("route_reason")):
            raise AssertionError(f"route_reason {last.get('route_reason')!r} does not name "
                                 "the refused op")
        return route_record(last, stats, wall, ran, 0.0)

    @phase("run_stream_routes_d160")
    def _():
        """Above D = 128, the stream bucket's other routes through run() at D
        = 160, every count at 0 before each run: B1's functor kernel on the
        zoo Gaussian (engine "auto"), the traced route on a model the
        lowering refuses, the fused route and B2's long kernel in double
        (precision='highest'), and B4, B5 and B3 (the forced "cuda3",
        "cuda2" and "cuda5"); and at D = 64 the zoo Gaussian on "auto" and on
        "cuda5" (B3 in the wide bucket); nlive 200, num_repeats 2 D, stopped
        at max_ndead 400 (no evidence to gate): finite logZ, the path's
        kernels only, B1's, B3's, B4's and B5's launches in the run's bucket,
        and each cuda5 run's files byte for byte those of engine "cuda" at the
        same settings."""
        stream = f"{pallas_slice_v4.STREAM}/32"
        out, files = {}, {}
        for name, D, like, n_derived, route, dirs, kernels, extra in (
            ("functor", 160, "zoo", 2, "slice_epoch", "gram_schmidt_long", None, {}),
            ("traced", 160, vector_norm_gaussian, 0, "slice_step", "gram_schmidt_long", None, {}),
            ("fused_f64", 160, per_point_gaussian, 0, "slice_epoch_fused", None,
             ("gram_schmidt_long_f64", "slice_epoch_fused_f64"), {"precision": "highest"}),
            ("cuda3", 160, "zoo", 2, "slice_epoch_v3", "gram_schmidt_long", None,
             {"engine": "cuda3"}),
            ("cuda2", 160, "zoo", 2, "slice_epoch_v2", "gram_schmidt_long", None,
             {"engine": "cuda2"}),
            ("cuda5", 160, "zoo", 2, "slice_epoch_v5", "gram_schmidt_long", None,
             {"engine": "cuda5"}),
            ("functor_d64", 64, "zoo", 2, "slice_epoch", "gram_schmidt_wide", None, {}),
            ("cuda5_d64", 64, "zoo", 2, "slice_epoch_v5", "gram_schmidt_wide", None,
             {"engine": "cuda5"}),
        ):
            if like == "zoo":
                like = gaussian(D, sigma=D160["sigma"])
            kw = dict(nlive=D160["nlive"], num_repeats=2 * D, max_ndead=400, do_clustering=False)
            files[name] = {}
            last, stats, wall, ran, _ = route_run(
                f"{name} d{D}", like, D, route=route, dirs=dirs, kernels=kernels,
                engine_used=extra.get("engine", "cuda"), files=files[name], nDerived=n_derived,
                **kw, **extra)
            if not (math.isfinite(stats.logZ) and stats.ndead >= kw["max_ndead"]):
                raise AssertionError(f"{name} d{D}: logZ {stats.logZ}, {stats.ndead} dead")
            groups = {"cuda3": pallas_slice_v3.GROUP_LAUNCHES,
                      "cuda2": pallas_slice.GROUP_LAUNCHES,
                      "cuda5": pallas_slice_v5.GROUP_LAUNCHES}.get(extra.get("engine"))
            groups = ({"/".join(map(str, k)): v for k, v in groups.items() if v}
                      if groups is not None else last.get("group_launches") or {})
            bucket = stream if D > 128 else f"{pallas_slice_v4.SLICE_MAXD_WIDE}/32"
            if name != "traced" and (not groups or set(groups) != {bucket}):
                raise AssertionError(f"{name} d{D}: launches by bucket/G {groups}, not in the "
                                     f"{bucket} bucket only")
            out[name] = {"D": D, "engine_used": last["engine"], "route": last["route"],
                         "dtype": last.get("dtype"), "ndead": stats.ndead, "logZ": stats.logZ,
                         "logZerr": stats.logZerr, "wall_s": wall,
                         "dead_per_s": stats.ndead / wall, "launches": {
                             k: v for k, v in ran.items() if v},
                         "group_launches": groups, "device_frac": last.get("device_frac")}
        for name, ref in (("cuda5", "functor"), ("cuda5_d64", "functor_d64")):
            differ = sorted(k for k in set(files[name]) | set(files[ref])
                            if files[name].get(k) != files[ref].get(k))
            out[name]["files_equal_cuda"] = not differ
            if differ:
                raise AssertionError(f"{name}: the files differ from engine 'cuda''s: {differ}")
        results["run_stream_routes_d160"] = out
        return out

    @phase("run_forced_torch")
    def _():
        """A per-point torch Gaussian (gaussian.ini's likelihood as a user
        writes it, per_point_gaussian, D = 20, nlive 100 as run_ring's torch
        runs, num_repeats 40, precision_criterion 0.001) through run() on
        engine "cuda" (B1's fused route) and on each forced engine with the
        same settings, every count at 0 before each run: each run takes its
        engine's fused route (slice_epoch_v5_fused, slice_epoch_v3_fused,
        slice_epoch_v2_fused) and B2 only, "cuda5" and "cuda3" write the files
        of the "cuda" run byte for byte, and "cuda2" (its own cube, another
        chain) lands within 3 sigma of logZ = 0; the libraries are built
        before the clock."""
        D, nlive = INI["nDims"], 100
        calc = dtype_calc(per_point_gaussian, D, torch.float32)
        low = fused_like.lowering(calc)
        if not isinstance(low, fused_like.Lowered):
            raise AssertionError(f"the per-point Gaussian was not lowered: {low.reason}")
        B_phys = -(-(-(-nlive // 8) * 8) // GRANULE) * GRANULE
        t0 = time.perf_counter()
        G = pallas_slice_v4.choose_group(B_phys, D, n_sm)
        G5 = pallas_slice_v5.packet_group_for(calc, B_phys, D, dev)  # builds B3's libraries
        for engine in ("cuda", "cuda3", "cuda2"):
            low.build([G], engine)
        out = {"build_s": time.perf_counter() - t0, "group": G, "group_v5": G5, "B": B_phys}
        files = {}
        for engine, route in (("cuda", "slice_epoch_fused"), ("cuda5", "slice_epoch_v5_fused"),
                              ("cuda3", "slice_epoch_v3_fused"),
                              ("cuda2", "slice_epoch_v2_fused")):
            files[engine] = {}
            last, stats, wall, ran, _ = route_run(
                f"{engine} d{D}", per_point_gaussian, D, route=route, engine_used=engine,
                files=files[engine], nlive=nlive, num_repeats=INI["num_repeats"],
                do_clustering=False, precision_criterion=0.001,
                **({"engine": engine} if engine != "cuda" else {}))
            add_launches(ran)
            out[engine] = {**route_record(last, stats, wall, ran, 0.0),
                           "route_reason": last.get("route_reason")}
        for engine in ("cuda5", "cuda3"):
            differ = sorted(k for k in set(files[engine]) | set(files["cuda"])
                            if files[engine].get(k) != files["cuda"].get(k))
            out[engine]["files_equal_cuda"] = not differ
            if differ:
                raise AssertionError(f"{engine}: the files differ from engine 'cuda''s: {differ}")
        c2 = out["cuda2"]
        if not abs(c2["logZ"]) < 3 * c2["logZerr"]:
            raise AssertionError(f"cuda2: logZ {c2['logZ']} +/- {c2['logZerr']}, not within 3 "
                                 "sigma of 0")
        results["run_forced_torch"] = out
        return out

    # ---- 7c. the run modes: precision='highest' (the fused route and the
    # traced route in double), maximise and an nlives schedule
    def big_likelihood(theta):
        """tests/test_precision.py's big likelihood per point in torch:
        OFFSET 1e7 plus a normalised Gaussian of sigma 0.1 at the origin
        (ulp(1e7) = 1 in float32), with r^2 derived."""
        r2 = torch.sum(theta ** 2)
        D = theta.shape[-1]
        return BIG["offset"] - D * (math.log(BIG["sigma"]) + 0.5 * math.log(2 * math.pi)) \
            - r2 / (2 * BIG["sigma"] ** 2), [r2]

    @phase("run_highest")
    def _():
        """The big likelihood at gaussian.ini's full width (D = 20, nlive 500,
        num_repeats 40, precision_criterion 0.001) under UniformPrior(-1, 1):
        run(precision='highest') on the card takes the fused route in double
        and B2 in double, and logZ = 1e7 - 20 log 2 within 3 sigma; the same
        model at the default precision raises C13's error before its first
        epoch."""
        D = INI["nDims"]
        prior = UniformPrior(-1, 1)
        kw = dict(nDerived=1, prior=prior, nlive=INI["nlive"], num_repeats=INI["num_repeats"],
                  do_clustering=False, precision_criterion=0.001)
        built = prebuild(big_likelihood, D, INI["nlive"], 1, prior, torch.float64)
        last, stats, wall, ran, _ = route_run(
            "big likelihood", big_likelihood, D,
            kernels=("gram_schmidt_f64", "slice_epoch_fused_f64"), precision="highest", **kw)
        if last.get("dtype") != "float64":
            raise AssertionError(f"the run's dtype is {last.get('dtype')!r}, not float64")
        truth = BIG["offset"] - D * math.log(2.0)
        rec = {**route_record(last, stats, wall, ran, truth), "prebuild": built,
               "dtype": last["dtype"], "chains_dispatched": last.get("chains_dispatched")}
        with tempfile.TemporaryDirectory() as base:
            reset_launches()
            try:
                pt.run(big_likelihood, D, read_resume=False, base_dir=base, seed=SEED,
                       feedback=-1, device="cuda", **kw)
            except ValueError as e:
                if "precision='highest'" not in str(e):
                    raise
                rec["default_precision_error"] = str(e)
            else:
                raise AssertionError("the default precision ran the big likelihood")
            rec["default_precision_launches"] = {k: v for k, v in read_launches().items() if v}
        if any(k.startswith("slice_") for k in rec["default_precision_launches"]):
            raise AssertionError("the default-precision run reached an epoch before raising")
        results["run_highest"] = rec
        return rec

    @phase("run_traced_highest_d40")
    def _():
        """A 40-D normalised Gaussian written with torch.linalg.vector_norm
        (refused by the lowering) at precision='highest': the traced route
        and B2's wide kernel, both in double; logZ = 0 within 3
        sigma (nlive 100, num_repeats 2 D)."""
        D = D40_HIGHEST["nDims"]
        last, stats, wall, ran, _ = route_run(
            "vector_norm d40", vector_norm_gaussian, D, route="slice_step",
            kernels=("gram_schmidt_wide_f64", "slice_step_f64"), precision="highest",
            nlive=D40_HIGHEST["nlive"], num_repeats=D40_HIGHEST["num_repeats"],
            do_clustering=False)
        B_phys = -(-(-(-D40_HIGHEST["nlive"] // 8) * 8) // GRANULE) * GRANULE
        if B_phys != D40_RUN["B"]:
            raise AssertionError(f"the run's batch is {B_phys} lanes, not the {D40_RUN['B']} "
                                 "the kernels were held at")
        if last.get("dtype") != "float64" or "linalg_vector_norm" not in str(
                last.get("route_reason")):
            raise AssertionError(f"dtype {last.get('dtype')!r}, route_reason "
                                 f"{last.get('route_reason')!r}")
        rec = {**route_record(last, stats, wall, ran, 0.0), "dtype": last["dtype"]}
        results["run_traced_highest_d40"] = rec
        return rec

    @phase("run_maximise_nlives")
    def _():
        """gaussian.ini's likelihood per point in torch through run() with
        maximise=True and nlives={-30: 250}: <root>.maximum holds the peak
        (0.5 in every coordinate within 0.02, logL within 0.5 of the
        analytic maximum and no lower than the run's best point), the
        metrics show nlive going from 500 to 250, and no chain ran while
        the schedule moved nlive."""
        D = INI["nDims"]
        built = prebuild(per_point_gaussian, D, INI["nlive"])
        with tempfile.TemporaryDirectory() as base:
            reset_launches()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                pt.run(per_point_gaussian, D, nlive=INI["nlive"], num_repeats=INI["num_repeats"],
                       do_clustering=False, precision_criterion=0.001, maximise=True,
                       nlives={-30.0: 250}, read_resume=False, base_dir=base, seed=SEED,
                       feedback=-1, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = read_launches()
            stats = PolyChordOutput(base, "test")
            recs = read_metrics(base, "test")
            text = open(os.path.join(base, "test.maximum")).read().splitlines()
            best_dead = float(np.loadtxt(os.path.join(base, "test_dead.txt"), ndmin=2)[:, 0].max())
        last = recs[-1]
        if last.get("route") != "slice_epoch_fused" or not only(
                ran, ("gram_schmidt", "slice_epoch_fused")):
            raise AssertionError(f"route {last.get('route')!r}, launches {ran}")
        add_launches(ran)
        max_logL = float(text[text.index("Maximum LogLikelihood:") + 1])
        point = np.array([float(x) for x in text[text.index("Maximum Likelihood point:") + 1]
                          .split()])
        peak = -D * math.log(0.1 * math.sqrt(2 * math.pi))
        lives = [r["nlive"] for r in recs[:-1]]
        checks = {
            "point_within_0.02": bool(point.shape == (D,) and np.all(np.abs(point - 0.5) < 0.02)),
            "max_logL_within_0.5": abs(max_logL - peak) < 0.5,
            "max_logL_at_least_best_point": max_logL >= best_dead,
            "nlive_500_to_250": max(lives) == INI["nlive"] and min(lives) == 250,
            "no_chain_under_the_schedule": last.get("chains_dispatched") == 0,
        }
        if not all(checks.values()):
            raise AssertionError(f"run_maximise_nlives: {checks}; max logL {max_logL}, "
                                 f"best point {best_dead}, point {point.tolist()}, nlive {lives}")
        rec = {"checks": checks, "max_logL": max_logL, "analytic_max_logL": peak,
               "best_dead_logL": best_dead, "max_abs_point_minus_peak":
               float(np.abs(point - 0.5).max()), "nlive_by_record": lives,
               "chains_dispatched": last.get("chains_dispatched"), "ndead": stats.ndead,
               "logZ": stats.logZ, "logZerr": stats.logZerr, "wall_s": wall,
               "launches": {k: v for k, v in ran.items() if v}, "prebuild": built,
               "host_totals_s": last.get("host_totals")}
        pull = stats.logZ / stats.logZerr
        if not abs(pull) < 3.0:
            raise AssertionError(f"logZ {stats.logZ} +/- {stats.logZerr} is {pull:.2f} sigma "
                                 "from 0")
        results["run_maximise_nlives"] = rec
        return rec

    # ---- 8. the ini CLI on ini/gaussian_shells.ini (clustering) -----------
    shells = {}

    @phase("run_gaussian_shells_ini")
    def _():
        base, ini, proc, wall = job_result("shells")
        summary = [ln for ln in proc.stdout.splitlines() if ln.startswith("logZ = ")]
        if not summary:
            raise AssertionError("the CLI printed no summary line")
        recs = read_metrics(base, "gaussian_shells")
        last = recs[-1]
        ran = last["kernel_launches"]
        out = PolyChordOutput(base, "gaussian_shells")
        shells.update(base=base, last=last)
        if last.get("engine") != "cuda":
            raise AssertionError(f"engine_used is {last.get('engine')!r}, not 'cuda'")
        if not only(ran, ("gram_schmidt", "slice_epoch")):
            raise AssertionError(f"the CLI run did not run B1 and B2 (only): {ran}")
        add_launches(ran)
        if not (math.isfinite(out.logZ) and abs(out.logZ - SHELLS_LOGZ) < 3 * out.logZerr):
            raise AssertionError(f"logZ {out.logZ} +/- {out.logZerr} not within 3 sigma "
                                 f"of {SHELLS_LOGZ}")
        max_ncluster = max(r["ncluster"] for r in recs)
        if max_ncluster < 2:
            raise AssertionError("the run never held two clusters")
        local, sides = shell_evidences(out, base, "gaussian_shells")
        if abs(lse(local) - out.logZ) > 0.5:
            raise AssertionError(f"local evidences {local} do not sum to logZ {out.logZ}")
        per_shell = {}
        for side, vals in sides.items():
            if not vals:
                raise AssertionError(f"no cluster on the x = {3.5 * side} shell")
            per_shell[side] = lse(vals)
            if abs(per_shell[side] - (out.logZ - math.log(2.0))) > 2 * out.logZerr + 0.25:
                raise AssertionError(f"shell {side}: local logZ {per_shell[side]}, "
                                     f"expected {out.logZ - math.log(2.0)}")
        return {
            "summary": summary[-1], "engine_used": last["engine"],
            "chained_epochs": last.get("chained_epochs"),
            "chains_voided": last.get("chains_voided"),
            "ndead": last["ndead"], "logZ": last["logZ"], "logZerr": last["logZerr"],
            "analytic_logZ": SHELLS_LOGZ, "max_ncluster": max_ncluster,
            "clusters_retired": len(local), "logZ_shell_minus": per_shell[-1],
            "logZ_shell_plus": per_shell[1], "launches": ran,
            "wall_s": wall, "dead_per_s": last["ndead"] / wall,
            "device_frac": last.get("device_frac"),
            "host_totals_s": last.get("host_totals"),
            "epoch_timers_s": last.get("epoch_timers"),
        }

    # ---- 9. the same settings through run(engine="cuda5") (B3) ------------
    def settings_kw(ini, base, engine):
        """run() keywords of an ini's settings, with base_dir and engine."""
        s, blocks, *_ = read_ini(ini)
        skip = ("nDims", "seed_point", "mesh_shape")
        kw = {k: getattr(s, k) for k in s.__dataclass_fields__ if k not in skip}
        kw.update(engine=engine, base_dir=base)
        return s.nDims, BlockPrior(blocks, s.nDims), kw

    @phase("run_gaussian_shells_v5")
    def _():
        if "last" not in shells:
            raise AssertionError("the CLI run failed; nothing to compare with")
        base = tempfile.mkdtemp(prefix="shells_v5_")
        tmpdirs.append(base)
        D, prior, kw = settings_kw(ini_copy(base, "gaussian_shells"), base, "cuda5")
        reset_launches()
        t0 = time.perf_counter()
        pt.run(gaussian_shells(D), D, prior=prior, device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = read_launches()
        last = read_metrics(base, "gaussian_shells")[-1]
        if last.get("engine") != "cuda5":
            raise AssertionError(f"engine_used is {last.get('engine')!r}, not 'cuda5'")
        if not only(ran, ("gram_schmidt", "slice_epoch_v5")):
            raise AssertionError(f"the run did not run B3 and B2 (only): {ran}")
        groups = ran_above_one("B3", pallas_slice_v5.GROUP_LAUNCHES)
        add_launches(ran)
        cli = shells["last"]
        same = {k: last[k] == cli[k] for k in ("ndead", "logZ", "logZerr")}
        with open(os.path.join(base, "gaussian_shells.txt"), "rb") as f_v5, \
                open(os.path.join(shells["base"], "gaussian_shells.txt"), "rb") as f_cli:
            same["txt"] = f_v5.read() == f_cli.read()
        if not all(same.values()):
            raise AssertionError(f"the cuda5 run differs from the CLI run: {same}")
        return {
            "engine_used": last["engine"], "ndead": last["ndead"], "logZ": last["logZ"],
            "logZerr": last["logZerr"], "identical_to_cli": same, "launches": ran,
            "slice_epoch_v5_launches_by_group": groups,
            "wall_s": wall, "dead_per_s": last["ndead"] / wall,
            "device_frac": last.get("device_frac"),
            "host_totals_s": last.get("host_totals"),
        }

    # ---- 10. the other analytic inis through run_ini, eggbox through the CLI
    zoo = {}

    def oracle_check(name, logZ, logZerr):
        """(oracle, sigma used, pull) of one run; raises beyond 3 sigma."""
        ref, ref_err, _ = ZOO_ORACLES[name]
        sigma = logZerr if ref_err is None else math.hypot(logZerr, ref_err)
        pull = (logZ - ref) / sigma
        if not (math.isfinite(logZ) and abs(pull) < 3.0):
            raise AssertionError(f"{name}: logZ {logZ} +/- {logZerr} is {pull:.2f} sigma "
                                 f"from {ref}")
        return ref, sigma, pull

    def zoo_record(name, base, wall, ran, via):
        last = read_metrics(base, name)[-1]
        if last.get("engine") != "cuda":
            raise AssertionError(f"{name}: engine_used is {last.get('engine')!r}, not 'cuda'")
        if not only(ran, ("gram_schmidt", "slice_epoch")):
            raise AssertionError(f"{name}: the run did not run B1 and B2 (only): {ran}")
        ref, sigma, pull = oracle_check(name, last["logZ"], last["logZerr"])
        return {
            "via": via, "engine_used": last["engine"], "ndead": last["ndead"],
            "logZ": last["logZ"], "logZerr": last["logZerr"], "oracle": ref,
            "oracle_from": ZOO_ORACLES[name][2], "pull_sigma": pull,
            "launches": {k: v for k, v in ran.items() if v},
            "wall_s": wall, "dead_per_s": last["ndead"] / wall,
            "device_frac": last.get("device_frac"), "host_totals_s": last.get("host_totals"),
        }

    @phase("run_zoo_inis")
    def _():
        out = {}
        for name in ZOO_ORACLES:
            base = tempfile.mkdtemp(prefix=f"{name}_")
            tmpdirs.append(base)
            ini = ini_copy(base, name)
            reset_launches()
            t0 = time.perf_counter()
            with open(os.path.join(OUT, f"{name}.log"), "w") as log, \
                    contextlib.redirect_stdout(log):  # the run's feedback lines
                run_ini(ini)  # the default device: the card
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = read_launches()
            out[name] = zoo_record(name, base, wall, ran, "run_ini")
            add_launches(ran)
            zoo[name] = base
        base, _, proc, wall = job_result("eggbox")
        ran = read_metrics(base, "eggbox")[-1]["kernel_launches"]
        out["eggbox_cli"] = zoo_record("eggbox", base, wall, ran, "python -m polychordlite_tpu_torch")
        add_launches(ran)
        return out

    # ---- 11. himmelblau on B4 (bitwise the B1 run) and on B5 ---------------
    @phase("run_himmelblau_ab")
    def _():
        if "himmelblau" not in zoo:
            raise AssertionError("the run_ini himmelblau run failed; nothing to compare with")
        out = {}
        for engine, kernel in (("cuda3", "slice_epoch_v3"), ("cuda2", "slice_epoch_v2")):
            base = tempfile.mkdtemp(prefix=f"himmelblau_{engine}_")
            tmpdirs.append(base)
            D, prior, kw = settings_kw(ini_copy(base, "himmelblau"), base, engine)
            reset_launches()
            t0 = time.perf_counter()
            with open(os.path.join(OUT, f"himmelblau_{engine}.log"), "w") as log, \
                    contextlib.redirect_stdout(log):
                pt.run(himmelblau(D), D, prior=prior, device="cuda", **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = read_launches()
            last = read_metrics(base, "himmelblau")[-1]
            if last.get("engine") != engine:
                raise AssertionError(f"engine_used is {last.get('engine')!r}, not {engine!r}")
            if not only(ran, ("gram_schmidt", kernel)):
                raise AssertionError(f"the {engine} run did not run {kernel} and B2 (only): {ran}")
            by_group = {"cuda3": pallas_slice_v3, "cuda2": pallas_slice}[engine].GROUP_LAUNCHES
            groups = ran_above_one({"cuda3": "B4", "cuda2": "B5"}[engine], by_group)
            add_launches(ran)
            rec = {"engine_used": engine, "ndead": last["ndead"], "logZ": last["logZ"],
                   "logZerr": last["logZerr"], "launches": {k: v for k, v in ran.items() if v},
                   "wall_s": wall, "dead_per_s": last["ndead"] / wall,
                   "device_frac": last.get("device_frac"),
                   f"{kernel}_launches_by_group": groups}
            if engine == "cuda3":  # the same decisions: the B1 run, bit for bit
                ref = read_metrics(zoo["himmelblau"], "himmelblau")[-1]
                same = {k: last[k] == ref[k] for k in ("ndead", "logZ", "logZerr")}
                with open(os.path.join(base, "himmelblau.txt"), "rb") as f, \
                        open(os.path.join(zoo["himmelblau"], "himmelblau.txt"), "rb") as g:
                    same["txt"] = f.read() == g.read()
                if not all(same.values()):
                    raise AssertionError(f"the cuda3 run differs from the cuda run: {same}")
                rec["identical_to_cuda"] = same
            else:  # another chain (v2's cube): held to the analytic evidence
                rec["oracle"], _, rec["pull_sigma"] = oracle_check(
                    "himmelblau", last["logZ"], last["logZerr"])
            out[engine] = rec
        return out

    # ---- 11b. speed grades: gaussian.ini's settings with two grades through
    # the ini CLI (B1's functor route), and a GradedLikelihood through run()
    # (the graded route), beside its monolithic form (the fused route)
    def nlike_by_grade(base: str, root: str):
        with open(os.path.join(base, f"{root}.stats")) as f:
            line = [ln for ln in f.read().splitlines() if ln.startswith(" nlike:")][0]
        return [int(x) for x in line.split()[1:]]

    @phase("run_grades_ini")
    def _():
        """The ini CLI on gaussian.ini with two speed grades (graded_ini_copy):
        B1's functor route and B2 at dims 20 and 14, logZ within 3 sigma of
        0, the .stats nlike line two counts, the fast grade's the larger."""
        base, ini, proc, wall = job_result("grades")
        s, *_ = read_ini(ini)
        if (list(s.grade_dims), list(s.grade_frac)) != (GRADED["grade_dims"],
                                                      [float(g) for g in GRADED["grade_frac"]]):
            raise AssertionError(f"the ini reads grade_dims {s.grade_dims}, grade_frac "
                                 f"{s.grade_frac}")
        last = read_metrics(base, "gaussian")[-1]
        ran = last["kernel_launches"]
        if (last.get("engine"), last.get("route")) != ("cuda", "slice_epoch"):
            raise AssertionError(f"engine {last.get('engine')!r}, route {last.get('route')!r}")
        if not only(ran, ("gram_schmidt", "slice_epoch")):
            raise AssertionError(f"the CLI run did not run B1 and B2 (only): {ran}")
        add_launches(ran)
        out = PolyChordOutput(base, "gaussian")
        counts = nlike_by_grade(base, "gaussian")
        if not (len(counts) == 2 and 0 < counts[0] < counts[1]):
            raise AssertionError(f"the .stats nlike line is {counts}")
        if not (math.isfinite(out.logZ) and abs(out.logZ) < 3 * out.logZerr):
            raise AssertionError(f"logZ {out.logZ} +/- {out.logZerr} is not within 3 sigma of 0")
        return {"engine_used": last["engine"], "route": last["route"],
                "chained_epochs": last.get("chained_epochs"), "ndead": out.ndead,
                "logZ": out.logZ, "logZerr": out.logZerr, "pull_sigma": out.logZ / out.logZerr,
                "nlike_by_grade": counts, "wall_s": wall, "dead_per_s": out.ndead / wall,
                "launches": {k: v for k, v in ran.items() if v},
                "device_frac": last.get("device_frac"), "host_totals_s": last.get("host_totals")}

    @phase("run_graded")
    def _():
        """graded_model's GradedLikelihood through run() on the card with
        gaussian.ini's settings at nlive 250 and grade_dims [6, 14],
        grade_frac [8, 32]:
        engine "scan", the graded route and B2 only, no chain, at the batch
        graded_step held (GRADED_RUN); then the same likelihood as one
        callable on the route engine="cuda" picks for it (the fused route);
        each within 3 sigma of logZ = 0 and the two within 3 combined sigma;
        the share of the rows evaluated (probes and the epoch records'
        babies) that ran slow_fn.  Then time_speeds on the graded calc with
        grade_frac [0.25, 0.75]: the full calc more than twice the fast
        part's time."""
        graded, monolithic, calc, _ = graded_model()
        D = GRADED["nDims"]
        kw = dict(nlive=GRADED["nlive"], num_repeats=sum(GRADED["grade_frac"]),
                  grade_dims=GRADED["grade_dims"], grade_frac=GRADED["grade_frac"],
                  do_clustering=False, precision_criterion=0.001)
        with tempfile.TemporaryDirectory() as base:
            reset_launches()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                pt.run(graded, D, read_resume=False, base_dir=base, seed=SEED, feedback=-1,
                       device="cuda", **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = read_launches()
            stats = PolyChordOutput(base, "test")
            last = read_metrics(base, "test")[-1]
            counts = nlike_by_grade(base, "test")
        if (last.get("engine"), last.get("route")) != ("scan", "slice_step_graded"):
            raise AssertionError(f"engine {last.get('engine')!r}, route {last.get('route')!r}")
        if not only(ran, ("gram_schmidt", "slice_step_graded")):
            raise AssertionError(f"the graded run did not run B2 and the graded route (only): "
                                 f"{ran}")
        if last.get("chained_epochs") is not False:
            raise AssertionError("a graded run dispatched chained epochs")
        if not (len(counts) == 2 and 0 < counts[0] < counts[1]
                and last["nlike_per_grade"] == counts):
            raise AssertionError(f"nlike by grade {counts}, metrics {last['nlike_per_grade']}")
        add_launches(ran)
        gr = last["graded_route"]
        B_phys = -(-(-(-GRADED["nlive"] // 8) * 8) // GRANULE) * GRANULE
        if B_phys != GRADED_RUN["B"]:
            raise AssertionError(f"the run's batch is {B_phys} lanes, not the "
                                 f"{GRADED_RUN['B']} the graded route was held at")
        # the rows the likelihood was evaluated on: the probes, and the
        # babies of the epoch records; slow_fn ran on the full calc's rows
        # and on the refreshes of the cached intermediate
        rows = ((gr["rounds_full"] + gr["rounds_fast"]) * B_phys + gr["assembly_rows"]
                + gr["assembly_fast_rows"])
        slow_rows = gr["rounds_full"] * B_phys + gr["aux_rows"] + gr["assembly_rows"]
        graded_rec = {"ndead": stats.ndead, "logZ": stats.logZ, "logZerr": stats.logZerr,
                      "pull_sigma": stats.logZ / stats.logZerr, "wall_s": wall,
                      "dead_per_s": stats.ndead / wall, "device_frac": last.get("device_frac"),
                      "nlike_by_grade": counts, "graded_route": gr,
                      "slow_fn_rows": slow_rows, "rows": rows,
                      "slow_share_of_rows": slow_rows / max(rows, 1),
                      "launches": {k: v for k, v in ran.items() if v},
                      "host_totals_s": last.get("host_totals"),
                      "epoch_timers_s": last.get("epoch_timers")}
        if not abs(graded_rec["pull_sigma"]) < 3.0:
            raise AssertionError(f"graded logZ {stats.logZ} +/- {stats.logZerr} is not within "
                                 "3 sigma of 0")
        built = prebuild(monolithic, D, GRADED["nlive"])
        last_m, stats_m, wall_m, ran_m, _ = route_run("graded_monolithic", monolithic, D, **kw)
        mono_rec = {**route_record(last_m, stats_m, wall_m, ran_m, 0.0), "prebuild": built,
                    "nlike_by_grade": last_m["nlike_per_grade"],
                    "slow_share_of_rows": 1.0}  # the whole likelihood at every row
        both = math.hypot(stats.logZerr, stats_m.logZerr)
        if not abs(stats.logZ - stats_m.logZ) < 3 * both:
            raise AssertionError(f"graded logZ {stats.logZ} and monolithic {stats_m.logZ} "
                                 f"differ by more than 3 combined sigma ({both})")
        s = PolyChordSettings(D, 0, grade_dims=GRADED["grade_dims"], grade_frac=[0.25, 0.75],
                              num_repeats=kw["num_repeats"]).finalise()
        speeds = time_speeds(calc, s, torch.Generator(dev).manual_seed(SEED))
        rti = types.SimpleNamespace()
        assign_num_repeats(s, rti, speeds)
        if not speeds[0] > 2 * speeds[1]:
            raise AssertionError(f"time_speeds {speeds.tolist()}: the full calc is not twice "
                                 "the fast part's time")
        rec = {"graded": graded_rec, "monolithic": mono_rec,
               "graded_over_monolithic_wall": wall / wall_m,
               "time_speeds_s_per_row": speeds.tolist(),
               "time_speeds_ratio": float(speeds[0] / speeds[1]),
               "time_speeds_num_repeats": [int(n) for n in rti.num_repeats]}
        results["run_graded"] = rec
        return rec

    # ---- 11c. host-callback likelihoods and the C ABI through the port ----
    def batch_of(nlive):
        """The physical batch run() gives the kernels at nlive."""
        return -(-(-(-nlive // 8) * 8) // GRANULE) * GRANULE

    def host_run_record(name, last, stats, wall, truth, held, nlive):
        """Checks and record of a run on the host route: engine "scan", route
        "slice_step_host", B2 and the host route the only kernels, at the
        batch host_route held (``held``, which nlive must give), within 3
        sigma of ``truth``."""
        ran = {k: v for k, v in last["kernel_launches"].items() if v}
        if (last.get("engine"), last.get("route")) != ("scan", "slice_step_host"):
            raise AssertionError(f"{name}: engine {last.get('engine')!r}, route "
                                 f"{last.get('route')!r} ({last.get('route_reason')})")
        if set(ran) != {"gram_schmidt", "slice_step_host"}:
            raise AssertionError(f"{name}: the path did not run B2 and the host route (only): "
                                 f"{ran}")
        if last.get("chained_epochs") is not False:
            raise AssertionError(f"{name}: a callback run dispatched chained epochs")
        if (batch_of(nlive), min(nlive, held["B"])) != (held["B"], held["B_valid"]):
            raise AssertionError(f"{name}: the run's batch is {batch_of(nlive)} lanes, not the "
                                 f"{held['B']} ({held['B_valid']} valid) the host route was "
                                 "held at")
        pull = (stats.logZ - truth) / stats.logZerr
        if not (math.isfinite(stats.logZ) and abs(pull) < 3.0):
            raise AssertionError(f"{name}: logZ {stats.logZ} +/- {stats.logZerr} is "
                                 f"{pull:.2f} sigma from {truth}")
        add_launches(ran)
        host = last["host_route"]
        rounds = max(host["rounds"], 1)
        return {"engine_used": last["engine"], "route": last["route"],
                "route_reason": last.get("route_reason"), "form": last["form"],
                "ndead": stats.ndead, "logZ": stats.logZ, "logZerr": stats.logZerr,
                "oracle": truth, "pull_sigma": pull, "wall_s": wall,
                "dead_per_s": stats.ndead / wall, "device_frac": last.get("device_frac"),
                "host_calls": last["host_calls"], "host_route": host,
                "host_us_per_round": {k[:-2]: host[k] * 1e6 / rounds
                                      for k in ("launch_s", "copy_out_s", "user_s",
                                                "copy_in_s")},
                "launches": ran, "host_totals_s": last.get("host_totals"),
                "epoch_timers_s": last.get("epoch_timers")}

    @phase("run_callback")
    def _():
        """The reference quickstart written with numpy (4-D, sigma 0.1,
        UniformPrior(-1, 1), r^2 derived; bench.py's quickstart, nlive
        200) through run() with the default engine on the card: engine
        "scan" on the host route; logZ = -4 log 2 within 3 sigma."""
        def quickstart(theta):
            theta = np.asarray(theta, dtype=np.float64)
            r2 = float(np.sum(theta ** 2))
            return -math.log(2 * math.pi * 0.1 * 0.1) * 2.0 - r2 / 2 / 0.1 ** 2, [r2]

        with tempfile.TemporaryDirectory() as base:
            reset_launches()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                pt.run(quickstart, 4, nDerived=1, prior=UniformPrior(-1, 1),
                       nlive=QUICK_RUN["B_valid"], read_resume=False, base_dir=base,
                       seed=SEED, feedback=-1, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stats = PolyChordOutput(base, "test")
            last = read_metrics(base, "test")[-1]
        rec = host_run_record("run_callback", last, stats, wall, -4 * math.log(2.0), QUICK_RUN,
                              QUICK_RUN["B_valid"])
        results["run_callback"] = rec
        return rec

    @phase("run_gaussian_d64")
    def _():
        """gaussian.ini's settings at D = 64 (nlive 250, no clustering,
        precision_criterion 0.001, num_repeats 2 D, 64 uniform [0, 1]
        parameters), the likelihood per point in torch, run in a process of
        its own (d64_run, started with the CLI runs): the fused route in the
        128 bucket and B2's wide kernel, with chained epochs; logZ = 0 (the
        mass outside the cube is below 4e-5), gated at 3 sigma."""
        D = D64["nDims"]
        base, proc, _ = job_result("d64")
        wall = json.loads([ln for ln in proc.stdout.splitlines()
                           if ln.startswith("RESULT ")][-1][len("RESULT "):])["wall_s"]
        stats = PolyChordOutput(base, "test")
        last = read_metrics(base, "test")[-1]
        ran = {k: v for k, v in last["kernel_launches"].items() if v}
        if (last.get("engine"), last.get("route")) != ("cuda", "slice_epoch_fused"):
            raise AssertionError(f"engine {last.get('engine')!r}, route {last.get('route')!r} "
                                 f"({last.get('route_reason')}), not slice_epoch_fused")
        if last.get("chained_epochs") is not True:
            raise AssertionError("chained epochs were switched off during the run")
        if not only(ran, ("gram_schmidt_wide", "slice_epoch_fused")):
            raise AssertionError(f"the path did not run B2 wide and the fused route (only): {ran}")
        add_launches(ran)
        # the libraries the run loaded, built before it (slice_epoch_d128)
        built = prebuild(per_point_gaussian, D, D64["nlive"])
        groups = last.get("group_launches") or {}
        if last["form"] != "per_point" or not groups or any(
                not k.startswith(f"{pallas_slice_v4.SLICE_MAXD_WIDE}/") for k in groups):
            raise AssertionError(f"form {last['form']!r}, B1's launches by bucket/G {groups}: "
                                 "not the per-point model in the 128 bucket")
        B_phys = -(-(-(-D64["nlive"] // 8) * 8) // GRANULE) * GRANULE
        if B_phys != D64_RUN["B"]:
            raise AssertionError(f"the run's batch is {B_phys} lanes, not the {D64_RUN['B']} "
                                 "the kernels were held at")
        rec = {**route_record(last, stats, wall, ran, 0.0), "prebuild": built,
               "group_launches": groups, "B": B_phys,
               "epoch_record_mb": B_phys * D64["num_repeats"] * (2 * D + 2) * 4 / 1e6}
        results["run_gaussian_d64"] = rec
        return rec

    @phase("run_quickstart_example")
    def _():
        """The port's examples/quickstart.py in a process of its own (started
        behind the 64-D run): the per-point torch quickstart on the fused
        route and B2, logZ = -4 log 2, gated at 3 sigma."""
        base, proc, wall = job_result("quickstart_example")
        chains = os.path.join(base, "chains")
        stats = PolyChordOutput(chains, "gaussian")
        last = read_metrics(chains, "gaussian")[-1]
        ran = {k: v for k, v in last["kernel_launches"].items() if v}
        if (last.get("engine"), last.get("route")) != ("cuda", "slice_epoch_fused"):
            raise AssertionError(f"engine {last.get('engine')!r}, route {last.get('route')!r} "
                                 f"({last.get('route_reason')}), not slice_epoch_fused")
        if not only(ran, ("gram_schmidt", "slice_epoch_fused")):
            raise AssertionError(f"the example did not run B2 and the fused route (only): {ran}")
        add_launches(ran)
        if "analytic logZ" not in proc.stdout:
            raise AssertionError(f"the example printed no result: {proc.stdout[-2000:]}")
        return {**route_record(last, stats, wall, ran, -4 * math.log(2.0)),
                "process_wall_s": wall}

    @phase("plain_checks")
    def _():
        """The comparisons the phases left here (check_later): their kernels'
        outputs against the plain versions that the host's CPU workers ran
        beside the card's phases, bitwise; what each found, and the seconds
        spent waiting for the workers."""
        t0 = time.perf_counter()
        out, errors, waited = {}, {}, 0.0
        for tag, futs, check in deferred:
            try:
                t1 = time.perf_counter()
                res = {k: plain_result(f) for k, f in futs.items()}
                waited += time.perf_counter() - t1
                out[tag] = check(res)
            except Exception as e:  # every check runs; the phase fails at the end
                traceback.print_exc()
                errors[tag] = f"{type(e).__name__}: {e}"
        out.update(checks=len(deferred), wait_s=waited, seconds=time.perf_counter() - t0,
                   workers=PLAIN_WORKERS)
        if errors:
            raise AssertionError(f"plain checks failed: {errors}")
        return out

    @phase("run_gaussian_d160")
    def _():
        """A per-point torch Gaussian at D = 160 (sigma 0.2 at 0.5, uniform
        prior on [0, 1]^160), nlive 200, num_repeats 800, engine "auto", run
        in a process of its own (d160_run, started before section 7): the
        fused route in the stream bucket and B2's long kernel, with chained
        epochs; logZ = 160 log erf(2.5 / sqrt 2), gated at 3 sigma."""
        D = D160["nDims"]
        base, proc, _ = job_result("d160")
        wall = json.loads([ln for ln in proc.stdout.splitlines()
                           if ln.startswith("RESULT ")][-1][len("RESULT "):])["wall_s"]
        stats = PolyChordOutput(base, "test")
        last = read_metrics(base, "test")[-1]
        ran = {k: v for k, v in last["kernel_launches"].items() if v}
        if (last.get("engine"), last.get("route")) != ("cuda", "slice_epoch_fused"):
            raise AssertionError(f"engine {last.get('engine')!r}, route {last.get('route')!r} "
                                 f"({last.get('route_reason')}), not slice_epoch_fused")
        if last.get("chained_epochs") is not True:
            raise AssertionError("chained epochs were switched off during the run")
        if not only(ran, ("gram_schmidt_long", "slice_epoch_fused")):
            raise AssertionError(f"the path did not run B2 long and the fused route (only): {ran}")
        add_launches(ran)
        groups = last.get("group_launches") or {}
        if last["form"] != "per_point" or not groups or any(
                not k.startswith(f"{pallas_slice_v4.STREAM}/") for k in groups):
            raise AssertionError(f"form {last['form']!r}, B1's launches by bucket/G {groups}: "
                                 "not the per-point model in the stream bucket")
        B_phys = -(-(-(-D160["nlive"] // 8) * 8) // GRANULE) * GRANULE
        if B_phys != D160_RUN["B"]:
            raise AssertionError(f"the run's batch is {B_phys} lanes, not the {D160_RUN['B']} "
                                 "the kernels were held at")
        rec = {**route_record(last, stats, wall, ran, D160_LOGZ), "group_launches": groups,
               "B": B_phys, "nlive": D160["nlive"], "num_repeats": D160["num_repeats"],
               "epoch_record_mb": B_phys * D160["num_repeats"] * (2 * D + 1) * 4 / 1e6}
        results["run_gaussian_d160"] = rec
        return rec

    @phase("capi_cc")
    def _():
        """examples/cc/gaussian_cc.cpp, unchanged, through the port's C++
        layer (cabi/polychord.hpp over the C shim) at its own settings
        (20-D, nlive 200, num_repeats 40, seed 17): as a program that embeds
        the interpreter where this Python has a shared libpython, else in
        this process through ctypes.PyDLL (the choice printed); the run on
        the card's host route, logZ = 0 within 3 sigma."""
        mode = "embedded" if jobs["capi_cc"].result() is not None else "in_process"
        print(f"capi_cc: build mode {mode}", flush=True)
        if mode == "embedded":
            base, build_s, proc, wall = job_result("capi_cc")
            dumps = [ln for ln in proc.stdout.splitlines() if ln.startswith("dumper:")]
        else:
            import ctypes

            base = tempfile.mkdtemp(prefix="capi_cc_")
            tmpdirs.append(base)
            t0 = time.perf_counter()
            so = cabi.build_in_process("gaussian_cc_in_process", [cabi.EXAMPLE], cpp=True,
                                       defines=["main=gaussian_cc_main"])
            entry = getattr(ctypes.PyDLL(str(so)), "_Z16gaussian_cc_mainv")  # C++ name
            entry.argtypes, entry.restype = [], ctypes.c_int
            build_s = time.perf_counter() - t0
            cwd = os.getcwd()
            os.chdir(base)
            t0 = time.perf_counter()
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    entry()
            finally:
                os.chdir(cwd)
            wall = time.perf_counter() - t0
            dumps = []  # printed by C stdio, not Python's stdout
        chains = os.path.join(base, "chains")
        stats = PolyChordOutput(chains, "gaussian_cc")
        recs = read_metrics(chains, "gaussian_cc")
        # the example sets its own nlive: the live points of its first record
        rec = host_run_record("capi_cc", recs[-1], stats, wall, 0.0, CC_RUN, recs[0]["nlive"])
        rec.update(build_mode=mode, build_s=build_s, dumper_lines=len(dumps),
                   last_dumper_line=dumps[-1] if dumps else None)
        results["capi_cc"] = rec
        return rec

    def data_ini_run(name):
        """python -m polychordlite_tpu_torch on a copy of ini/<name>.ini
        (base_dir and seed added; its data_dir = data read from the
        repository): engine "cuda" on the fused route (its functor's data
        loop) and B2 only, at the batch data_driven_step held (whose
        libraries it reuses), within 3 combined sigma of the JAX package's
        CPU run."""
        base, ini, proc, wall = job_result(name)
        s, *_ = read_ini(ini)
        held = DATA_RUNS[name]
        if (batch_of(s.nlive), s.num_repeats, s.nDims) != (held["B"], held["R"], held["D"]):
            raise AssertionError(f"{name}: the run's batch {batch_of(s.nlive)}, R "
                                 f"{s.num_repeats}, D {s.nDims} are not those held")
        summary = [ln for ln in proc.stdout.splitlines() if ln.startswith("logZ = ")]
        last = read_metrics(base, name)[-1]
        ran = {k: v for k, v in last["kernel_launches"].items() if v}
        if (last.get("engine"), last.get("route")) != ("cuda", "slice_epoch_fused"):
            raise AssertionError(f"{name}: engine {last.get('engine')!r}, route "
                                 f"{last.get('route')!r} ({last.get('route_reason')})")
        if not only(ran, ("gram_schmidt", "slice_epoch_fused")):
            raise AssertionError(f"{name}: the run did not run B2 and the fused route (only): "
                                 f"{ran}")
        add_launches(ran)
        out = PolyChordOutput(base, name)
        ref, ref_err, seed, commit, how = DATA_ORACLES[name]
        both = math.hypot(out.logZerr, ref_err)
        pull = (out.logZ - ref) / both
        if not (math.isfinite(out.logZ) and abs(pull) < 3.0):
            raise AssertionError(f"{name}: logZ {out.logZ} +/- {out.logZerr} is {pull:.2f} "
                                 f"combined sigma from the oracle {ref} +/- {ref_err}")
        rec = {"summary": summary[-1] if summary else None, "engine_used": last["engine"],
               "route": last["route"], "route_reason": last.get("route_reason"),
               "form": last.get("form"), "chained_epochs": last.get("chained_epochs"),
               "ndead": out.ndead, "logZ": out.logZ, "logZerr": out.logZerr,
               "oracle": {"logZ": ref, "logZerr": ref_err, "seed": seed, "commit": commit,
                          "from": how},
               "pull_combined_sigma": pull, "wall_s": wall, "dead_per_s": out.ndead / wall,
               "device_frac": last.get("device_frac"), "launches": ran,
               "fused_build_seconds": last.get("fused_build_seconds"),
               "host_totals_s": last.get("host_totals"),
               "epoch_timers_s": last.get("epoch_timers")}
        results[f"run_{name}_ini"] = rec
        return rec

    @phase("run_fitting_ini")
    def _():
        return data_ini_run("fitting")

    @phase("run_object_detection_ini")
    def _():
        return data_ini_run("object_detection")

    # ---- 12. the structure-cost studies (E3, E2, E6, E7) ------------------
    # Each phase holds its kernel against its plain version (and the kernels
    # making the same decisions) on the card, then runs its study at full
    # size with that kernel's count set to 0 just before and read just after.
    def study_inputs():
        return slice_inputs(dev, BENCH["B"], BENCH["R"], BENCH["D"], 0)

    STUDY_GEOMETRIES = (("small", SMALL), ("gaussian_ini", RUN), ("bench", BENCH))

    @phase("lockstep_waste")
    def _():
        out = {}
        for tag, geo in STUDY_GEOMETRIES:
            calc, cfg, args = geometry(tag, geo)
            kw = (0x01234567, 0x89ABCDEF)
            got = pallas_slice.slice_epoch_v2_counted(calc, cfg, kw, *args)
            b5 = pallas_slice.slice_epoch_v2(calc, cfg, kw, *args)
            want = pallas_slice.slice_records_lockstep_plain(
                lambda p: calc(p)[2], cfg, kw, *args, count_steps=True)  # noqa: B023
            names = ("t", "logL", "nlike", "cube", "steps", "iters")
            out[tag] = {"B": geo["B"], "R": geo["R"], "mismatches": decisions(
                f"{tag}: E3 differs",
                [(f"{k}_vs_plain", a, b) for k, a, b in zip(names, got, want)]
                + [(f"{k}_vs_B5", a, b) for k, a, b in zip(names, got, b5)]),
                "iters_sum": int(got[5].sum()),
                "ms": cuda_ms(lambda: pallas_slice.slice_epoch_v2_counted(  # noqa: B023
                    calc, cfg, kw, *args), 5),  # noqa: B023
                "b5_ms": cuda_ms(lambda: pallas_slice.slice_epoch_v2(  # noqa: B023
                    calc, cfg, kw, *args), 5)}  # noqa: B023
        calc, cfg, kw, args = study_inputs()
        pallas_slice.LAUNCHES["slice_epoch_v2_counted"] = 0
        rec = prof_lockstep_waste.main()
        study = pallas_slice.LAUNCHES["slice_epoch_v2_counted"]
        _, plain_ms = cuda_once(lambda: pallas_slice.slice_records_lockstep_plain(
            lambda p: calc(p)[2], cfg, kw, *args, count_steps=True))
        B, R, D = BENCH["B"], BENCH["R"], BENCH["D"]
        results["lockstep_waste"] = {
            "ms": rec["ms"], "plain_ms": plain_ms, "max_abs_err": 0.0, "launches": study,
            "lane_efficiency": rec["lane_efficiency"],
            "bound": bound(slice_epoch_bytes(B, R, D, cube=True) + 4 * (R * B + R),
                           rec["lane_steps"] * gaussian_probe_flops(D))}
        return {"checks": out, "study": rec, "study_launches": study, "plain_ms": plain_ms}

    @phase("v3_iters")
    def _():
        out = {}
        for tag, geo in STUDY_GEOMETRIES:
            B, D = geo["B"], geo["D"]
            calc, cfg, args = geometry(tag, geo)
            kw = (0x01234567, 0x89ABCDEF)
            G0 = pallas_slice_v4.choose_group(B, D, n_sm)
            want = pallas_slice_v3.slice_records_window_plain(
                lambda p: calc(p)[2], cfg, kw, *args, count_iters=True)  # noqa: B023
            b1 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
            cheap = v3_instr.slice_epoch_v3_instr(calc, cfg, kw, *args, cheap=True)
            names = ("t", "logL", "nlike", "iters")
            pairs = [("cheap_iters_not_1", cheap[3], torch.ones_like(cheap[3]))]
            blocks_per_sm, refused = {}, []
            for G in GROUPS:  # every G whose grid is co-resident; the others refused
                blocks_per_sm[G] = v3_instr.resident_blocks(calc, D, dev, G)
                if not v3_instr.co_resident(calc, B, D, dev, G):
                    try:
                        v3_instr.slice_epoch_v3_instr(calc, cfg, kw, *args, group=G)
                    except RuntimeError as e:
                        if "resident" not in str(e):
                            raise
                    else:
                        raise AssertionError(f"{tag}: E2 at G={G} launched a grid that is "
                                             "not co-resident")
                    refused.append(G)
                    continue
                got = v3_instr.slice_epoch_v3_instr(calc, cfg, kw, *args, group=G)
                b4 = pallas_slice_v3.slice_epoch_v3(calc, cfg, kw, *args, group=G)
                pairs += [(f"{k}_G{G}_vs_plain", a, b) for k, a, b in zip(names, got, want)]
                pairs += [(f"{k}_G{G}_vs_{o}", a, b) for o, ref in (("B4", b4), ("B1", b1))
                          for k, a, b in zip(names[:3], got, ref)]
            if G0 in refused or 1 in refused:
                raise AssertionError(f"{tag}: E2 at B4's G = {G0} or at G = 1 is not "
                                     f"co-resident ({blocks_per_sm} blocks per SM)")
            out[tag] = {"B": B, "R": geo["R"], "group": G0, "iters_sum": int(want[3].sum()),
                        "resident_blocks_per_sm_by_group": blocks_per_sm,
                        "refused_groups": refused,
                        "mismatches": decisions(f"{tag}: E2 differs", pairs)}
            out[tag].update({  # the same kernel unchecked (no wait for its flag), and B4
                form: cuda_ms(lambda c=c, G=G: v3_instr.slice_epoch_v3_instr(  # noqa: B023
                    calc, cfg, kw, *args, cheap=c, check=False, group=G), 5)  # noqa: B023
                for form, c, G in (("ms", False, G0), ("g1_ms", False, 1),
                                   ("cheap_ms", True, 1))})
            for form, G in (("b4_ms", G0), ("b4_g1_ms", 1)):
                out[tag][form] = cuda_ms(lambda G=G: pallas_slice_v3.slice_epoch_v3(  # noqa: B023
                    calc, cfg, kw, *args, group=G), 5)  # noqa: B023
        calc, cfg, kw, args = study_inputs()
        v3_instr.LAUNCHES["slice_epoch_v3_instr"] = 0
        rec = prof_v3_iters.main()
        study = v3_instr.LAUNCHES["slice_epoch_v3_instr"]
        _, plain_ms = cuda_once(lambda: pallas_slice_v3.slice_records_window_plain(
            lambda p: calc(p)[2], cfg, kw, *args, count_iters=True))
        # what the simulation projects beside what E1 and E3 measured
        steps, wmax = pallas_slice_v4.slice_epoch_counted(calc, cfg, kw, *args)[3:]
        sim = sim_iter_distribution.main()
        projections = {
            "sim_lockstep_lane_efficiency": {W: v["lane_efficiency"]
                                             for W, v in sim["lockstep"].items()},
            "sim_free_running_lane_efficiency": {W: v["lane_efficiency"]
                                                 for W, v in sim["free_running"].items()},
            "E1_lane_efficiency_study_inputs": pallas_slice_v4.lane_efficiency(steps, wmax),
            "E1_lane_efficiency_bench": results["lane_efficiency"]["lane_efficiency"],
            "E3_lane_efficiency": results.get("lockstep_waste", {}).get("lane_efficiency"),
        }
        B, R, D = BENCH["B"], BENCH["R"], BENCH["D"]
        results["v3_iters"] = {
            "ms": rec["real"]["ms"], "g1_ms": rec["real_g1"]["ms"], "group": rec["group"],
            "plain_ms": plain_ms, "max_abs_err": 0.0, "launches": study,
            "bound": bound(slice_epoch_bytes(B, R, D) + 4 * (R + 1),
                           int(steps.sum()) * gaussian_probe_flops(D))}
        return {"checks": out, "study": rec, "study_launches": study, "plain_ms": plain_ms,
                "projections": projections, "simulation": sim}

    @phase("grid_overhead")
    def _():
        g = prof_grid_overhead
        R, D, S = g.SIZES["R"], g.SIZES["D"], g.SIZES["S"]
        stream, head, x0 = g.grid_inputs(dev, R, D, S, ones=False, seed=SEED)
        decisions("E6 differs from its plain version", [
            (v, g.grid_steps(v, stream, head, x0), g.grid_steps_plain(v, stream, head, x0))
            for v in g.VARIANTS])
        g.LAUNCHES["grid_steps"] = 0
        rec = g.main()
        study = g.LAUNCHES["grid_steps"]
        stream, head, x0 = g.grid_inputs(dev, R, D, S)
        plain_ms = cuda_ms(lambda: g.grid_steps_plain("E", stream, head, x0), 3)
        E = S * g.LANE
        results["grid_overhead"] = {
            "ms": rec["variants"]["E"]["ms"], "plain_ms": plain_ms, "max_abs_err": 0.0, "launches": study,
            "bound": bound(4 * (R * D * E + 3 * D * E + D * E + R * E), 3 * R * E)}
        return {"study": rec, "study_launches": study, "plain_ms_E": plain_ms}

    @phase("while_cost")
    def _():
        w = prof_pallas_while
        S, n = w.SIZES["S"], w.SIZES["n"]
        x = 0.2 + 0.6 * torch.rand((S, w.LANE), generator=torch.Generator(dev).manual_seed(SEED),
                                   device=dev)
        short = 2000  # every body held to its plain version over this many iterations
        decisions("E7 differs from its plain version", [
            (v, w.while_loop(v, x, short), w.while_loop_plain(v, x, short))
            for v in w.VARIANTS])
        w.LAUNCHES["while_loop"] = 0
        rec = w.main()
        study = w.LAUNCHES["while_loop"]
        # body20 at full length: the kernel against one timed plain run (on
        # the host, since the build phase)
        zeros = torch.zeros((S, w.LANE), device=dev)
        want, plain_ms = plain_result(e7_plain)
        decisions("E7 body20 differs at full length", [("body20", w.while_loop("body20", zeros, n),
                                                         want.to(dev))])
        E = S * w.LANE
        results["while_cost"] = {
            "ms": rec["variants"]["body20"]["ms"], "plain_ms": plain_ms, "max_abs_err": 0.0,
            "launches": study,
            "bound": bound(4 * (E + w.BODY20_D * E + E), n * E * (5 * w.BODY20_D + 3))}
        return {"study": rec, "study_launches": study, "plain_ms_body20": plain_ms,
                "plain_device": "cpu", "checked_iterations": {"all": short, "body20": n}}

    # ---- 13. the prototypes (E4, E5) ---------------------------------------
    def max_err(got, want):
        return max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))

    @phase("proto_epoch")
    def _():
        e = pallas_epoch_v2
        D = e.SIZES["D"]
        seed = torch.tensor([1234], dtype=torch.int32, device=dev)
        out, errs = {}, []
        for tag, S, R in (("small", SMALL["B"] // e.LANE, SMALL["R"]),
                          ("full", e.SIZES["S"], e.SIZES["R"])):
            args = e.study_inputs(dev, D, S, R, seed=SEED)
            got = e.proto_epoch(seed, *args)
            (*want, steps), plain_ms = cuda_once(
                lambda: e.proto_epoch_plain(seed, *args, count_steps=True))  # noqa: B023
            mism = decisions(f"{tag}: E4 differs from its plain version",
                             list(zip(("cube", "logL", "nlike"), got, want)))
            errs.append(max_err(got, want))
            steps = steps.to(torch.int64)
            out[tag] = {
                "B": S * e.LANE, "R": R, "D": D, "mismatches": mism, "evals": int(got[2].sum()),
                "accepted_frac": float((got[1] > e.LOGZERO).float().mean()),
                "lane_iterations_sum": int(steps.sum()),
                "lane_iterations_max": int(steps.sum(0).max()),
                "lockstep_iterations": int(steps.flatten(1).max(1).values.sum()),
                "ms": cuda_ms(lambda: e.proto_epoch(seed, *args), 5),  # noqa: B023
                "plain_ms": plain_ms}
        full = out["full"]
        full["us_per_lane_iteration"] = full["ms"] * 1e3 / full["lane_iterations_max"]
        # B1 in the same call, at the bench geometry (E7's measure of it)
        calc, cfg, kw, b1_args = study_inputs()
        b1_steps = pallas_slice_v4.slice_epoch_counted(calc, cfg, kw, *b1_args)[3]
        b1_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *b1_args), 5)
        b1 = {"B": BENCH["B"], "R": BENCH["R"], "D": BENCH["D"], "ms": b1_ms,
              "lane_steps_max": int(b1_steps.max()),
              "us_per_micro_step": b1_ms * 1e3 / int(b1_steps.max())}
        e.LAUNCHES["proto_epoch"] = 0
        rec = e.main()
        study = e.LAUNCHES["proto_epoch"]
        B, R = full["B"], full["R"]
        results["proto_epoch"] = {
            "ms": full["ms"], "plain_ms": full["plain_ms"], "max_abs_err": max(errs),
            "launches": study,
            "bound": bound(4 * (D * B + B + 2 * R * D * B + 2 * R * B + B),
                           full["lane_iterations_sum"] * gaussian_probe_flops(D))}
        return {"checks": out, "b1": b1,
                "e4_lane_iteration_over_b1_micro_step":
                    full["us_per_lane_iteration"] / b1["us_per_micro_step"],
                "study": rec, "study_launches": study}

    @phase("proto_repeat")
    def _():
        p = pallas_slice_repeat
        D = p.SIZES["D"]
        seed = torch.tensor([1234], dtype=torch.int32, device=dev)
        out, errs = {}, []
        for nb in (2, 8):
            x0, nh, w, bnd = p.study_inputs(dev, D, nb, seed=SEED)
            args = (x0, nh, w, bnd)
            got = p.proto_repeat(seed, *args)
            (*want, steps), plain_ms = cuda_once(
                lambda: p.proto_repeat_plain(seed, *args, count_steps=True))  # noqa: B023
            pairs = list(zip(("cube", "logL", "nlike"), got, want))
            errs.append(max_err(got, want))
            xs, xp = x0, x0  # ten launches back to back against the plain chain
            for r in range(10):
                xs, ls, ns = p.proto_repeat(seed + r, xs, nh, w, bnd)
                xp, lp, n_p = p.proto_repeat_plain(seed + r, xp, nh, w, bnd)
            pairs += [("chain_cube", xs, xp), ("chain_logL", ls, lp), ("chain_nlike", ns, n_p)]
            out[f"nb{nb}"] = {
                "B": nb * p.BLOCK, "D": D,
                "mismatches": decisions(f"nb={nb}: E5 differs from its plain version", pairs),
                "evals": int(got[2].sum()), "lane_steps_sum": int(steps.sum()),
                "lane_steps_max": int(steps.max()),
                "ms": graph_ms(lambda: p.proto_repeat(seed, *args)),  # noqa: B023
                "host_clocked_ms": cuda_ms(lambda: p.proto_repeat(seed, *args), 20),  # noqa: B023
                "plain_ms": plain_ms}
        p.LAUNCHES["proto_repeat"] = 0
        rec = p.main()
        study = p.LAUNCHES["proto_repeat"]
        o = out["nb2"]
        B = o["B"]
        results["proto_repeat"] = {
            "ms": o["ms"], "plain_ms": o["plain_ms"], "max_abs_err": max(errs),
            "launches": study,
            "bound": bound(4 * (3 * D * B + 4 * B + 1),
                           o["lane_steps_sum"] * gaussian_probe_flops(D))}
        return {"checks": out, "study": rec, "study_launches": study}

    cli_jobs.shutdown()
    ring_lib.shutdown()
    data_lib.shutdown()
    plain_pool.shutdown(cancel_futures=True)
    shutil.rmtree(plain_dir, ignore_errors=True)
    side_jobs.shutdown()
    d160_jobs.shutdown()
    for d in tmpdirs:
        shutil.rmtree(d, ignore_errors=True)

    if "jax" in sys.modules:
        failed.append("no_jax")
        emit({"phase": "no_jax", "ok": False, "error": "jax was imported"})
    if failed:
        fail(f"failed phases: {failed}")
    # bounds at the bench geometry, from its shapes and the micro-steps its
    # data needed (E1's count; every slice kernel makes those decisions)
    Bb, Rb, Db = BENCH["B"], BENCH["R"], BENCH["D"]
    flops = results["lane_efficiency"]["sum_lane_steps"] * gaussian_probe_flops(Db)
    src = "polychordlite_tpu_torch/csrc/"
    rows = [
        ("slice_epoch", "slice_epoch.cu", "polychordlite_tpu/ops/pallas_slice_v4.py:508",
         "slice_epoch", bound(slice_epoch_bytes(Bb, Rb, Db), flops), None),
        ("gram_schmidt", "gram_schmidt.cu", "polychordlite_tpu/ops/pallas_dirs.py:71",
         "gram_schmidt", (results["gram_schmidt"]["bound_ms"], results["gram_schmidt"]["bound_by"]),
         results["gram_schmidt"]["library_ms"]),
        ("slice_epoch_v5", "slice_epoch_v5.cu", "polychordlite_tpu/ops/pallas_slice_v5.py:606",
         "slice_epoch_v5", bound(slice_epoch_bytes(Bb, Rb, Db), flops), None),
        ("slice_epoch_v3", "slice_epoch_v3.cu", "polychordlite_tpu/ops/pallas_slice_v3.py:345",
         "slice_epoch_v3", bound(slice_epoch_bytes(Bb, Rb, Db), flops), None),
        ("slice_epoch_v2", "slice_epoch_v2.cu", "polychordlite_tpu/ops/pallas_slice.py:372",
         "slice_epoch_v2", bound(slice_epoch_bytes(Bb, Rb, Db, cube=True), flops), None),
        ("slice_epoch_counted", "slice_epoch.cu", "experiments/v4_instr.py:384",
         "lane_efficiency", bound(slice_epoch_bytes(Bb, Rb, Db, counted=True), flops), None),
        ("slice_step", "slice_step.cu", "polychordlite_tpu/ops/pallas_slice_v4.py:508",
         "slice_step", results["slice_step"]["bound"], None),
        ("slice_epoch_fused", "slice_epoch_fused.cu",
         "polychordlite_tpu/ops/pallas_slice_v4.py:508", "slice_fused",
         results["slice_fused"]["bound"], None),
        ("slice_step_graded", "slice_step.cu", "polychordlite_tpu/ops/pallas_slice_v4.py:508",
         "slice_step_graded", results["slice_step_graded"]["bound"], None),
        ("slice_step_host", "slice_step.cu", "polychordlite_tpu/ops/pallas_slice_v4.py:508",
         "slice_step_host", results["slice_step_host"]["bound"], None),
    ] + [
        (name, source, replaces, res, results[res]["bound"], None)
        for name, source, replaces, res in (
            ("slice_epoch_v3_instr", "slice_epoch_v3_instr.cu", "experiments/v3_instr.py:351",
             "v3_iters"),
            ("slice_epoch_v2_counted", "slice_epoch_v2.cu",
             "experiments/prof_lockstep_waste.py:165", "lockstep_waste"),
            ("grid_steps", "probes.cu", "experiments/prof_grid_overhead.py:90", "grid_overhead"),
            ("while_loop", "probes.cu", "experiments/prof_pallas_while.py:66", "while_cost"),
            ("proto_epoch", "prototypes.cu", "experiments/pallas_epoch_v2.py:141", "proto_epoch"),
            ("proto_repeat", "prototypes.cu", "experiments/pallas_slice_repeat.py:124",
             "proto_repeat"),
        )
    ]
    kernels = []
    # the kernels' names in sharded_epoch
    SHARDED_ROUTES = {"slice_epoch": "B1", "slice_epoch_fused": "fused", "slice_step": "traced",
                      "slice_step_graded": "graded", "slice_step_host": "host",
                      "slice_epoch_v5": "B3", "slice_epoch_v3": "B4", "slice_epoch_v2": "B5"}
    PATH_KERNELS = ("slice_epoch", "gram_schmidt", "slice_epoch_v5", "slice_epoch_v3",
                    "slice_epoch_v2", "slice_step", "slice_epoch_fused", "slice_epoch_fused_f64",
                    "slice_step_f64", "gram_schmidt_f64", "slice_step_graded",
                    "slice_step_host")  # the others: their
    # studies' own launches
    se = results["slice_epoch"]
    redesigned = {  # B1's, B3's, B4's, B5's and E2's G = 1 forms, and the traced route, in
        # this run
        "slice_epoch": {"group": se["group"], "previous_ms": se["g1_ms"],
                        "previous": "the G = 1 form, in this run"},
        "slice_epoch_v5": {"group": results["slice_epoch_v5"]["group"],
                           "previous_ms": results["slice_epoch_v5"]["g1_ms"],
                           "previous": "the G = 1 form (one thread per chain), in this run"},
        "slice_epoch_v3": {"group": results["slice_epoch_v3"]["group"],
                           "previous_ms": results["slice_epoch_v3"]["g1_ms"],
                           "previous": "the G = 1 form (one thread per chain), in this run"},
        "slice_epoch_v2": {"group": results["slice_epoch_v2"]["group"],
                           "previous_ms": results["slice_epoch_v2"]["g1_ms"],
                           "previous": "the G = 1 form (one thread per chain), in this run"},
        "slice_epoch_v3_instr": {"group": results["v3_iters"]["group"],
                                 "previous_ms": results["v3_iters"]["g1_ms"],
                                 "previous": "the G = 1 form (one thread per chain), in this "
                                             "run"},
        "slice_epoch_fused": {"group": results["slice_fused"]["group"],
                              "previous_ms": results["slice_fused"]["traced_ms"],
                              "previous": "the traced route (slice_step) on the same model "
                                          "and inputs, in this run"},
    }
    # the 128 bucket's numbers (D = 64, B = 512, R = 128; B2 at the bases
    # that epoch draws; the fused route and B2 also at the 64-D run's B =
    # 256) beside the entries of B1, the fused route, B4, B5, B2
    wide = results["slice_epoch_d128"]
    d128 = {name: {"D": wide["D"], "B": wide["B"], "R": wide["R"], "group": wide["group"],
                   "ms": wide[k]["ms"], "ms_by_group": wide[k]["ms_by_group"],
                   "plain_ms": wide[k]["plain_ms"], "bound_ms": wide[k]["bound"][0],
                   "bound_by": wide[k]["bound"][1]}
            for name, k in (("slice_epoch", "B1"), ("slice_epoch_fused", "fused"),
                            ("slice_epoch_v3", "B4"), ("slice_epoch_v2", "B5"))}
    d128["slice_epoch_fused"]["d64_run"] = wide["d64_run_fused"]
    gw = results["gram_schmidt_wide"]
    d128["gram_schmidt"] = {"kernel": "gram_schmidt_wide", "shape": gw["shape"], "ms": gw["ms"],
                            "plain_ms": gw["plain_ms"], "bound_ms": gw["bound_ms"],
                            "bound_by": gw["bound_by"], "library_ms": gw["library_ms"],
                            "launches": launches["gram_schmidt_wide"],
                            "d64_run": results["gram_schmidt_d64_run"]}
    for name, source, replaces, res, (bound_ms, bound_by), library_ms in rows:
        r = results[res]
        plain_ms = r.get("plain_ms", results["slice_epoch"]["plain_ms"])  # E1's plain: B1's
        n = launches[name] if name in PATH_KERNELS else r["launches"]
        if name == "gram_schmidt":  # B2's two kernels
            n += launches["gram_schmidt_wide"]
        extra = {}
        if name == "slice_step_graded":  # its float64 twin, the monolithic traced route,
            # the slow part's rows, and the run it carried
            gs = results["graded_step"]
            extra = {"geometry": {k: gs["f32"][k] for k in ("B", "R", "D", "grade_dims",
                                                            "num_repeats")},
                     "f64_twin_ms": gs["f64"]["ms"],
                     "traced_monolithic_ms": gs["f32"]["traced_monolithic_ms"],
                     "slow_share": gs["f32"]["slow_share"],
                     "graded_run_geometry": {k: gs["run"][k] for k in (
                         "B", "valid_lanes", "mismatches", "ms", "plain_ms", "bound")},
                     "run_graded": {k: results["run_graded"]["graded"][k]
                                    for k in ("slow_share_of_rows", "wall_s", "dead_per_s")}}
        if name == "slice_step":  # the data-driven models' batches (their runs take
            # the fused route: the row slice_epoch_fused_data)
            dd = results["data_driven_step"]
            extra = {k: {**{f: dd[k][f] for f in ("B", "valid_lanes", "R", "D")},
                         **{f: dd[k]["traced"][f] for f in ("ms", "plain_ms",
                                                            "launches_per_epoch", "mismatches",
                                                            "bound_ops_ms")},
                         "bound_ms": dd[k]["traced"]["bound"][0],
                         "bound_by": dd[k]["traced"]["bound"][1],
                         "launches_on_run": results[f"run_{k}_ini"]["launches"].get(
                             "slice_step", 0)}
                     for k in DATA_RUNS}
        if name == "slice_step_host":  # the host route beside the plain engine and the
            # traced route on the same model, its round's host time, and its runs
            sh = results["slice_step_host"]
            extra = {"reaches": "the JAX package's host-callback path: jax.pure_callback in "
                                "its scan engine (polychordlite_tpu/ops/evaluate.py:208)",
                     **{k: sh[k] for k in ("f64_twin_ms", "plain_engine_ms",
                                           "traced_torch_form_ms", "us_per_round",
                                           "calls_over_nlike", "record_user_calls")},
                     "runs": {k: {f: results[k][f] for f in ("dead_per_s", "device_frac",
                                                             "host_calls", "wall_s")}
                              for k in ("run_callback", "capi_cc")}}
        shard_name = SHARDED_ROUTES.get(name)
        if shard_name is not None:  # the route over 2 and 4 shards, and at lane0 = 3 B
            sh = results["sharded_epoch"]
            shards = {
                tag.split("/")[1]: {k: v for k, v in rec.items() if k.startswith(("B", "ms_"))}
                for tag, rec in sh["routes"].items() if tag.startswith(shard_name + "/")}
            if shards:  # the host route runs on one device
                extra["sharded_epoch"] = shards
            extra["lane0_check"] = sh["lane0"][shard_name]
            if name == "slice_epoch":
                extra["bench_ms_by_lane0"] = sh["b1_bench_ms"]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source, "replaces": replaces,
            "dtype": "float32", **extra,
            "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            **redesigned.get(name, {}), **({"d128": d128[name]} if name in d128 else {}),
        })
    # the double instantiations (precision='highest') at the bench geometry,
    # their float32 twins timed beside them in the same phase; launches on
    # run_highest (B1 fused, B2 narrow) and run_traced_highest_d40 (the traced
    # route, B2 wide)
    f64 = results["f64_kernels"]
    gs_b, gs_w = f64["gram_schmidt_bench"], f64["gram_schmidt_wide_d64"]
    for name, source, replaces, rec, extra in (
        ("slice_epoch_fused_f64", "slice_epoch_fused.cu",
         "polychordlite_tpu/ops/pallas_slice_v4.py:508", f64["bench"]["fused"],
         {"group": f64["bench"]["group"],
          "gaussian_ini": f64["gaussian_ini"]["fused"]}),
        ("slice_step_f64", "slice_step.cu", "polychordlite_tpu/ops/pallas_slice_v4.py:508",
         f64["bench"]["traced"], {"gaussian_ini": f64["gaussian_ini"]["traced"],
                                  "d40_run": f64["d40_run"]["traced"]}),
        ("gram_schmidt_f64", "gram_schmidt.cu", "polychordlite_tpu/ops/pallas_dirs.py:71", gs_b,
         {"gaussian_ini": f64["gram_schmidt_gaussian_ini"],
          "wide": {**gs_w, "launches": launches["gram_schmidt_wide_f64"]},
          "wide_d40_run": f64["gram_schmidt_wide_d40_run"]}),
    ):
        n = launches[name] + (launches["gram_schmidt_wide_f64"] if name == "gram_schmidt_f64"
                              else 0)
        kernels.append({
            "name": name, "route": "cuda", "source": src + source, "replaces": replaces,
            "dtype": "float64", "launches": n, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound"][0],
            "bound_by": rec["bound"][1], "library_ms": rec.get("library_ms"),
            "f32_twin_ms": rec["f32_twin_ms"],
            **extra,
        })
    # B1's fused route on the data-driven inis' functors (their data loops):
    # fitting's numbers first, object_detection's beside them; launches on
    # run_fitting_ini and run_object_detection_ini
    dd = results["data_driven_step"]
    fit = dd["fitting"]
    kernels.append({
        "name": "slice_epoch_fused_data", "route": "cuda", "source": src + "slice_epoch_fused.cu",
        "replaces": "polychordlite_tpu/ops/pallas_slice_v4.py:508", "dtype": "float32",
        "launches": sum(results[f"run_{k}_ini"]["launches"].get("slice_epoch_fused", 0)
                        for k in DATA_RUNS),
        "max_abs_err": 0.0, "ms": fit["fused"]["ms"], "plain_ms": fit["fused"]["plain_ms"],
        "bound_ms": fit["fused"]["bound"][0], "bound_by": fit["fused"]["bound"][1],
        "library_ms": None,
        **{k: {**{f: dd[k][f] for f in ("B", "valid_lanes", "R", "D", "group", "evals",
                                        "loops", "traced_over_fused", "fused_vs_traced")},
               "ms": dd[k]["fused"]["ms"], "plain_ms": dd[k]["fused"]["plain_ms"],
               "bound_ms": dd[k]["fused"]["bound"][0], "bound_by": dd[k]["fused"]["bound"][1],
               "traced_ms": dd[k]["traced"]["ms"],
               **{f: dd[k]["fused"][f] for f in ("nvcc_s", "ptxas", "source_lines")},
               "launches_on_run": results[f"run_{k}_ini"]["launches"].get(
                   "slice_epoch_fused", 0)}
           for k in DATA_RUNS}})
    # the ring engine's instantiations (RingPolicy: B1's functor kernel and
    # the fused route; the traced route under the ring's budget) at the
    # bench, ring_factor 12 (ring_epoch), with gaussian.ini's shape beside;
    # launches on run_ring's three runs
    ring, ring_runs = results["ring_epoch"], results["run_ring"]
    for name, source, route in (("slice_epoch_ring", "slice_epoch.cu", "functor"),
                                ("slice_epoch_fused_ring", "slice_epoch_fused.cu", "fused"),
                                ("slice_step_ring", "slice_step.cu", "traced")):
        r = ring[f"bench/rf12/{route}"]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": "polychordlite_tpu/ops/pallas_slice_v4.py:508", "dtype": "float32",
            "engine": "ring", "launches": launches[name], "max_abs_err": 0.0, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None, "route_ms_own_budget": r["route_ms"],
            **{k: r[k] for k in ("B", "R", "D", "budget", "lanes_overflowed",
                                 "slowest_lane_steps")},
            "gaussian_ini": {k: ring[f"gaussian_ini/rf12/{route}"][k]
                             for k in ("ms", "route_ms", "plain_ms", "lanes_overflowed",
                                       "slowest_lane_steps")},
            "starved_rf2": {k: ring[f"gaussian_ini/rf2/{route}"][k]
                            for k in ("lanes_overflowed", "rerun_vs_cuda_mismatches")},
            "run_ring": {k: ring_runs[route][k] for k in ("epochs", "ring_reruns", "dead_per_s",
                                                           "device_frac", "wall_s", "pull_sigma")},
        })
    # the stream bucket (D > 128): each new instantiation at D = 160 (B = 512,
    # R = 2 D; its plain version at R = 4), with its numbers at 256 and 512
    # by D; launches on the paths above 128: run_gaussian_d160 (the fused
    # route, B2's long kernel) and run_stream_routes_d160 (B1's functor
    # kernel, the traced route, the fused route and B2 long in double, B4 and
    # B5 forced), the kernel-alone phases' own under "phase_launches"; the
    # fused route and B2 also at the 160-D run's geometry ("d160_run")
    st, gl = results["slice_epoch_d512"], results["gram_schmidt_long"]
    d0 = STREAM_DIMS[0]
    d160_ran = results["run_gaussian_d160"]["launches"]
    sr = {k: v["launches"] for k, v in results["run_stream_routes_d160"].items()}

    def stream_row(k, D):
        r = st[f"d{D}"][k]
        return {"R": r["R"], "ms": r["ms"], "ms_r4": r["ms_r4"], "plain_ms_r4": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "max_abs_err": r["max_abs_err"], "ptxas": r.get("ptxas")}

    fr = st["d160_run_fused"]
    for name, source, k, n, n_phase, extra in (
        ("slice_epoch_stream", "slice_epoch.cu", "B1", sr["functor"].get("slice_epoch", 0),
         st["launches"]["B1"],
         {"random_gaussian": {f"d{D}": stream_row("B1_random_gaussian", D)
                              for D in STREAM_DIMS}}),
        ("slice_epoch_fused_stream", "slice_epoch_fused.cu", "fused",
         d160_ran.get("slice_epoch_fused", 0), st["launches"]["slice_epoch_fused"],
         {"d160_run": {**{f: fr[f] for f in ("B", "R", "D", "valid_lanes", "mismatches",
                                             "max_abs_err", "ms", "plain_ms", "evals")},
                       "bound_ms": fr["bound"][0], "bound_by": fr["bound"][1]}}),
        ("slice_epoch_fused_f64_stream", "slice_epoch_fused.cu", "fused_f64",
         sr["fused_f64"].get("slice_epoch_fused_f64", 0),
         st["launches"]["slice_epoch_fused_f64"], {}),
        ("slice_step_stream", "slice_step.cu", "traced", sr["traced"].get("slice_step", 0),
         st["launches"]["slice_step"],
         {"f64": stream_row("traced_f64", d0),
          "f64_phase_launches": st["launches"]["slice_step_f64"]}),
        ("slice_epoch_v3_stream", "slice_epoch_v3.cu", "B4", sr["cuda3"].get("slice_epoch_v3", 0),
         st["launches"]["B4"], {}),
        ("slice_epoch_v2_stream", "slice_epoch_v2.cu", "B5", sr["cuda2"].get("slice_epoch_v2", 0),
         st["launches"]["B5"], {}),
    ):
        r = st[f"d{d0}"][k]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": "polychordlite_tpu/ops/pallas_slice_v4.py:508" if k not in ("B4", "B5")
            else {"B4": "polychordlite_tpu/ops/pallas_slice_v3.py:345",
                  "B5": "polychordlite_tpu/ops/pallas_slice.py:372"}[k],
            "dtype": r["dtype"], "launches": n, "phase_launches": n_phase,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None, "geometry": {"B": STREAM_B, "D": d0, "R": r["R"]},
            "plain_at_R": 4, "ms_r4": r["ms_r4"], **extra,
            "by_dim": {f"d{D}": stream_row(k, D) for D in STREAM_DIMS if k in st[f"d{D}"]}})
    for name, key, n in (("gram_schmidt_long", "d160_float32", launches["gram_schmidt_long"]),
                         ("gram_schmidt_long_f64", "d160_float64",
                          sr["fused_f64"].get("gram_schmidt_long_f64", 0))):
        r = gl[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src + "gram_schmidt.cu",
            "replaces": "polychordlite_tpu/ops/pallas_dirs.py:71", "dtype": r["dtype"],
            "launches": n, "phase_launches": gl["launches"].get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "by_shape": {t: {f: v for f, v in rec.items() if f != "launches"}
                         for t, rec in gl.items() if t != "launches" and rec["kernel"] == name}})
    # B3 above D = 32 (slice_epoch_v5_buckets: the wide bucket at D = 64, B
    # = 512, R = 128; the stream bucket at D = 160, timed at R = 320, its
    # plain version at R = 4), launches on run_stream_routes_d160's cuda5
    # runs at D = 64 and 160; the forced engines' fused routes at the bench
    # (slice_forced_fused, gaussian.ini's shape beside), launches on
    # run_forced_torch's runs
    vb, ff, rf = (results["slice_epoch_v5_buckets"], results["slice_forced_fused"],
                  results["run_forced_torch"])
    v5_replaces = "polychordlite_tpu/ops/pallas_slice_v5.py:606"
    for name, key, run in (("slice_epoch_v5_wide", "d64", "cuda5_d64"),
                           ("slice_epoch_v5_stream", f"d{STREAM_DIMS[0]}", "cuda5")):
        r = vb[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src + "slice_epoch_v5.cu",
            "replaces": v5_replaces, "dtype": "float32",
            "launches": sr[run].get("slice_epoch_v5", 0),
            "phase_launches": vb["launches"].get(
                f"{pallas_slice_v4.SLICE_MAXD_WIDE if key == 'd64' else pallas_slice_v4.STREAM}/32", 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "plain_device": r["plain_device"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None, "b1_ms": r["b1_ms"],
            "geometry": {k: r[k] for k in ("B", "D", "R")}, "group": r["group"],
            "plain_at_R": r.get("plain_at_R", r["R"]), "ms_r4": r.get("ms_r4"),
            "ptxas": r["ptxas"], "resident_warps": r["resident_warps"]})
    for name, k, replaces, engine in (
            ("slice_epoch_v5_fused", "B3", v5_replaces, "cuda5"),
            ("slice_epoch_v3_fused", "B4", "polychordlite_tpu/ops/pallas_slice_v3.py:345", "cuda3"),
            ("slice_epoch_v2_fused", "B5", "polychordlite_tpu/ops/pallas_slice.py:372", "cuda2")):
        r = ff["bench"][k]
        kernels.append({
            "name": name, "route": "cuda", "source": src + "slice_epoch_fused.cu",
            "replaces": replaces, "dtype": "float32", "engine": engine,
            "launches": rf[engine]["launches"].get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "plain_device": r["plain_device"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None, "group": r["group"],
            "ms_by_group": r["ms_by_group"], "b1_fused_ms": ff["bench"]["b1_fused_ms"],
            "geometry": {f: ff["bench"][f] for f in ("B", "R", "D")},
            "gaussian_ini": {**{f: ff["gaussian_ini"][k][f] for f in (
                "group", "ms", "plain_ms", "max_abs_err")},
                "b1_fused_ms": ff["gaussian_ini"]["b1_fused_ms"]},
            "run_forced_torch": {f: rf[engine][f] for f in (
                "ndead", "logZ", "logZerr", "pull_sigma", "wall_s", "dead_per_s",
                "device_frac")}})
    missing = [k["name"] for k in kernels if not k["launches"]]
    for name in ("gram_schmidt_wide", "gram_schmidt_wide_f64"):
        if not launches[name]:
            missing.append(name)
    if missing:
        fail(f"kernels never launched on their paths: {missing}")
    emit({"phase_seconds": seconds, "total_seconds": time.perf_counter() - t_script})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
