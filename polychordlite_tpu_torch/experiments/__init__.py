"""The structure-cost studies (counterparts of the repository's top-level
``experiments/``, file for file).

Each study module has a ``main()`` that runs the study, prints its record
as one JSON line and returns it, and runs as

    python -m polychordlite_tpu_torch.experiments.<name> [--device cpu] ...

on the card by default; without one it raises, naming ``--device cpu``.
On the CPU the kernels' plain versions run and no time is recorded.
Importing a module runs nothing.

* ``v3_instr``: the wrapper of E2, v3's grid steps rebuilt as a cooperative
  kernel with the body iterations of every step counted
  (``csrc/slice_epoch_v3_instr.cu``); ``prof_v3_iters`` is its study;
* ``prof_lockstep_waste``: E3's study, v2's lockstep waste (the counted B5,
  ``ops/pallas_slice.py::slice_epoch_v2_counted``);
* ``prof_grid_overhead``: E6, the grid-step skeleton (``csrc/probes.cu``);
* ``prof_pallas_while``: E7, the cost of one loop iteration
  (``csrc/probes.cu``);
* ``sim_iter_distribution``: the numpy simulation of the state machine's
  step counts and the lane efficiencies it projects (no kernel);
* ``bench_geometry``: the studies' inputs and timer.
"""
