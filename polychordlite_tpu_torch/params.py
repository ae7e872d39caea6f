"""Parameter model (reference ``src/polychord/params.f90``): name, latex
label, speed grade, prior type/block/parameters, sub-clustering flag."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple


@dataclass
class Param:
    """One sampled or derived parameter (param_type, params.f90:6-16)."""

    paramname: str
    latex: str
    speed: int = 1
    prior_type: str = "uniform"
    prior_block: int = 1
    prior_params: Tuple[float, ...] = ()
    sub_cluster: bool = False


def create_priors(params: Sequence[Param]):
    """Assemble block-structured priors and grade layout from a parameter
    list (create_priors, priors.f90:671-749).

    Hypercube indices are assigned speed-major (all grade-1 parameters first),
    physical indices follow the parameter order.  Returns
    (blocks, grade_dims, sub_clustering_dimensions, paramnames).
    """
    from .priors import PriorBlock

    n = len(params)
    # relabel prior blocks in order of first appearance; blocks are keyed by
    # (prior_block id) as in the reference
    block_ids: List[int] = []
    block_of = []
    for p in params:
        if p.prior_block not in block_ids:
            block_ids.append(p.prior_block)
        block_of.append(block_ids.index(p.prior_block))

    # relabel speeds 1,2,3... by ascending distinct value
    distinct_speeds = sorted({p.speed for p in params})
    speed_of = [distinct_speeds.index(p.speed) for p in params]
    n_grades = len(distinct_speeds)
    grade_dims = [sum(1 for sp in speed_of if sp == g) for g in range(n_grades)]

    # hypercube index assignment: speed-major, parameter order within a grade
    hypercube_index = [0] * n
    i_h = 0
    for g in range(n_grades):
        for i, sp in enumerate(speed_of):
            if sp == g:
                hypercube_index[i] = i_h
                i_h += 1

    sub_dims = [hypercube_index[i] for i, p in enumerate(params) if p.sub_cluster]

    blocks = []
    for b in range(len(block_ids)):
        members = [i for i in range(n) if block_of[i] == b]
        prior_type = params[members[0]].prior_type
        pp: List[float] = []
        for i in members:
            pp.extend(params[i].prior_params)
        blocks.append(
            PriorBlock(
                prior_type=prior_type,
                hypercube_indices=tuple(hypercube_index[i] for i in members),
                physical_indices=tuple(members),
                parameters=tuple(pp),
            )
        )

    paramnames = [(p.paramname, p.latex) for p in params]
    return blocks, grade_dims, sub_dims, paramnames
