"""Run-output accessor.

Drop-in equivalent of ``pypolychord.output.PolyChordOutput``
(pypolychord/output.py:20-235): parses ``<root>.stats`` with the same
fixed-offset strategy (our writer emits the identical layout), loads posterior
sample tables, creates paramnames files.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np


class PolyChordOutput:
    def __init__(self, base_dir: str, file_root: str):
        self.base_dir = base_dir
        self.file_root = file_root

        with open("%s.stats" % self.root, "r") as f:
            for _ in range(9):
                line = f.readline()
            self.logZ = float(line.split()[2])
            self.logZerr = float(line.split()[4])

            for _ in range(6):
                line = f.readline()

            self.logZs: List[float] = []
            self.logZerrs: List[float] = []
            while line[:5] == "log(Z":
                self.logZs.append(float(re.findall(r"=(.*)", line)[0].split()[0]))
                self.logZerrs.append(
                    float(re.findall(r"=(.*)", line)[0].split()[2])
                )
                line = f.readline()

            for _ in range(5):
                f.readline()

            self.ncluster = len(self.logZs)
            self.nposterior = int(f.readline().split()[1])
            self.nequals = int(f.readline().split()[1])
            self.ndead = int(f.readline().split()[1])
            self.nlive = int(f.readline().split()[1])
            try:
                self.nlike = int(f.readline().split()[1])
            except ValueError:
                self.nlike = None
            line = f.readline().split()
            i = line.index("(")
            self.avnlike = [float(x) for x in line[1:i]]
            self.avnlikeslice = [float(x) for x in line[i + 1 : -3]]

        try:
            self._create_table()
            self.pandas = True
        except Exception:
            self.pandas = False

    # ------------------------------------------------------------------
    @property
    def root(self) -> str:
        return os.path.join(self.base_dir, self.file_root)

    def cluster_root(self, i: int) -> str:
        return os.path.join(self.base_dir, "clusters", "%s_%i" % (self.file_root, i))

    @property
    def paramnames_file(self) -> str:
        return self.root + ".paramnames"

    @property
    def loglikes(self):
        if self.pandas:
            return np.array(self._samples_table["loglike"])
        return None

    @property
    def samples(self):
        return self._samples_table if self.pandas else None

    @property
    def posterior(self):
        """getdist MCSamples, when getdist is installed."""
        import getdist.mcsamples

        return getdist.mcsamples.loadMCSamples(self.root)

    def cluster_posterior(self, i: int):
        import getdist.mcsamples

        return getdist.mcsamples.loadMCSamples(self.cluster_root(i))

    def cluster_paramnames_file(self, i: int) -> str:
        return self.cluster_root(i) + ".paramnames"

    def make_paramnames_files(self, paramnames: Sequence[Tuple[str, str]]):
        self.make_paramnames_file(paramnames, self.paramnames_file)
        for i, _ in enumerate(self.logZs):
            self.make_paramnames_file(paramnames, self.cluster_paramnames_file(i))
        if self.pandas:
            self._create_table(paramnames=paramnames)

    @staticmethod
    def make_paramnames_file(paramnames, filename):
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        with open(filename, "w") as f:
            for name, latex in paramnames:
                f.write("%s   %s\n" % (name, latex))

    def _create_table(self, paramnames=None):
        import pandas as pd

        cols = ["weight", "loglike"]
        data = np.atleast_2d(np.genfromtxt("%s_equal_weights.txt" % self.root))
        n_params = data.shape[1] - 2
        if paramnames is None:
            cols += ["p%d" % i for i in range(n_params)]
        else:
            cols += [p[0] for p in paramnames]
        self._samples_table = pd.DataFrame(data, columns=cols).astype(float)
        self._samples_table["loglike"] *= -0.5

    def __str__(self):
        return "PolyChordOutput(logZ=%g +/- %g, ncluster=%i, ndead=%i)" % (
            self.logZ,
            self.logZerr,
            self.ncluster,
            self.ndead,
        )

    __repr__ = __str__
