"""Corpus conversion over a mesh of cards: the corpus driver's closed loop,
each request one ``Converter.convert_batch(mesh=)`` over one local mesh
of the cell's ``chips`` cards (``cuda:0`` ... on the card's machine, as
many ``cpu`` shards on the CPU), one model replica per card and one
shard of each chunk per card, as ``cli.convert --data_parallel`` serves.

The check converts each sampled request again shard by shard: each shard
one reference call of the rows that the shard converted together, padded
to the chunk's length, so the reference's analysis sees the batch the
program's did.
"""

from __future__ import annotations

import numpy as np

from benchmark.drivers import corpus
from benchmark.reference import convert as ref


class Cell(corpus.Cell):
    def setup(self) -> None:
        from tpuvc_torch.parallel import mesh as mesh_lib
        run = self.run
        n = run.workload["chips"]
        self.mesh = (mesh_lib.make_mesh(n) if run.device.type == "cuda"
                     else mesh_lib.make_mesh(devices=[run.device] * n))
        super().setup()
        self.budget_s = self.conv.MAX_AUDIO_S_PER_CALL

    def _request(self, rows, trg, seeds):
        xs, srcs, trgs = self._args(rows, trg)
        return self.conv.convert_batch(xs, srcs, trgs, seed=seeds,
                                       mesh=self.mesh)

    def shards(self, n: int, t_pad: int, fs: int) -> list[np.ndarray]:
        """The rows of an n-row request that each shard converts together,
        by index, as ``convert_batch(mesh=)`` deals them: chunks within
        the per-card budget, a chunk a multiple of the mesh (a short tail
        filled with its last row), each split into equal contiguous
        shards."""
        size = self.mesh.size
        max_b = max(1, int(self.budget_s * size / (t_pad / fs)))
        n_chunks = -(-n // max_b)
        b = max(size, (-(-n // n_chunks) // size) * size)
        out = []
        for lo in range(0, n, b):
            idx = np.minimum(np.arange(lo, lo + b), min(lo + b, n) - 1)
            out += np.split(idx, size)
        return out

    def readings(self, reference: ref.Reference, sample,
                 control: ref.Reference | None = None) -> list[float]:
        world = ref.World(**self.run.config["world"])
        bucket = int(self.run.traffic["bucket_s"] * world.fs)
        errs = []
        for rows, trg, seeds, y in sample:
            xs, srcs, trgs = self._args(rows, trg)
            t_pad = max(1, -(-max(map(len, xs)) // bucket)) * bucket
            padded = [np.pad(x, (0, t_pad - len(x))) for x in xs]
            seen = set()
            for idx in self.shards(len(xs), t_pad, world.fs):
                args = ([padded[i] for i in idx], [srcs[i] for i in idx],
                        [trgs[i] for i in idx], seeds[idx])
                r = reference.convert_batch(*args)
                c = None if control is None else control.convert_batch(*args)
                for j, i in enumerate(idx.tolist()):
                    if i in seen:           # a repeat filling the chunk
                        continue
                    seen.add(i)
                    n = len(xs[i])
                    g = y[i] if c is None else c[j][:n]
                    errs.append(ref.error_db(g, r[j][:n], 2 * world.hop))
        return errs
