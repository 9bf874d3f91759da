"""Rows and queries of a configuration, made on the device from `--seed`.

The recipe is the clustered generator of `bench_all_torch.py:395`
(`clustered_chunks`, itself `bench_all.py:319-323`): `modes` centres drawn
from N(0, 1) and scaled by 3, and each row a centre picked at random plus
unit noise. Real embeddings cluster, and an IVF index needs clusters to be
worth probing. It is copied here, and not imported, so that a change to the
root scripts cannot move the benchmark's inputs. The copy draws with a
`torch.Generator` on the device, in large chunks, instead of numpy on the
host.

Queries come from the same mixture (another stream of the same seed): a
query is a fresh draw, so it is near one mode's rows and is no stored row.
The rows are regenerated, chunk by chunk and equal to the bit, by the
reference after the window: the same seed, device and chunking give the
same draws.
"""

from __future__ import annotations

import hashlib

import torch

CHUNK_ROWS = 131072  # rows per draw: a multiple of every block the reference scans by


def stream_seed(seed: int, stream: str) -> int:
    """A 64-bit seed of its own for each named stream of one run seed."""
    digest = hashlib.sha256(f"{seed}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little")


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


class Mixture:
    """The clustered mixture of one configuration and one seed."""

    def __init__(self, data: dict, dims: int, seed: int, device):
        self.dims = dims
        self.seed = seed
        self.device = torch.device(device)
        self.noise = float(data["noise"])
        g = generator(seed, "centres", self.device)
        self.centres = torch.randn((int(data["modes"]), dims), generator=g,
                                   device=self.device) * float(data["centre_scale"])

    def _draw(self, g: torch.Generator, m: int) -> torch.Tensor:
        pick = torch.randint(0, self.centres.shape[0], (m,), generator=g, device=self.device)
        return self.centres[pick] + self.noise * torch.randn(
            (m, self.dims), generator=g, device=self.device)

    def rows(self, n: int, chunk: int = CHUNK_ROWS):
        """Yields (offset, [m, dims] float32 rows on the device); row i has
        key i."""
        g = generator(self.seed, "rows", self.device)
        for off in range(0, n, chunk):
            yield off, self._draw(g, min(chunk, n - off))

    def queries(self, n: int, stream: str = "queries") -> torch.Tensor:
        """[n, dims] float32 queries, drawn on the device in chunks and
        gathered on the host (the pool never sits whole on the card)."""
        g = generator(self.seed, stream, self.device)
        return torch.cat([self._draw(g, min(CHUNK_ROWS, n - off)).cpu()
                          for off in range(0, n, CHUNK_ROWS)])
