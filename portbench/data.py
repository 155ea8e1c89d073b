"""The data of a run, made on the device from ``--seed``.

The mixture of the repo's SIFT1M stand-in (``utils/datasets.
random_dataset``): ``clusters`` centres drawn N(0, 1) times
``center_scale``, each base row a centre plus N(0, 1) noise. The queries
are held out, as ann-benchmarks' are: fresh points of the same mixture (a
centre plus N(0, 1) noise), none of them a base row or near one. The same
seed gives the same arrays on one kind of device; the draws come from
``torch.Generator``s, not numpy's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# streams of one seed: each use draws from a generator of its own
STREAM_DATA, STREAM_TRAFFIC, STREAM_INSERT, STREAM_JUDGE = 1, 2, 3, 4


def stream_seed(seed: int, stream: int, sub: int = 0) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), stream, sub])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device: torch.device, seed: int, stream: int,
              sub: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream, sub))
    return g


def rng(seed: int, stream: int, sub: int = 0) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream, sub))


@dataclasses.dataclass
class Data:
    base: torch.Tensor       # [n, dim] f32 on the device
    queries: torch.Tensor    # [nq, dim] f32 on the device
    centers: torch.Tensor    # [clusters, dim] f32, for new rows


def make(spec: dict, seed: int, device: torch.device) -> Data:
    """``spec``: the configuration's ``data`` (n, dim, n_queries,
    clusters, center_scale)."""
    g = generator(device, seed, STREAM_DATA)
    n, dim = int(spec["n"]), int(spec["dim"])
    nq, clusters = int(spec["n_queries"]), int(spec["clusters"])
    centers = torch.randn((clusters, dim), generator=g, device=device)
    centers *= float(spec["center_scale"])
    assign = torch.randint(0, clusters, (n,), generator=g, device=device)
    base = centers[assign]
    base += torch.randn((n, dim), generator=g, device=device)
    queries = mixture(centers, nq, g)
    return Data(base, queries, centers)


def mixture(centers: torch.Tensor, rows: int,
            g: torch.Generator) -> torch.Tensor:
    """``rows`` fresh points of the mixture: a centre plus N(0, 1) noise,
    as a base row is made."""
    assign = torch.randint(0, centers.shape[0], (rows,), generator=g,
                           device=centers.device)
    out = centers[assign]
    out += torch.randn((rows, centers.shape[1]), generator=g,
                       device=centers.device)
    return out


def new_rows(data: Data, rows: int, g: torch.Generator) -> torch.Tensor:
    """``rows`` new vectors from the data's own clusters."""
    return mixture(data.centers, rows, g)
