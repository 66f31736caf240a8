"""Image-pair generation schedules for matching.

Port of ``sba_tpu/features/pairing.py`` (the port's own copy of its
host numpy; capability parity with ref: src/feature/matching.{h,cc} pair strategies —
exhaustive blocked (`ExhaustiveFeatureMatcher` matching.h:401), sequential
with overlap (`SequentialFeatureMatcher` :435), spatial kNN
(`SpatialFeatureMatcher` :474), transitive (`TransitiveFeatureMatcher`
:494), from-file (`ImagePairsFeatureMatcher` :519).

These are host-side schedule generators (pure numpy — pair lists are tiny
control metadata); the actual matching of each scheduled pair runs as
batched device work (features/matching.py). The reference's thread-pool /
JobQueue orchestration is replaced by stacking pairs into device batches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def exhaustive_pairs(num_images: int, block_size: int = 50
                     ) -> np.ndarray:
    """All N*(N-1)/2 pairs in the reference's block order
    (ref: matching.cc ExhaustiveFeatureMatcher::Run block loop).
    Returns [M, 2] int32 with i < j."""
    pairs = []
    for sb in range(0, num_images, block_size):
        se = min(sb + block_size, num_images)
        for eb in range(0, num_images, block_size):
            ee = min(eb + block_size, num_images)
            for i in range(sb, se):
                for j in range(eb, ee):
                    if i < j:
                        pairs.append((i, j))
    seen = set()
    out = []
    for p in pairs:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return np.asarray(out, np.int32).reshape(-1, 2)


def sequential_pairs(num_images: int, overlap: int = 10,
                     quadratic_overlap: bool = True) -> np.ndarray:
    """Sequential matching: image i vs i+1..i+overlap, plus quadratic
    jumps i+2^k (ref: matching.cc SequentialFeatureMatcher pair logic,
    options at matching.h:435-455)."""
    pairs = set()
    for i in range(num_images):
        for d in range(1, overlap + 1):
            j = i + d
            if j < num_images:
                pairs.add((i, j))
        if quadratic_overlap:
            for k in range(1, 32):
                j = i + (1 << k)
                if j >= num_images:
                    break
                pairs.add((i, j))
    return np.asarray(sorted(pairs), np.int32).reshape(-1, 2)


def spatial_pairs(positions: np.ndarray, max_num_neighbors: int = 50,
                  max_distance: float = 100.0,
                  valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Spatial kNN pairs from per-image positions [N, 3] (GPS/prior
    locations; ref: matching.h:474 SpatialFeatureMatcher with FLANN kNN).
    Full [N, N] distance matrix — N is image count, trivially small next to
    descriptor work."""
    n = positions.shape[0]
    d2 = np.sum((positions[:, None, :] - positions[None, :, :]) ** 2, -1)
    np.fill_diagonal(d2, np.inf)
    if valid is not None:
        d2[~valid, :] = np.inf
        d2[:, ~valid] = np.inf
    k = min(max_num_neighbors, n - 1)
    pairs = set()
    order = np.argsort(d2, axis=1)[:, :k]
    for i in range(n):
        for j in order[i]:
            if d2[i, j] <= max_distance ** 2:
                pairs.add((min(i, int(j)), max(i, int(j))))
    return np.asarray(sorted(pairs), np.int32).reshape(-1, 2)


def transitive_pairs(existing_pairs: np.ndarray, num_images: int,
                     batch_size: int = 1000) -> np.ndarray:
    """One transitive-closure round: if (a,b) and (b,c) matched, schedule
    (a,c) (ref: matching.h:494 TransitiveFeatureMatcher)."""
    adj = [set() for _ in range(num_images)]
    have = set()
    for i, j in existing_pairs:
        adj[i].add(int(j))
        adj[j].add(int(i))
        have.add((min(int(i), int(j)), max(int(i), int(j))))
    new = set()
    for b in range(num_images):
        nb = sorted(adj[b])
        for x in range(len(nb)):
            for y in range(x + 1, len(nb)):
                p = (nb[x], nb[y])
                if p not in have:
                    new.add(p)
                    if len(new) >= batch_size:
                        return np.asarray(sorted(new), np.int32).reshape(-1, 2)
    return np.asarray(sorted(new), np.int32).reshape(-1, 2)


def pairs_from_file(path, name_to_index) -> np.ndarray:
    """Read 'name1 name2' lines (ref: matching.h:519
    ImagePairsFeatureMatcher)."""
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            a, b = line.split()[:2]
            i, j = name_to_index[a], name_to_index[b]
            if i != j:
                pairs.append((min(i, j), max(i, j)))
    return np.asarray(sorted(set(pairs)), np.int32).reshape(-1, 2)
