"""Scene clustering: recursive partition of the image match graph.

Port of ``sba_tpu/sfm/scene_clustering.py`` (ref: src/base/
scene_clustering.{h,cc} `SceneClustering`, and graph_cut.{h,cc}
`ComputeNormalizedMinGraphCut`): spectral bisection on the normalized
Laplacian of the image graph, split at the median of the Fiedler
vector, with per-child image overlap.

This is host graph code on an [n, n] matrix (n = images per cluster),
kept in numpy as in sba_tpu. The eigensolve stays LAPACK's through
numpy: the Fiedler vector's sign and the order of its near-ties are the
eigensolver's, and they decide which images form the first child, which
leaf is mapped first and which leaf model becomes the merge base. A
different solver (``torch.linalg.eigh``) may flip the sign and so swap
the children; numpy's gives sba_tpu's tree, leaf for leaf.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class SceneClusteringOptions:
    """Mirrors ref: scene_clustering.h Options."""

    branching: int = 2
    image_overlap: int = 50
    leaf_max_num_images: int = 500


@dataclass
class Cluster:
    """Ref: SceneClustering::Cluster (tree node)."""

    image_ids: List[int] = field(default_factory=list)
    children: List["Cluster"] = field(default_factory=list)


def normalized_min_cut(image_ids: Sequence[int],
                       edges: Dict[Tuple[int, int], int],
                       num_parts: int = 2) -> Dict[int, int]:
    """Partition images into `num_parts` balanced groups of small cut
    weight: the Fiedler vector of the normalized Laplacian, split at its
    median; more than two parts by recursive bisection."""
    ids = list(image_ids)
    n = len(ids)
    if n <= 1 or num_parts <= 1:
        return {i: 0 for i in ids}
    idx = {iid: k for k, iid in enumerate(ids)}
    W = np.zeros((n, n))
    for (a, b), w in edges.items():
        if a in idx and b in idx and a != b:
            W[idx[a], idx[b]] += w
            W[idx[b], idx[a]] += w
    d = W.sum(1)
    # L = I - D^-1/2 W D^-1/2.
    dinv = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    L = np.eye(n) - (dinv[:, None] * W) * dinv[None, :]
    _vals, vecs = np.linalg.eigh(L)
    fiedler = vecs[:, 1]
    order = np.argsort(fiedler)
    labels = np.zeros(n, int)
    labels[order[n // 2:]] = 1
    out = {ids[k]: int(labels[k]) for k in range(n)}
    if num_parts > 2:
        for side in (0, 1):
            sub = [i for i in ids if out[i] == side]
            sub_labels = normalized_min_cut(sub, edges, num_parts // 2)
            for i in sub:
                out[i] = side * (num_parts // 2) + sub_labels[i]
    return out


class SceneClustering:
    """Ref: scene_clustering.h:46."""

    def __init__(self, options: Optional[SceneClusteringOptions] = None):
        self.options = options or SceneClusteringOptions()
        self.root: Optional[Cluster] = None

    def partition(self, image_pairs: Dict[Tuple[int, int], int]) -> Cluster:
        """image_pairs: {(id1, id2): num_matches}. Builds the cluster tree
        (ref: SceneClustering::Partition)."""
        all_ids = sorted({i for p in image_pairs for i in p})
        self.root = self._partition_cluster(all_ids, image_pairs)
        return self.root

    def _partition_cluster(self, image_ids: List[int], edges) -> Cluster:
        c = Cluster(image_ids=list(image_ids))
        if len(image_ids) <= self.options.leaf_max_num_images:
            return c
        labels = normalized_min_cut(image_ids, edges, self.options.branching)
        groups: Dict[int, List[int]] = {}
        for iid in image_ids:
            groups.setdefault(labels[iid], []).append(iid)
        if len(groups) <= 1:
            return c
        for g in sorted(groups):
            c.children.append(self._partition_cluster(groups[g], edges))
        self._add_overlap(c, edges)
        return c

    def _add_overlap(self, cluster: Cluster, edges):
        """Add to each child the `image_overlap` images of its parent
        outside it that it shares the most matches with (ties in the
        order the edges first name them), so that the leaves' models
        share images to be merged by."""
        overlap = self.options.image_overlap
        if overlap <= 0:
            return
        parent = set(cluster.image_ids)
        for child in cluster.children:
            inside = set(child.image_ids)
            scores: Dict[int, int] = {}
            for (a, b), w in edges.items():
                if (a in inside) != (b in inside):
                    outsider = b if a in inside else a
                    if outsider in parent:
                        scores[outsider] = scores.get(outsider, 0) + w
            extra = sorted(scores, key=lambda i: -scores[i])[:overlap]
            child.image_ids.extend(i for i in extra if i not in inside)

    def leaf_clusters(self) -> List[Cluster]:
        out: List[Cluster] = []

        def walk(c: Cluster):
            if not c.children:
                out.append(c)
            for ch in c.children:
                walk(ch)

        if self.root is not None:
            walk(self.root)
        return out
