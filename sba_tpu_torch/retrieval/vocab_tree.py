"""Hierarchical k-means vocabulary tree, built and queried on the device.

Port of ``sba_tpu/retrieval/vocab_tree.py`` (ref:
src/retrieval/visual_index.h:61, a 256-way tree of 256^2 visual words
built with VLFeat ikmeans):

- k-means is a product and a segment sum: the assignment step scores
  each descriptor against its own node's k centres only, in one batched
  float32 product over tiles of rows of one node (TF32 off); the update
  step sums each (node, child) segment over the rows sorted by segment,
  in a fixed order (the same tree from run to run on the card, where
  index_add_'s float atomics add in no fixed order).
- A level's nodes train together (sba_tpu vmaps over them), breadth
  first; the initial and re-seed centres come from an explicit CPU
  `torch.Generator` (so a seed gives the same draws on every device),
  or from `draw_fn` (which can hand in sba_tpu's
  `jax.random.categorical` draws).
- Quantization descends the tree with one product per level. The
  centres are never gathered as `centers[node]` ([N, B, D]): a COLMAP
  tree imported at depth 1 has B = its word count (65,536 for the public
  flickr100k trees), and its one node is scored as x @ centers[0].T.
  Rows go through in chunks under `SCORE_BYTES`.
  Ties in the argmax go to the lower index, as in `jnp.argmax`.
"""

from __future__ import annotations

import struct
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sba_tpu_torch.features.sift import require_fp32_matmul

# Bytes of one chunk of the [rows, nodes * branching] score matrix.
SCORE_BYTES = 1 << 28


class VocabTree(NamedTuple):
    """centers: per-level float32 tensors; level l has shape [B^l, B, D]
    (for each parent node, B child centres). num_words = B^depth."""

    centers: Tuple[torch.Tensor, ...]
    branching: int
    depth: int

    @property
    def num_words(self) -> int:
        return self.branching ** self.depth

    @property
    def device(self):
        return self.centers[0].device


def _own_child(x, node_of, centers):
    """Argmax [N] of each row of x [N, D] over its own node's B child
    centres (centers [M, B, D]). With one node it is x @ centers[0].T in
    row chunks. With more, the rows are sorted by node and cut into
    tiles of T rows of one node each, and one batched product scores
    each tile against its node's B centres only: (N + M T) B D
    multiply-adds, not N M B D."""
    require_fp32_matmul(x)
    M, B, D = centers.shape
    N = x.shape[0]
    if N == 0:
        return node_of.new_empty(0)
    if M == 1:
        rows = max(1, SCORE_BYTES // (4 * B))
        return torch.cat([torch.argmax(x[r0:r0 + rows] @ centers[0].T, -1)
                          for r0 in range(0, N, rows)])
    T = max(1, min(128, N // M))
    order = torch.argsort(node_of, stable=True)
    counts = torch.bincount(node_of, minlength=M)
    tiles = (counts + T - 1) // T
    node = node_of[order]
    pos = torch.arange(N, device=x.device) - (torch.cumsum(counts, 0)
                                              - counts)[node]
    tile = (torch.cumsum(tiles, 0) - tiles)[node] + pos // T
    slot = pos % T
    n_tiles = int(tiles.sum())
    tile_node = torch.repeat_interleave(
        torch.arange(M, device=x.device), tiles, output_size=n_tiles)
    xt = x.new_zeros(n_tiles, T, D)
    xt[tile, slot] = x[order]
    per = max(1, SCORE_BYTES // (4 * B * (T + D)))
    best = torch.cat([torch.argmax(torch.bmm(
        xt[t0:t0 + per], centers[tile_node[t0:t0 + per]].transpose(1, 2)),
        -1) for t0 in range(0, n_tiles, per)])
    child = torch.empty_like(node_of)
    child[order] = best[tile, slot]
    return child


def _default_draws(generator):
    """Draws on the host from a CPU generator, moved to the members'
    device: the same seed gives the same draws on every device."""
    def draw(level, step, members, k):
        w = members.to("cpu", torch.float32)
        # A node without members draws index 0, as sba_tpu's categorical
        # over logits that are all -inf does.
        w[~members.any(1).cpu(), 0] = 1.0
        return torch.multinomial(w, k, replacement=True,
                                 generator=generator).to(members.device)
    return draw


def _kmeans_level(x, node_of, M, k, iters, draw, level):
    """Lloyd k-means of all M nodes of a level at once (spherical: the
    centroids are renormalized). Returns centers [M, k, D]."""
    N, D = x.shape
    members = torch.zeros(M, N, dtype=torch.bool, device=x.device)
    members[node_of, torch.arange(N, device=x.device)] = True
    centers = x[draw(level, -1, members, k)]               # [M, k, D]
    for it in range(iters):
        assign = _own_child(x, node_of, centers)
        key = node_of * k + assign
        counts = torch.bincount(key, minlength=M * k)
        sums = torch.segment_reduce(x[torch.argsort(key, stable=True)],
                                    "sum", lengths=counts, axis=0)
        counts = counts.to(x.dtype)
        new = sums / torch.clamp(counts[:, None], min=1e-9)
        new = new / torch.clamp(torch.linalg.norm(new, dim=-1, keepdim=True),
                                min=1e-9)
        rand = x[draw(level, it, members, k)].reshape(M * k, D)
        centers = torch.where((counts > 0)[:, None], new, rand).reshape(
            M, k, D)
    return centers


def build_vocab_tree(descriptors, branching: int = 16, depth: int = 2,
                     iters: int = 10, seed: int = 0, device="cuda",
                     draw_fn: Optional[Callable] = None) -> VocabTree:
    """Train the tree on [N, D] L2-normalized float32 descriptors on
    `device`.

    `draw_fn(level, step, members, k)` -> int64 [M, k] sample indices per
    node (members: bool [M, N], node m's descriptors; step -1 draws the
    initial centres, step i the re-seed candidates of Lloyd step i, drawn
    at every step as in sba_tpu). By default the draws are uniform among
    a node's members, from a CPU `torch.Generator` seeded with `seed`
    (the same draws on every device).
    """
    x = torch.as_tensor(np.asarray(descriptors, np.float32), device=device)
    n = x.shape[0]
    if draw_fn is None:
        draw_fn = _default_draws(
            torch.Generator().manual_seed(seed))
    levels = []
    node_of = torch.zeros(n, dtype=torch.int64, device=x.device)
    num_nodes = 1
    for level in range(depth):
        centers = _kmeans_level(x, node_of, num_nodes, branching, iters,
                                draw_fn, level)
        levels.append(centers)
        node_of = node_of * branching + _own_child(x, node_of, centers)
        num_nodes *= branching
    return VocabTree(centers=tuple(levels), branching=branching,
                     depth=depth)


def quantize_descriptors(tree: VocabTree, descriptors) -> torch.Tensor:
    """[N, D] -> [N] visual word ids (leaf index, int32) on the tree's
    device."""
    x = torch.as_tensor(np.asarray(descriptors, np.float32)
                        if not torch.is_tensor(descriptors)
                        else descriptors.to(torch.float32),
                        device=tree.device)
    node = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for centers in tree.centers:
        node = node * tree.branching + _own_child(x, node, centers)
    return node.to(torch.int32)


def tree_to_arrays(tree: VocabTree):
    """Host snapshot for serialization."""
    return {f"level_{i}": c.cpu().numpy() for i, c in enumerate(tree.centers)}


def tree_from_arrays(arrays, branching: int, depth: int,
                     device="cuda") -> VocabTree:
    centers = tuple(torch.as_tensor(np.asarray(arrays[f"level_{i}"]),
                                    device=device) for i in range(depth))
    return VocabTree(centers=centers, branching=branching, depth=depth)


def save_vocab_tree(tree: VocabTree, path: str):
    np.savez(path, branching=tree.branching, depth=tree.depth,
             **tree_to_arrays(tree))


def load_vocab_tree(path: str, device="cuda") -> VocabTree:
    z = np.load(path)
    return tree_from_arrays(z, int(z["branching"]), int(z["depth"]), device)


def load_colmap_vocab_tree(path: str, device="cuda") -> VocabTree:
    """Import the visual-words block of a COLMAP/FLANN vocab-tree file
    (ref: src/retrieval/visual_index.h:539-558 VisualIndex::Read: uint64
    rows, uint64 cols, rows*cols uint8 words, then the FLANN index and
    the inverted index, which are not read). Returns a depth-1 tree whose
    single level holds all words, L2-normalized."""
    with open(path, "rb") as f:
        rows = struct.unpack("<Q", f.read(8))[0]
        cols = struct.unpack("<Q", f.read(8))[0]
        if not (0 < rows <= 100_000_000) or cols != 128:
            raise ValueError(
                f"{path}: not a COLMAP vocab tree (rows={rows}, "
                f"cols={cols}; expected 128-D uint8 words)")
        data = f.read(rows * cols)
        if len(data) != rows * cols:
            raise ValueError(f"{path}: truncated visual words block")
    words = np.frombuffer(data, np.uint8).reshape(rows, cols)
    centers = words.astype(np.float32)
    centers /= np.maximum(
        np.linalg.norm(centers, axis=1, keepdims=True), 1e-12)
    return VocabTree(centers=(torch.as_tensor(centers, device=device)[None],),
                     branching=int(rows), depth=1)


def save_colmap_vocab_tree(tree: VocabTree, path: str, seed: int = 0):
    """Export in the reference's on-disk vocab-tree format (ref:
    src/retrieval/visual_index.h:590-621 VisualIndex::Write), byte for
    byte as sba_tpu writes it:

    1. visual words: uint64 rows, uint64 cols=128, rows*cols uint8 (the
       leaf centres times 512, rounded and clipped);
    2. the FLANN index blob: int32 FLANN_INDEX_LINEAR (0) + int32 checks
       (a linear index has an empty blob);
    3. the inverted index (ref: inverted_index.h:385-411): int32 words,
       int32 embedding dim 64, a 64x128 float32 Gaussian projection from
       `numpy.random.default_rng(seed)`, one empty inverted file per
       word (uint8 0, float32 idf 0, 64 float32 thresholds 0, uint32 0
       entries) and int32 0 images.
    """
    leaf = tree.centers[-1].cpu().numpy().astype(np.float32).reshape(-1, 128)
    words = np.clip(np.round(leaf * 512.0), 0, 255).astype(np.uint8)
    rows, cols = words.shape
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((64, 128)).astype(np.float32)

    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", rows, cols))
        f.write(words.tobytes())
        f.write(struct.pack("<ii", 0, 32))
        f.write(struct.pack("<ii", rows, 64))
        f.write(proj.tobytes())
        empty_file = struct.pack("<Bf", 0, 0.0) \
            + struct.pack("<64f", *([0.0] * 64)) \
            + struct.pack("<I", 0)
        for _ in range(rows):
            f.write(empty_file)
        f.write(struct.pack("<i", 0))
    return path


def load_any_vocab_tree(path: str, device="cuda") -> VocabTree:
    """Load either the .npz trees or COLMAP .bin trees."""
    if path.endswith(".npz"):
        return load_vocab_tree(path, device)
    try:
        return load_colmap_vocab_tree(path, device)
    except (ValueError, struct.error):
        return load_vocab_tree(path, device)
