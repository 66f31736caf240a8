"""Inverted-file image retrieval index over vocab-tree visual words.

Port of ``sba_tpu/retrieval/visual_index.py`` (ref:
src/retrieval/visual_index.h:61 `VisualIndex`: TF-IDF-weighted scoring,
vote-and-verify spatial re-ranking and Hamming-embedding re-ranking per
src/retrieval/inverted_index.h; src/feature/matching.h:456
`VocabTreeFeatureMatcher`'s pair selection).

The index (histograms, TF-IDF matrix, Hamming codes and thresholds)
stays on the host in numpy, as in sba_tpu; quantization and
vote-and-verify run on the tree's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from sba_tpu_torch.retrieval.vocab_tree import VocabTree, quantize_descriptors
from sba_tpu_torch.retrieval.vote_and_verify import (vote_and_verify,
                                                     word_matches)


class VisualIndex:
    """TF-IDF retrieval index (ref: visual_index.h Add/Prepare/Query)."""

    EMBED_DIM = 64        # ref: VisualIndex<..., 64> Hamming embedding
    HAMMING_MAX_DIST = 24  # ref inverted_file.h voting gate
    HAMMING_SIGMA = 16.0   # gaussian distance->weight functor width

    def __init__(self, tree: VocabTree):
        self.tree = tree
        self._image_ids: List[int] = []
        self._histograms: List[np.ndarray] = []
        self._idf: Optional[np.ndarray] = None
        self._matrix: Optional[np.ndarray] = None
        self._words: Dict[int, np.ndarray] = {}
        self._geoms: Dict[int, np.ndarray] = {}
        # Hamming embedding (ref: inverted_index.h): fixed orthogonal
        # projection of descriptors to EMBED_DIM, binarized against
        # per-word median thresholds learned at prepare().
        rng = np.random.default_rng(42)
        qm, _ = np.linalg.qr(rng.standard_normal((128, 128)))
        self._proj = qm[: self.EMBED_DIM].astype(np.float32)  # [64, 128]
        self._proj_desc: Dict[int, np.ndarray] = {}   # [N, 64] float
        self._codes: Dict[int, np.ndarray] = {}       # [N, 64] bool
        self._thresholds: Optional[np.ndarray] = None  # [W, 64]

    def _quantize(self, descriptors) -> np.ndarray:
        return quantize_descriptors(self.tree, descriptors).cpu().numpy()

    def add_image(self, image_id: int, descriptors, keypoints=None) -> None:
        """keypoints [N, 4] (x, y, scale, orientation) enables
        vote-and-verify spatial re-ranking at query time."""
        words = self._quantize(descriptors)
        hist = np.bincount(words, minlength=self.tree.num_words) \
            .astype(np.float32)
        self._image_ids.append(image_id)
        self._histograms.append(hist)
        self._words[image_id] = words
        self._proj_desc[image_id] = (
            np.asarray(descriptors, np.float32) @ self._proj.T)
        if keypoints is not None:
            self._geoms[image_id] = np.asarray(keypoints, np.float32)
        self._idf = None  # invalidate

    def prepare(self) -> None:
        """Finalize TF-IDF weights + Hamming embedding thresholds
        (ref: VisualIndex::Prepare, InvertedIndex::ComputeHammingEmbedding
        — per-word per-dim medians of the projected descriptors)."""
        H = np.stack(self._histograms)  # [M, W]
        df = (H > 0).sum(0)
        m = len(self._image_ids)
        self._idf = np.log(m / np.maximum(df, 1)).astype(np.float32)
        tfidf = H * self._idf[None, :]
        norms = np.linalg.norm(tfidf, axis=1, keepdims=True)
        self._matrix = tfidf / np.maximum(norms, 1e-9)

        all_words = np.concatenate(
            [self._words[i] for i in self._image_ids])
        all_proj = np.concatenate(
            [self._proj_desc[i] for i in self._image_ids])
        W = self.tree.num_words
        # Few entries (< 5) -> the corpus medians. Each word's rows are
        # one slice of the word-sorted rows (a median does not depend on
        # the order of its values).
        thr = np.empty((W, self.EMBED_DIM), np.float32)
        thr[:] = np.median(all_proj, axis=0)
        order = np.argsort(all_words, kind="stable")
        present, start, count = np.unique(all_words[order],
                                          return_index=True,
                                          return_counts=True)
        for w, s0, c in zip(present, start, count):
            if c >= 5:
                thr[w] = np.median(all_proj[order[s0:s0 + c]], axis=0)
        self._thresholds = thr
        for iid in self._image_ids:
            self._codes[iid] = (
                self._proj_desc[iid] > thr[self._words[iid]])

    def _hamming_score(self, words_q, codes_q, iid) -> float:
        """Normalized Hamming-embedding agreement with image `iid`
        (ref: inverted_file.h ScoreFeature)."""
        words_db = self._words[iid]
        codes_db = self._codes[iid]
        same = words_q[:, None] == words_db[None, :]        # [Nq, Nd]
        if not same.any():
            return 0.0
        dist = (codes_q[:, None, :] ^ codes_db[None, :, :]).sum(-1)
        w = np.exp(-(dist.astype(np.float32) ** 2)
                   / (self.HAMMING_SIGMA ** 2))
        w = np.where(same & (dist <= self.HAMMING_MAX_DIST), w, 0.0)
        return float(w.max(axis=1).sum() / max(len(words_q), 1))

    def query(self, descriptors, num_images: int = 10,
              exclude_image_id: Optional[int] = None,
              keypoints=None, num_verifications: int = 0,
              hamming_rerank: bool = False
              ) -> List[Tuple[int, float]]:
        """-> [(image_id, score)] ranked by cosine TF-IDF similarity;
        with `hamming_rerank` the top `num_verifications` candidates gain
        their Hamming-embedding agreement, and with `keypoints` [N, 4]
        their vote-and-verify inlier count (ref: visual_index.h:483)."""
        if self._idf is None or self._matrix is None:
            self.prepare()
        words = self._quantize(descriptors)
        hist = np.bincount(words, minlength=self.tree.num_words) \
            .astype(np.float32)
        q = hist * self._idf
        q = q / max(np.linalg.norm(q), 1e-9)
        scores = self._matrix @ q  # [M]
        order = np.argsort(-scores)
        out = []
        for k in order:
            iid = self._image_ids[k]
            if exclude_image_id is not None and iid == exclude_image_id:
                continue
            out.append((iid, float(scores[k])))
            if len(out) >= max(num_images, num_verifications):
                break

        if hamming_rerank and num_verifications > 0:
            codes_q = (np.asarray(descriptors, np.float32) @ self._proj.T
                       > self._thresholds[words])
            reranked = []
            for iid, score in out[:num_verifications]:
                score += self._hamming_score(words, codes_q, iid)
                reranked.append((iid, score))
            reranked += out[num_verifications:]
            reranked.sort(key=lambda t: -t[1])
            out = reranked

        if num_verifications > 0 and keypoints is not None:
            reranked = []
            for iid, score in out[:num_verifications]:
                if iid in self._geoms:
                    g1, g2 = word_matches(words, np.asarray(keypoints),
                                          self._words[iid],
                                          self._geoms[iid])
                    if len(g1):
                        score += vote_and_verify(g1, g2,
                                                 device=self.tree.device)
                reranked.append((iid, score))
            reranked += out[num_verifications:]
            reranked.sort(key=lambda t: -t[1])
            out = reranked
        return out[:num_images]

    def num_images(self) -> int:
        return len(self._image_ids)


def vocab_tree_pairs(index: VisualIndex, queries: Dict[int, np.ndarray],
                     num_images: int = 10) -> np.ndarray:
    """Retrieval-based pair schedule: for each query image, its top
    retrieved partners (ref: matching.h:456 VocabTreeFeatureMatcher).
    Returns [M, 2] image-ID pairs (id1 < id2, deduped)."""
    pairs = set()
    for iid, desc in queries.items():
        for other, _score in index.query(desc, num_images,
                                         exclude_image_id=iid):
            pairs.add((min(iid, other), max(iid, other)))
    return np.asarray(sorted(pairs), np.int64).reshape(-1, 2)
