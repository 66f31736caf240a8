"""The port's retrieval (vocabulary tree, its two file formats, the visual
index, vote-and-verify), its three vocab-tree commands and the
sequential matcher's loop detection against sba_tpu on the CPU.

Trees built by one package are handed to the other through its files;
`build_vocab_tree` gets sba_tpu's own `jax.random.categorical` draws
through `draw_fn`. The commands' retrieval is compared through the pair
schedule each hands to matching (matching and verification are held by
tests/test_torch_frontend.py); the loop-detection test runs the port's
whole sequential matcher on a rendered ring.
"""

import contextlib
import io
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sba_tpu.retrieval import visual_index as jvi
from sba_tpu.retrieval import vocab_tree as jvt
from sba_tpu.retrieval import vote_and_verify as jvv
from sba_tpu_torch.retrieval import visual_index as tvi
from sba_tpu_torch.retrieval import vocab_tree as tvt
from sba_tpu_torch.retrieval import vote_and_verify as tvv


def _clustered_descriptors(rng, n_clusters, per_cluster, spread=0.05):
    """tests/test_retrieval.py's clustered unit descriptors."""
    centers = rng.standard_normal((n_clusters, 128))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    d = np.repeat(centers, per_cluster, 0) \
        + spread * rng.standard_normal((n_clusters * per_cluster, 128))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    labels = np.repeat(np.arange(n_clusters), per_cluster)
    return d.astype(np.float32), labels


def jax_draws(seed=0):
    """`draw_fn` for the port's build_vocab_tree that hands in the draws
    sba_tpu's build makes with `seed`: per level, keys = split(key,
    nodes + 1); node m's key splits once for its initial centres and
    once more at every Lloyd step for its re-seed candidates."""
    st = {"key": jax.random.PRNGKey(seed), "level": None}

    def draw(level, step, members, k):
        mem = members.cpu().numpy()
        if st["level"] != level:
            keys = jax.random.split(st["key"], mem.shape[0] + 1)
            st["key"], st["node"], st["level"] = keys[0], list(keys[1:]), level
        out = []
        for m in range(mem.shape[0]):
            st["node"][m], sub = jax.random.split(st["node"][m])
            w = jnp.asarray(mem[m].astype(np.float32))
            logits = jnp.where(w > 0, 0.0, -jnp.inf)   # as sba_tpu's
            out.append(np.asarray(jax.random.categorical(
                sub, logits, shape=(k,))))
        return torch.as_tensor(np.stack(out), dtype=torch.int64)
    return draw


def to_torch_tree(jtree):
    return tvt.VocabTree(tuple(torch.as_tensor(np.array(c))
                               for c in jtree.centers),
                         jtree.branching, jtree.depth)


def test_build_vocab_tree_with_sba_tpu_draws():
    """The same centres (1e-5) at every level, and the same words."""
    rng = np.random.default_rng(0)
    d, _ = _clustered_descriptors(rng, 12, 40)
    jt = jvt.build_vocab_tree(d, branching=4, depth=2, iters=6, seed=3)
    tt = tvt.build_vocab_tree(d, branching=4, depth=2, iters=6, seed=3,
                              device="cpu", draw_fn=jax_draws(3))
    for cj, ct in zip(jt.centers, tt.centers):
        assert tuple(ct.shape) == cj.shape
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5,
                                   rtol=0)
    np.testing.assert_array_equal(
        tvt.quantize_descriptors(tt, d).numpy(),
        np.asarray(jvt.quantize_descriptors(jt, d)))
    own = tvt.build_vocab_tree(d, branching=4, depth=2, iters=6,
                               device="cpu")
    words = tvt.quantize_descriptors(own, d).numpy()
    assert own.num_words == 16 and words.min() >= 0 and words.max() < 16


def test_npz_trees_load_across_packages(tmp_path):
    """A tree saved by sba_tpu loads in the port and quantizes to the
    same words, and the reverse (a depth-3 tree, its tiles of rows of one
    node scored whole and in chunks)."""
    rng = np.random.default_rng(1)
    d, _ = _clustered_descriptors(rng, 10, 30)
    q = np.random.default_rng(5).standard_normal((400, 128)).astype(
        np.float32)
    jt = jvt.build_vocab_tree(d, branching=5, depth=2, iters=5)
    jvt.save_vocab_tree(jt, str(tmp_path / "j.npz"))
    tj = tvt.load_any_vocab_tree(str(tmp_path / "j.npz"), device="cpu")
    for x in (d, q):
        np.testing.assert_array_equal(
            tvt.quantize_descriptors(tj, x).numpy(),
            np.asarray(jvt.quantize_descriptors(jt, x)))
    tt = tvt.build_vocab_tree(d, branching=3, depth=3, iters=5,
                              device="cpu")
    tvt.save_vocab_tree(tt, str(tmp_path / "t.npz"))
    jt2 = jvt.load_any_vocab_tree(str(tmp_path / "t.npz"))
    old = tvt.SCORE_BYTES
    for chunk in (old, 4 * 3 * (128 + 128) * 2):   # and two tiles a chunk
        tvt.SCORE_BYTES = chunk
        try:
            for x in (d, q):
                np.testing.assert_array_equal(
                    np.asarray(jvt.quantize_descriptors(jt2, x)),
                    tvt.quantize_descriptors(tt, x).numpy())
        finally:
            tvt.SCORE_BYTES = old


def test_colmap_tree_files_match_sba_tpu(tmp_path):
    """Export: the same bytes for the same tree and seed. Import: the
    same centres, and the same words at depth 1 (where B is the word
    count); a bad header fails in both."""
    rng = np.random.default_rng(0)
    desc = rng.random((600, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    jt = jvt.build_vocab_tree(desc, branching=8, depth=2, seed=0)
    for seed in (0, 7):
        jvt.save_colmap_vocab_tree(jt, str(tmp_path / "j.bin"), seed=seed)
        tvt.save_colmap_vocab_tree(to_torch_tree(jt),
                                   str(tmp_path / "t.bin"), seed=seed)
        assert (tmp_path / "j.bin").read_bytes() \
            == (tmp_path / "t.bin").read_bytes()
    a = jvt.load_colmap_vocab_tree(str(tmp_path / "j.bin"))
    b = tvt.load_any_vocab_tree(str(tmp_path / "j.bin"), device="cpu")
    assert (b.branching, b.depth) == (a.branching, a.depth) == (64, 1)
    np.testing.assert_array_equal(b.centers[0].numpy(),
                                  np.asarray(a.centers[0]))
    np.testing.assert_array_equal(
        tvt.quantize_descriptors(b, desc).numpy(),
        np.asarray(jvt.quantize_descriptors(a, desc)))
    # A larger imported word list, quantized in row chunks.
    words = rng.integers(0, 256, size=(3000, 128), dtype=np.uint8)
    with open(tmp_path / "w.bin", "wb") as f:
        f.write(struct.pack("<QQ", 3000, 128) + words.tobytes() + b"\0" * 8)
    a = jvt.load_colmap_vocab_tree(str(tmp_path / "w.bin"))
    b = tvt.load_colmap_vocab_tree(str(tmp_path / "w.bin"), device="cpu")
    old = tvt.SCORE_BYTES
    tvt.SCORE_BYTES = 4 * 3000 * 64          # chunks of 64 rows
    try:
        np.testing.assert_array_equal(
            tvt.quantize_descriptors(b, desc).numpy(),
            np.asarray(jvt.quantize_descriptors(a, desc)))
    finally:
        tvt.SCORE_BYTES = old
    with open(tmp_path / "bad.bin", "wb") as f:
        f.write(struct.pack("<QQ", 64, 64) + b"\0" * (64 * 64))
    for load in (jvt.load_colmap_vocab_tree,
                 lambda p: tvt.load_colmap_vocab_tree(p, device="cpu")):
        with pytest.raises(ValueError):
            load(str(tmp_path / "bad.bin"))


def _similarity_fixture():
    """tests/test_retrieval.py:134's matches under one similarity, with
    20% outliers, and the scrambled correspondence."""
    rng = np.random.default_rng(0)
    n = 120
    x1 = rng.uniform(50, 950, size=(n, 2)).astype(np.float32)
    s1 = rng.uniform(1.0, 3.0, size=n).astype(np.float32)
    o1 = rng.uniform(0, 2 * np.pi, size=n).astype(np.float32)
    sc, th, tx, ty = 1.5, 0.3, 120.0, -40.0
    ca, sa = np.cos(th), np.sin(th)
    x2 = np.stack([sc * (ca * x1[:, 0] - sa * x1[:, 1]) + tx,
                   sc * (sa * x1[:, 0] + ca * x1[:, 1]) + ty], axis=1)
    g1 = np.concatenate([x1, s1[:, None], o1[:, None]], axis=1)
    g2 = np.concatenate([x2, (s1 * sc)[:, None], (o1 + th)[:, None]],
                        axis=1).astype(np.float32)
    bad = rng.choice(n, size=24, replace=False)
    g2_noisy = g2.copy()
    g2_noisy[bad, :2] = rng.uniform(0, 1000, size=(24, 2))
    return g1, g2_noisy, g2[rng.permutation(n)]


def test_vote_and_verify_matches_sba_tpu():
    g1, g2, g2_scrambled = _similarity_fixture()
    mask = np.ones(len(g1), bool)
    mask[::7] = False
    counts = []
    for b, m, opt in ((g2, None, {}), (g2_scrambled, None, {}),
                      (g2, mask, {}), (g2, None, dict(num_transformations=3,
                                                      min_num_votes=4))):
        j = int(jvv.vote_and_verify(g1, b, m, jvv.VoteAndVerifyOptions(**opt)))
        t = tvv.vote_and_verify(g1, b, m, tvv.VoteAndVerifyOptions(**opt),
                                device="cpu")
        assert t == j
        counts.append(t)
    assert counts[0] >= 120 - 24 - 5 and counts[1] < 20
    assert tvv.vote_and_verify(g1[:0], g2[:0], device="cpu") == 0
    s_j = jvv._match_transforms(g1, g2)
    s_t = tvv._match_transforms(torch.as_tensor(g1), torch.as_tensor(g2))
    for a, b in zip(s_j, s_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-4)
    words = np.random.default_rng(3).integers(0, 9, 50)
    geo = np.random.default_rng(4).random((50, 4)).astype(np.float32)
    for cap in (4096, 17):
        for a, b in zip(jvv.word_matches(words, geo, words[::-1], geo, cap),
                        tvv.word_matches(words, geo, words[::-1], geo, cap)):
            np.testing.assert_array_equal(a, b)


def _index_pair(tree_j, images, keypoints=None):
    ij, it = jvi.VisualIndex(tree_j), tvi.VisualIndex(to_torch_tree(tree_j))
    for k, d in images.items():
        kp = None if keypoints is None else keypoints[k]
        ij.add_image(k, d, keypoints=kp)
        it.add_image(k, d, keypoints=kp)
    ij.prepare()
    it.prepare()
    return ij, it


def same_ranking(a, b):
    assert [i for i, _ in a] == [i for i, _ in b], (a, b)
    np.testing.assert_allclose([s for _, s in b], [s for _, s in a],
                               rtol=0, atol=1e-6)


def test_visual_index_query_matches_sba_tpu():
    """tests/test_retrieval.py's index fixtures (overlapping clusters,
    spatial re-ranking with a scrambled distractor, repeated structure,
    the Hamming embedding): the same rankings and scores (1e-6), with
    and without re-ranking, and the same pair schedule."""
    rng = np.random.default_rng(2)
    d, labels = _clustered_descriptors(rng, 20, 30)
    tree = jvt.build_vocab_tree(d, branching=5, depth=2, iters=10)
    imgs = {100 + k: d[np.isin(labels, [(k + j) % 20 for j in range(3)])]
            for k in range(10)}
    ij, it = _index_pair(tree, imgs)
    for k in range(10):
        for ex in (None, 100 + k):
            same_ranking(ij.query(imgs[100 + k], 3, exclude_image_id=ex),
                         it.query(imgs[100 + k], 3, exclude_image_id=ex))
    np.testing.assert_array_equal(jvi.vocab_tree_pairs(ij, imgs, 2),
                                  tvi.vocab_tree_pairs(it, imgs, 2))
    np.testing.assert_array_equal(it._thresholds, ij._thresholds)

    # Spatial re-ranking: a true match and a BoW-equal scrambled copy.
    rng = np.random.default_rng(1)
    d, _ = _clustered_descriptors(rng, 10, 30)
    tree = jvt.build_vocab_tree(d, branching=5, depth=2, iters=10)
    kp = np.concatenate([rng.uniform(0, 800, size=(90, 2)),
                         rng.uniform(1, 3, size=(90, 1)),
                         rng.uniform(0, 2 * np.pi, size=(90, 1))],
                        axis=1).astype(np.float32)
    kp_true = kp.copy()
    kp_true[:, 0] += 50
    ij, it = _index_pair(tree, {1: d[:90], 2: d[:90]},
                         {1: kp_true, 2: kp[rng.permutation(90)]})
    for kw in ({}, dict(keypoints=kp, num_verifications=2)):
        same_ranking(ij.query(d[:90], 2, **kw), it.query(d[:90], 2, **kw))
    assert it.query(d[:90], 2, keypoints=kp, num_verifications=2)[0][0] == 1

    # The Hamming embedding: same words, one near and one far copy.
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((64, 128))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    tree = jvt.build_vocab_tree(centers.astype(np.float32), branching=8,
                                depth=2, iters=10)

    def jitter(word_ids, scale):
        x = centers[word_ids] + scale * rng.standard_normal(
            (len(word_ids), 128))
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(
            np.float32)

    q_words = rng.integers(0, 64, 80)
    dq = jitter(q_words, 0.03)
    near = dq + 0.01 * rng.standard_normal((80, 128)).astype(np.float32)
    near /= np.linalg.norm(near, axis=1, keepdims=True)
    imgs = {1: near, 2: jitter(q_words, 0.18)}
    imgs.update({k: jitter(rng.integers(0, 64, 80), 0.1)
                 for k in range(3, 9)})
    ij, it = _index_pair(tree, imgs)
    for kw in ({}, dict(num_verifications=4, hamming_rerank=True)):
        same_ranking(ij.query(dq, 4, **kw), it.query(dq, 4, **kw))
    assert it.query(dq, 2, num_verifications=4,
                    hamming_rerank=True)[0][0] == 1


# ---------------------------------------------------------------------------
# The commands
# ---------------------------------------------------------------------------


def _write_db(path, seed=0, n_images=8):
    """A database of `n_images` images whose descriptors come from
    overlapping clusters (image k: clusters k..k+2 of 2 n_images, as in
    tests/test_retrieval.py), with keypoints and one pinhole camera."""
    from sba_tpu_torch.io.database import Database

    rng = np.random.default_rng(seed)
    d, labels = _clustered_descriptors(rng, 2 * n_images, 40)
    db = Database(str(path))
    cam = db.write_camera(1, 640, 480, np.array([500.0, 500, 320, 240]))
    for k in range(n_images):
        sel = np.isin(labels, [k, k + 1, k + 2])
        desc = np.clip(np.round(d[sel] * 512), 0, 255).astype(np.uint8)
        iid = db.write_image(f"im{k:02d}.png", cam)
        kp = np.concatenate([rng.uniform(0, 640, (len(desc), 1)),
                             rng.uniform(0, 480, (len(desc), 1)),
                             np.ones((len(desc), 1)),
                             np.zeros((len(desc), 1))], 1)
        db.write_keypoints(iid, kp.astype(np.float32))
        db.write_descriptors(iid, desc)
    db.commit()
    db.close()


@pytest.fixture
def schedules(monkeypatch):
    """Both CLIs' `_match_and_verify` replaced by a recorder of the pair
    schedule (positional pairs over the sorted image ids)."""
    from sba_tpu import cli as jcli
    from sba_tpu_torch import cli as tcli

    seen = {}
    for tag, mod in (("j", jcli), ("t", tcli)):
        def rec(db, pairs, image_ids, flags, tag=tag):
            seen.setdefault(tag, []).append(
                (sorted(tuple(int(v) for v in p) for p in pairs),
                 list(image_ids)))
            return len(pairs)
        monkeypatch.setattr(mod, "_match_and_verify", rec)
    return seen


def _run(mod, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main(args) == 0
    return out.getvalue().splitlines()


def test_vocab_tree_commands_match_sba_tpu(tmp_path, schedules,
                                           monkeypatch):
    """vocab_tree_builder (the port handed sba_tpu's draws) writes a tree
    with sba_tpu's centres (1e-5); on sba_tpu's tree, vocab_tree_matcher
    retrieves the same pair schedule and vocab_tree_retriever prints the
    same rankings; both load a COLMAP .bin tree."""
    from sba_tpu import cli as jcli
    from sba_tpu_torch import cli as tcli

    db = tmp_path / "db.db"
    _write_db(db)
    own = tvt.build_vocab_tree
    monkeypatch.setattr(tvt, "build_vocab_tree", lambda d, **kw: own(
        d, **kw, draw_fn=jax_draws(kw.get("seed", 0))))
    flags = ["--database_path", str(db), "--VocabTree.branching", "4",
             "--VocabTree.max_num_descriptors", "500"]
    lj = _run(jcli, ["vocab_tree_builder", "--vocab_tree_path",
                     str(tmp_path / "j.npz")] + flags)
    lt = _run(tcli, ["vocab_tree_builder", "--vocab_tree_path",
                     str(tmp_path / "t.npz"), "--device", "cpu"] + flags)
    assert lt[0].replace("t.npz", "j.npz") == lj[0]
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    for key in ("level_0", "level_1"):
        np.testing.assert_allclose(zt[key], zj[key], atol=1e-5, rtol=0)

    jt = jvt.load_vocab_tree(str(tmp_path / "j.npz"))
    jvt.save_colmap_vocab_tree(jt, str(tmp_path / "j.bin"))
    for tree in ("j.npz", "j.bin"):
        for mod, dev in ((jcli, []), (tcli, ["--device", "cpu"])):
            _run(mod, ["vocab_tree_matcher", "--database_path", str(db),
                       "--vocab_tree_path", str(tmp_path / tree),
                       "--VocabTreeMatching.num_images", "3"] + dev)
        assert schedules["t"][-1] == schedules["j"][-1]
        assert len(schedules["t"][-1][0]) >= 8
        rj = _run(jcli, ["vocab_tree_retriever", "--database_path", str(db),
                         "--vocab_tree_path", str(tmp_path / tree),
                         "--num_images", "4"])
        rt = _run(tcli, ["vocab_tree_retriever", "--database_path", str(db),
                         "--vocab_tree_path", str(tmp_path / tree),
                         "--num_images", "4", "--device", "cpu"])
        assert rt[:-1] == rj and len(rj) == 8 * 4
    with open(tmp_path / "q.txt", "w") as f:
        f.write("im03.png\nim05.png\n")
    args = ["vocab_tree_retriever", "--database_path", str(db),
            "--vocab_tree_path", str(tmp_path / "j.npz"),
            "--query_image_list_path", str(tmp_path / "q.txt")]
    assert _run(tcli, args + ["--device", "cpu"])[:-1] == _run(jcli, args)
    for cmd in ("vocab_tree_builder", "vocab_tree_matcher",
                "vocab_tree_retriever"):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tcli.main([cmd, "--database_path", str(db), "--vocab_tree_path",
                       str(tmp_path / "j.npz")])


def test_loop_detection_schedule_matches_sba_tpu(tmp_path, schedules,
                                                 monkeypatch):
    """sequential_matcher --SequentialMatching.loop_detection 1: the same
    schedule as sba_tpu's with its own 8x8 tree (the port handed
    sba_tpu's draws) and with a tree file."""
    from sba_tpu import cli as jcli
    from sba_tpu_torch import cli as tcli

    db = tmp_path / "db.db"
    _write_db(db, seed=3, n_images=12)
    own = tvt.build_vocab_tree
    monkeypatch.setattr(tvt, "build_vocab_tree", lambda d, **kw: own(
        d, **kw, draw_fn=jax_draws(kw.get("seed", 0))))
    args = ["sequential_matcher", "--database_path", str(db),
            "--SequentialMatching.overlap", "2",
            "--SequentialMatching.quadratic_overlap", "0",
            "--SequentialMatching.loop_detection", "1",
            "--SequentialMatching.loop_detection_period", "3",
            "--SequentialMatching.loop_detection_num_images", "4"]
    jt = jvt.build_vocab_tree(
        np.random.default_rng(2).standard_normal((300, 128)).astype(
            np.float32), branching=4, depth=2)
    jvt.save_vocab_tree(jt, str(tmp_path / "tree.npz"))
    for extra in ([], ["--SequentialMatching.vocab_tree_path",
                       str(tmp_path / "tree.npz")]):
        lj = _run(jcli, args + extra)
        lt = _run(tcli, args + extra + ["--device", "cpu"])
        assert lt[0] == lj[0] and lt[0].startswith("loop detection added")
        assert schedules["t"][-1] == schedules["j"][-1]
        assert len(schedules["t"][-1][0]) > 11 + 10


def test_loop_detection_closes_the_ring(tmp_path):
    """tests/test_loop_detection.py:44 on the port alone: a 12-view ring
    matched with overlap 2 verifies no pair across the ring's seam; with
    loop detection the retrieved seam pairs are matched and verified."""
    from sba_tpu_torch import cli as tcli
    from sba_tpu_torch.io.database import Database
    from sba_tpu_torch.utils.render import render_scene, write_scene_images

    n = 12
    scene = render_scene(num_images=n, image_size=(200, 150),
                         ring_radius=1.8, jitter=0.03, seed=4, device="cpu")
    write_scene_images(scene, str(tmp_path / "images"))
    base = tmp_path / "db.db"
    _run(tcli, ["feature_extractor", "--database_path", str(base),
                "--image_path", str(tmp_path / "images"), "--device", "cpu",
                "--ImageReader.camera_model", "SIMPLE_PINHOLE",
                "--ImageReader.single_camera", "1",
                "--SiftExtraction.max_num_features", "1024"])
    seam = {}
    for loop in (0, 1):
        db = tmp_path / f"db_{loop}.db"
        db.write_bytes(base.read_bytes())
        lines = _run(tcli, [
            "sequential_matcher", "--database_path", str(db), "--device",
            "cpu", "--TwoViewGeometry.max_num_trials", "256",
            "--SequentialMatching.overlap", "2",
            "--SequentialMatching.quadratic_overlap", "0",
            "--SequentialMatching.loop_detection", str(loop),
            "--SequentialMatching.loop_detection_period", "3",
            "--SequentialMatching.loop_detection_num_images", "4"])
        h = Database(str(db))
        ids = sorted(h.read_images())
        geoms = h.read_all_two_view_geometries()
        h.close()
        seam[loop] = [
            (i, j) for i in range(n) for j in range(i + 3, n)
            if min(j - i, n - (j - i)) <= 2
            and len(geoms.get((ids[i], ids[j]), {}).get(
                "inlier_matches", ())) >= 15]
    assert seam[0] == []
    assert len(seam[1]) >= 1, lines
