"""The port's COLMAP database (`sba_tpu_torch.io.database`) against
sba_tpu's: a database written by either package reads the same through
the other (every table, blob bytes equal), the pair-id packing and
`swap_matches` agree, and the database commands of both CLIs leave equal
tables."""

import shutil
import sqlite3

import numpy as np
import pytest

import sba_tpu.io.database as jdb
import sba_tpu_torch.io.database as tdb

PACKAGES = {"sba_tpu": jdb, "port": tdb}


def _dump(path):
    """Every table's schema and rows (blobs as bytes), in key order."""
    conn = sqlite3.connect(path)
    try:
        out = {}
        for name, sql in conn.execute(
                "SELECT name, sql FROM sqlite_master ORDER BY name"):
            table = (sql or "").startswith("CREATE TABLE")
            rows = (conn.execute(f"SELECT * FROM {name} ORDER BY 1")
                    .fetchall() if table else None)
            out[name] = (sql, rows)
        return out
    finally:
        conn.close()


def _fill(db, prefix="im", seed=0):
    """Two cameras, three images (priors on one), keypoints with 4 and 6
    columns, descriptors, matches written in both pair orders and
    two-view geometries with and without their matrices."""
    rng = np.random.default_rng(seed)
    c1 = db.write_camera(0, 640, 480, [500.0, 320.0, 240.0])
    c2 = db.write_camera(2, 800, 600, [600.0, 400.0, 300.0, 0.01],
                         prior_focal_length=True)
    ids = [db.write_image(f"{prefix}_a.png", c1),
           db.write_image(f"{prefix}_b.png", c2,
                          prior_q=(1.0, 0.0, 0.0, 0.0),
                          prior_t=(0.5, -1.0, 2.0)),
           db.write_image(f"{prefix}_c.png", c1, image_id=7)]
    for k, iid in enumerate(ids):
        cols = 6 if k == 1 else 4
        db.write_keypoints(iid, rng.normal(size=(5 + k, cols)))
        db.write_descriptors(iid, rng.integers(0, 256, size=(5 + k, 128)))
    db.write_matches(ids[0], ids[1], np.array([[0, 1], [2, 3]]))
    db.write_matches(ids[2], ids[0], np.array([[4, 0], [1, 2], [3, 3]]))
    db.write_two_view_geometry(ids[1], ids[0], np.array([[1, 0]]),
                               config=3, F=rng.normal(size=(3, 3)),
                               E=rng.normal(size=(3, 3)),
                               H=rng.normal(size=(3, 3)),
                               qvec=[0.9, 0.1, 0.2, 0.3],
                               tvec=[1.0, 2.0, 3.0])
    db.write_two_view_geometry(ids[0], ids[2], np.zeros((0, 2)))
    db.commit()
    return ids


def _read_all(db, ids):
    out = dict(cameras=db.read_cameras(), images=db.read_images(),
               matches=db.read_all_matches(),
               tvg=db.read_all_two_view_geometries(),
               counts=(db.num_cameras(), db.num_images(),
                       db.num_keypoints(), db.num_matches()))
    for i in ids:
        out[("kp", i)] = db.read_keypoints(i)
        out[("desc", i)] = db.read_descriptors(i)
        out[("n", i)] = db.num_keypoints_for_image(i)
        out[("name", i)] = db.image_id_from_name(out["images"][i]["name"])
        for j in ids:
            if i != j:
                out[("m", i, j)] = db.read_matches(i, j)
                if {i, j} != {ids[1], ids[2]}:
                    out[("g", i, j)] = db.read_two_view_geometry(i, j)
    out[("missing",)] = (db.read_keypoints(999).shape,
                         db.read_descriptors(999).shape,
                         db.read_matches(ids[1], ids[2]).shape)
    return out


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


@pytest.mark.parametrize("writer", ["sba_tpu", "port"])
def test_database_reads_the_same_through_either_package(tmp_path, writer):
    path = str(tmp_path / "db.db")
    with PACKAGES[writer].Database(path) as db:
        ids = _fill(db)
    reads = {}
    for name, mod in PACKAGES.items():
        with mod.Database(path) as db:
            reads[name] = _read_all(db, ids)
    _assert_same(reads["port"], reads["sba_tpu"])
    assert reads["port"][("m", ids[1], ids[0])].tolist() == [[1, 0], [3, 2]]
    assert reads["port"]["counts"] == (2, 3, 18, 5)


def test_both_packages_write_the_same_bytes(tmp_path):
    for name, mod in PACKAGES.items():
        with mod.Database(str(tmp_path / f"{name}.db")) as db:
            _fill(db)
    a, b = (_dump(str(tmp_path / f"{n}.db")) for n in PACKAGES)
    assert a == b
    assert len(a["two_view_geometries"][1]) == 2


def test_pair_ids_and_swap_match_sba_tpu():
    rng = np.random.default_rng(0)
    pairs = [(1, 2), (2, 1), (5, 5), (2147483646, 3), (0, 2147483646)]
    pairs += [tuple(int(x) for x in rng.integers(0, 2 ** 31 - 1, size=2))
              for _ in range(50)]
    for i, j in pairs:
        pid = tdb.image_pair_to_pair_id(i, j)
        assert pid == jdb.image_pair_to_pair_id(i, j)
        assert tdb.pair_id_to_image_pair(pid) == jdb.pair_id_to_image_pair(
            pid) == (min(i, j), max(i, j))
    m = rng.integers(0, 1000, size=(7, 2)).astype(np.uint32)
    np.testing.assert_array_equal(tdb.swap_matches(m), jdb.swap_matches(m))
    assert tdb.swap_matches(m).flags["C_CONTIGUOUS"]
    assert tdb.MAX_IMAGE_ID == jdb.MAX_IMAGE_ID


def _two_databases(tmp_path):
    paths = []
    for k, prefix in enumerate(("x", "y")):
        p = str(tmp_path / f"{prefix}.db")
        with tdb.Database(p) as db:
            _fill(db, prefix, seed=k)
        paths.append(p)
    return paths


def _run_both(tmp_path, args_of):
    """Run a command through both CLIs, each on its own copies of the
    inputs; returns the two dumps of the database it leaves."""
    from sba_tpu.cli import main as jmain
    from sba_tpu_torch.cli import main as tmain

    dumps = []
    for tag, main in (("j", jmain), ("t", tmain)):
        work = tmp_path / tag
        work.mkdir()
        for src in tmp_path.glob("*.db"):
            shutil.copy(src, work / src.name)
        args, out = args_of(work)
        assert main(args) == 0
        dumps.append(_dump(str(out)))
    return dumps


def test_database_creator_matches_sba_tpu(tmp_path, capsys):
    j, t = _run_both(tmp_path, lambda w: (
        ["database_creator", "--database_path", str(w / "new.db")],
        w / "new.db"))
    assert j == t
    assert {"cameras", "images", "keypoints", "descriptors", "matches",
            "two_view_geometries"} <= set(t)
    assert "created database" in capsys.readouterr().out


def test_database_merger_matches_sba_tpu(tmp_path, capsys):
    _two_databases(tmp_path)
    j, t = _run_both(tmp_path, lambda w: (
        ["database_merger", "--database_path1", str(w / "x.db"),
         "--database_path2", str(w / "y.db"),
         "--merged_database_path", str(w / "m.db")], w / "m.db"))
    assert j == t
    assert len(t["images"][1]) == 6 and len(t["matches"][1]) == 4
    assert capsys.readouterr().out.count("merged") == 2


@pytest.mark.parametrize("clean_type", ["matches", "features", "all"])
def test_database_cleaner_matches_sba_tpu(tmp_path, capsys, clean_type):
    _two_databases(tmp_path)
    j, t = _run_both(tmp_path, lambda w: (
        ["database_cleaner", "--database_path", str(w / "x.db"),
         "--type", clean_type], w / "x.db"))
    assert j == t
    left = {name: len(rows) for name, (_, rows) in t.items()
            if rows is not None and name != "sqlite_sequence"}
    assert (left["matches"] == 0) == (clean_type != "features")
    assert (left["keypoints"] == 0) == (clean_type != "matches")
    assert (left["images"] == 0) == (clean_type == "all")
    assert f"cleaned ({clean_type})" in capsys.readouterr().out
