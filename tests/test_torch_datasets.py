"""Port parity of the VLN data tooling: the episode files
(``runtime/datasets.py``), the MatterSim-graph converter
(``tools/discrete_to_ce.py``) and the topological graphs
(``utils/graph.py``).  Host-side code on the same files or inputs, made
from a seed: every output is identical, the written files byte for byte
once decompressed."""

import gzip
import importlib.util
import json
import os
import random
import sys

import numpy as np
import pytest

import chip_smoke as smoke
from dynam3d_tpu.runtime import datasets as jds
from dynam3d_tpu.utils import graph as jgraph
from dynam3d_torch.runtime import datasets as tds
from dynam3d_torch.tools import discrete_to_ce as td2c
from dynam3d_torch.utils import graph as tgraph

_spec = importlib.util.spec_from_file_location(
    "reference_discrete_to_ce",
    os.path.join(os.path.dirname(__file__), "..", "tools", "discrete_to_ce.py"))
jd2c = sys.modules[_spec.name] = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jd2c)

WORDS = ("walk", "past", "the", "sofa", "kitchen", "stairs", "door", "turn", "left", "right",
         "stop", "painting", "bedroom", "hall", "table", "window")


def _read(path: str) -> bytes:
    with (gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")) as f:
        return f.read()


def _episode_dicts(rng, n: int):
    scenes = ["hm3d/train/00800-TEEsavR23oF/TEEsavR23oF.basis.glb",
              "mp3d/17DRP5sb8fy/17DRP5sb8fy.glb", "mp3d/2azQ1b91cZZ/2azQ1b91cZZ.glb"]
    out = []
    for i in range(n):
        e = {
            "episode_id": int(rng.integers(0, 10**6)),
            "scene_id": scenes[int(rng.integers(0, len(scenes)))],
            "start_position": rng.normal(size=3).tolist(),
            "start_rotation": rng.normal(size=4).tolist(),
            "goals": [{"position": rng.normal(size=3).tolist(), "radius": 3.0}],
            "reference_path": rng.normal(size=(int(rng.integers(2, 6)), 3)).tolist(),
            "instruction": {"instruction_text": " ".join(rng.choice(WORDS, 8)),
                            "instruction_tokens": rng.integers(0, 99, 6).tolist()},
        }
        if i % 3:
            e["trajectory_id"] = int(rng.integers(0, 99))
            e["info"] = {"geodesic_distance": float(rng.uniform(1, 20))}
        if i % 4 == 3:
            del e["instruction"]
        out.append(e)
    return out


@pytest.mark.parametrize("name", ["val_seen.json.gz", "train.json", "list.json"])
def test_episode_files_match_reference(tmp_path, name):
    """``load_episodes`` / ``Episode.from_json`` on a file with optional
    fields missing, ``filter_episodes``, ``episodes_by_scene`` and
    ``write_episodes``: the same episodes and the same written bytes."""
    rng = np.random.default_rng(7)
    eps = _episode_dicts(rng, 12)
    path = str(tmp_path / name)
    with (gzip.open(path, "wt") if name.endswith(".gz") else open(path, "w")) as f:
        json.dump(eps if name == "list.json" else {"episodes": eps}, f)
    je, te = jds.load_episodes(path), tds.load_episodes(path)
    assert [vars(e) for e in te] == [vars(e) for e in je]
    ids = [e.episode_id for e in je[::3]]
    for scenes in (None, ["17DRP5sb8fy"], ["TEEsavR23oF", "2azQ1b91cZZ"]):
        for allowed in (None, ids):
            assert ([vars(e) for e in tds.filter_episodes(te, allowed, scenes)]
                    == [vars(e) for e in jds.filter_episodes(je, allowed, scenes)])
    jg, tg = jds.episodes_by_scene(je), tds.episodes_by_scene(te)
    assert list(tg) == list(jg)
    assert all([vars(e) for e in tg[k]] == [vars(e) for e in jg[k]] for k in jg)
    out = "out.json.gz" if name.endswith(".gz") else "out.json"
    jds.write_episodes(str(tmp_path / f"j_{out}"), je)
    tds.write_episodes(str(tmp_path / f"t_{out}"), te)
    assert _read(str(tmp_path / f"t_{out}")) == _read(str(tmp_path / f"j_{out}"))


def test_load_gt_matches_reference(tmp_path):
    rng = np.random.default_rng(3)
    gt = {i: {"locations": rng.normal(size=(4, 3)).tolist(), "actions": [1, 2, 0]}
          for i in range(5)}
    path = str(tmp_path / "val_gt.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump(gt, f)
    assert tds.load_gt(path) == jds.load_gt(path)


@pytest.mark.parametrize("files", [("a.basis.glb", "b.basis.glb", "c.glb", "d.glb"),
                                   ("a.glb", "b.glb"), ("x.basis.glb",)])
def test_sample_two_scene_files_matches_reference(tmp_path, files):
    for name in files:
        (tmp_path / name).write_text("")
    jr, tr = random.Random(5), random.Random(5)
    for _ in range(20):
        assert (sorted(tds.sample_two_scene_files(str(tmp_path), tr))
                == sorted(jds.sample_two_scene_files(str(tmp_path), jr)))


# ---------------------------------------------------------------------------
# discrete_to_ce on a generated MatterSim-style graph
# ---------------------------------------------------------------------------
def make_items(root: str, seed: int):
    """``chip_smoke``'s discrete dataset at 12 viewpoints a scan and 30
    items, read back; returns the items and the connectivity directory."""
    items, conn = smoke.write_discrete_dataset(root, seed, viewpoints=12, items=30)
    with open(items) as f:
        return json.load(f), conn


@pytest.mark.parametrize("dataset", sorted(td2c.DATASETS))
def test_convert_items_matches_reference(tmp_path, dataset):
    """Every dataset spec: the same episodes and gt records, and the same
    files from ``write_outputs``."""
    items, conn = make_items(str(tmp_path), 11)
    je, jg = jd2c.convert_items(items, conn, jd2c.DATASETS[dataset])
    te, tg = td2c.convert_items(items, conn, td2c.DATASETS[dataset])
    assert je and te == je and tg == jg
    per_scene = td2c.DATASETS[dataset].per_scene_output
    out = "shards" if per_scene else "eps.json.gz"
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    jd2c.write_outputs(je, jg, str(tmp_path / "j" / out), str(tmp_path / "j_gt.json.gz"),
                       per_scene)
    td2c.write_outputs(te, tg, str(tmp_path / "t" / out), str(tmp_path / "t_gt.json.gz"),
                       per_scene)
    assert _read(str(tmp_path / "t_gt.json.gz")) == _read(str(tmp_path / "j_gt.json.gz"))
    if per_scene:
        names = sorted(os.listdir(tmp_path / "j" / out))
        assert sorted(os.listdir(tmp_path / "t" / out)) == names and names
        for n in names:
            assert _read(str(tmp_path / "t" / out / n)) == _read(str(tmp_path / "j" / out / n))
    else:
        assert _read(str(tmp_path / "t" / out)) == _read(str(tmp_path / "j" / out))


def test_convert_items_hooks_match_reference(tmp_path):
    """The simulator hooks (``geodesic_fn``, ``snap_fn``), a start id and
    the per-scene shuffle's seed."""
    items, conn = make_items(str(tmp_path), 12)

    def geo(scan, a, b):
        return 2.0 + len(scan) * 0.1 + (a < b)

    def snap(scan, p):
        return [p[0] + 0.01, p[1] - 0.07, p[2]]

    for spec in ("navrag_train", "reverie_val"):
        kw = dict(geodesic_fn=geo, snap_fn=snap, start_episode_id=77, rng_seed=3)
        j = jd2c.convert_items(items, conn, jd2c.DATASETS[spec], **kw)
        t = td2c.convert_items(items, conn, td2c.DATASETS[spec], **kw)
        assert t == j and j[0]


def test_graph_helpers_match_reference(tmp_path):
    _, conn = make_items(str(tmp_path), 4)
    scan = "00800-TEEsavR23oF"
    jp, tp = jd2c.load_connectivity(conn, scan), td2c.load_connectivity(conn, scan)
    assert list(tp) == list(jp) and all(np.array_equal(tp[k], jp[k]) for k in jp)
    je = jd2c.graph_edges(conn, scan)
    assert td2c.graph_edges(conn, scan) == je and len(jp) == 11
    ids = list(je)
    for a in ids[:4]:
        for b in ids + ["nowhere"]:
            assert td2c.graph_geodesic(tp, je, a, b) == jd2c.graph_geodesic(jp, je, a, b)
    rng = np.random.default_rng(4)
    for h in rng.uniform(-7, 7, 8):
        for e in (0.0, float(rng.uniform(-0.5, 0.5))):
            assert td2c.heading_to_rotation(h, e) == jd2c.heading_to_rotation(h, e)


def test_discrete_to_ce_cli_matches_reference(tmp_path):
    """``main`` with a resume cursor: the same files, the same cursor."""
    items, conn = smoke.write_discrete_dataset(str(tmp_path), 13, viewpoints=12, items=30)
    for tag, mod in (("j", jd2c), ("t", td2c)):
        cursor = tmp_path / f"{tag}_cursor.json"
        cursor.write_text(json.dumps({"item_id": 5}))
        mod.main(["--input", items, "--connectivity", conn,
                  "--dataset", "navrag_val", "--out", str(tmp_path / f"{tag}.json.gz"),
                  "--out-gt", str(tmp_path / f"{tag}_gt.json.gz"), "--cursor", str(cursor)])
    for name in ("{}.json.gz", "{}_gt.json.gz", "{}_cursor.json"):
        assert _read(str(tmp_path / name.format("t"))) == _read(str(tmp_path / name.format("j")))
    back = tds.load_episodes(str(tmp_path / "t.json.gz"))
    assert back and [vars(e) for e in back] == [
        vars(e) for e in jds.load_episodes(str(tmp_path / "j.json.gz"))]


# ---------------------------------------------------------------------------
# utils/graph.py
# ---------------------------------------------------------------------------
def test_floyd_graph_matches_reference():
    rng = np.random.default_rng(8)
    jg, tg = jgraph.FloydGraph(), tgraph.FloydGraph()
    names = [f"n{i}" for i in range(9)]
    for step in range(20):
        a, b = rng.choice(names, 2, replace=False)
        d = float(rng.uniform(0.2, 3.0))
        jg.add_edge(a, b, d)
        tg.add_edge(a, b, d)
        if step % 3 == 2:
            k = str(rng.choice(names))
            jg.update(k)
            tg.update(k)
    for x in names:
        assert tg.visited(x) == jg.visited(x)
        for y in names:
            assert tg.distance(x, y) == jg.distance(x, y)
            assert tg.path(x, y) == jg.path(x, y)


def test_graph_map_matches_reference():
    rng = np.random.default_rng(9)
    start = rng.normal(size=3)
    tm, jm = tgraph.GraphMap(start), jgraph.GraphMap(start)
    for i in range(8):
        p = rng.normal(size=3) * 2
        front = str(int(rng.integers(0, i + 1)))
        assert tm.add_node(p, connect_to=front) == jm.add_node(p, connect_to=front)
        q = p + rng.normal(size=3)
        assert tm.add_ghost(q, str(i + 1)) == jm.add_ghost(q, str(i + 1))
    jm.delete_ghost("g3")
    tm.delete_ghost("g3")
    assert list(tm.ghost_pos) == list(jm.ghost_pos)
    for a in list(jm.node_pos)[:4]:
        for b in list(jm.node_pos) + list(jm.ghost_pos):
            assert tm.shortest_path(a, b) == jm.shortest_path(a, b)
    for _ in range(10):
        q = rng.normal(size=3) * 2
        for r in (0.5, 3.0):
            assert tm.localize(q, r) == jm.localize(q, r)
