"""Port parity of the posed-frame scene datasets (``runtime/scene_datasets.py``)
and of what they feed: the four layouts written by ``chip_smoke``'s corpus
writers at small sizes (ARKit at its own 256x192, 3RScan with its split
color and depth sizes), the camera and pose parsers, the image readers,
the SceneVerse blobs and ``build_language_supervision``, all exact (host
numpy, float64 where the reference parses in float64); then samples of
each layout through ``PretrainRunner.build_batch`` (ints exact, values
1e-5) against the JAX runner on the reference loop test's tiny config, and
``frustum_mask_intrinsics`` exactly.  ``run`` over these corpora is in
``test_torch_scene_run.py``."""

import json
import os
import random

import jax
import numpy as np
import pytest
import torch

import chip_smoke as smoke
from dynam3d_tpu.geom import projection as jproj
from dynam3d_tpu.models.encoders.clip import init_clip_params
from dynam3d_tpu.models.memory3d import init_field_params
from dynam3d_tpu.models.render.nerf import init_render_params
from dynam3d_tpu.runtime import pretrain_loop as jloop
from dynam3d_tpu.runtime import scene_datasets as jsd
from dynam3d_torch.geom import projection as tproj
from dynam3d_torch.runtime import pretrain_loop as tloop
from dynam3d_torch.runtime import scene_datasets as tsd
from tests.test_torch_pretrain_loop import CFG
from tests.torch_parity import np32, port_config, to_torch

SIZES = {"scannet": {"size": (24, 32)}, "rscan": {"color": (54, 96), "depth": (43, 56)},
         "arkit": {"size": (192, 256)}, "structured3d": {"size": (36, 64)}}
CLASSES = {"scannet": "ScanNetScenes", "rscan": "RScanScenes", "arkit": "ARKitScenes",
           "structured3d": "Structured3DScenes"}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """2 scenes of 6 frames per layout (ScanNet frame 3 tracking-lost,
    ARKit frame 5 without a traj row), 600-point SceneVerse clouds."""
    root = str(tmp_path_factory.mktemp("corpora"))
    return smoke.write_corpora(root, frames=6, seed=3, sizes=SIZES, n_points=600)


def _datasets(mod, corpora, name, frames, seed, annotations=True):
    c = corpora[name]
    kw = {}
    if name == "scannet":
        kw["align_matrix_json"] = c["align"]
    if name != "structured3d":
        kw["sceneverse_root"] = c["sceneverse"]
        if annotations:
            kw["annotations"] = mod.SceneVerseAnnotations(
                os.path.join(c["sceneverse"], f"3dff_{name}_annotations.json"))
    return getattr(mod, CLASSES[name])(c["root"], frames=frames, seed=seed, **kw)


def _same(a, b, key=""):
    if isinstance(b, (str, bool)) or b is None:
        assert a == b, key
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=key)


def _same_scene(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        _same(t[k], j[k], k)


# ---------------------------------------------------------------------------
# the four layouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("frames", [4, 9])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_sample_scene_matches_reference(corpora, name, frames):
    """Three draws from each layout, fewer frames than a scene holds and
    more (filled by repetition): every array exact, the same scenes, the
    tracking-lost ScanNet frame and the ARKit frame without a traj row
    skipped in both."""
    jd = _datasets(jsd, corpora, name, frames, seed=5)
    td = _datasets(tsd, corpora, name, frames, seed=5)
    assert td.scene_ids == jd.scene_ids == corpora[name]["scenes"]
    for _ in range(3):
        j, t = jd.sample_scene(), td.sample_scene()
        _same_scene(t, j)
        assert np.isfinite(t["world2cam"]).all() and t["rgb"].shape[0] == frames
    if name == "arkit":
        assert t["rgb"].shape[1:3] == (192, 256) and t["depth"].shape[1:] == (192, 256)
    if name == "rscan":
        assert t["rgb"].shape[1:3] == (54, 96) and t["depth"].shape[1:] == (43, 56)
    assert t["use_labels"] == (name != "structured3d")


def test_frame_skips_match_reference(corpora):
    """The layouts' own quirks: a ScanNet pose of -inf and an ARKit frame
    without a traj row are never drawn; ARKit pairs a frame with the pincam
    1 ms off."""
    for name in ("scannet", "arkit"):
        jd = _datasets(jsd, corpora, name, 12, seed=1, annotations=False)
        td = _datasets(tsd, corpora, name, 12, seed=1, annotations=False)
        for scene in corpora[name]["scenes"]:
            fids = td._frame_ids(scene)
            assert fids == jd._frame_ids(scene)
            for fid in fids:
                try:
                    t = td._load_frame(scene, fid)
                except KeyError:
                    with pytest.raises(KeyError):
                        jd._load_frame(scene, fid)
                    assert name == "arkit"
                    continue
                j = jd._load_frame(scene, fid)
                for a, b in zip(t, j):
                    _same(a, b, fid)
        t = td.sample_scene()
        assert np.isfinite(t["trans"]).all()
    arkit = tsd.ARKitScenes(corpora["arkit"]["root"], frames=5, seed=0)
    scene = corpora["arkit"]["scenes"][0]
    ids = arkit._frame_ids(scene)
    assert sorted(ids, key=arkit._name_ts) != ids                 # name order != time order
    idx = arkit._scene_index(scene)
    assert len(idx["rows"]) == 5 and len(idx["pincams"]) == 6


# ---------------------------------------------------------------------------
# cameras, poses and images
# ---------------------------------------------------------------------------
def _write_mat(path, m):
    with open(path, "w") as f:
        for row in m:
            f.write(" ".join(repr(float(x)) for x in row) + "\n")


def test_camera_parsers_match_reference(tmp_path):
    rng = np.random.default_rng(17)
    for i in range(4):
        m = rng.normal(size=(4, 4)) * 100
        _write_mat(tmp_path / f"m{i}.txt", m)
        p = str(tmp_path / f"m{i}.txt")
        _same(tsd.load_matrix_txt(p), jsd.load_matrix_txt(p))
        _same(tsd.load_matrix_txt(p, 3), jsd.load_matrix_txt(p, 3))
        _same(tsd.scannet_depth_intrinsics(p), jsd.scannet_depth_intrinsics(p))
        lines = ["h"] * 9 + ["m_calibrationDepthIntrinsic = "
                             + " ".join(repr(float(x)) for x in m.reshape(-1))]
        (tmp_path / "_info.txt").write_text("\n".join(lines) + "\n")
        p = str(tmp_path / "_info.txt")
        _same(tsd.rscan_intrinsics_from_info(p), jsd.rscan_intrinsics_from_info(p))
        vals = [256, 192, *rng.uniform(100, 300, 2), *rng.uniform(90, 130, 2)]
        (tmp_path / "f.pincam").write_text(" ".join(repr(float(x)) for x in vals))
        p = str(tmp_path / "f.pincam")
        _same(tsd.pincam_intrinsics(p), jsd.pincam_intrinsics(p))
    for v in [np.zeros(3), np.full(3, 1e-13), *rng.normal(size=(6, 3)) * 2]:
        _same(tsd.axis_angle_to_matrix(v), jsd.axis_angle_to_matrix(v))
        row = " ".join(repr(float(x)) for x in (1234.567, *v, *rng.normal(size=3)))
        _same(tsd.traj_line_to_extrinsic(row), jsd.traj_line_to_extrinsic(row))
    for _ in range(5):
        info = np.concatenate([rng.normal(size=3) * 3000, rng.normal(size=6),
                               rng.uniform(0.5, 0.9, 2)])
        for a, b in zip(tsd.parse_structured3d_camera(info, 720, 1280),
                        jsd.parse_structured3d_camera(info, 720, 1280)):
            _same(a, b)
        rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        trans = rng.normal(size=3)
        tp, th = tsd.pose_from_extrinsic(rot, trans)
        jp, jh = jsd.pose_from_extrinsic(rot, trans)
        _same(tp, jp)
        assert th == jh
        _same(tsd.world_to_habitat(trans), jsd.world_to_habitat(trans))
        batch = rng.normal(size=(4, 2, 3))
        _same(tsd.world_to_habitat(batch), jsd.world_to_habitat(batch))
    for dx, dy in [(0.0, 0.0), (1e-6, -1e-6), (-2.0, -0.5), (3.0, 1.0), (0.0, -1.0)]:
        assert tsd._heading_from_displacement(dx, dy) == jsd._heading_from_displacement(dx, dy)


def test_image_readers_match_reference(tmp_path, corpora):
    """PIL reads the images in both packages: JPEG and PNG color, 16-bit
    PNG and PGM depth with its zero pixels, every far plane."""
    from PIL import Image

    rng = np.random.default_rng(2)
    gray = rng.integers(0, 255, (7, 9)).astype(np.uint8)
    Image.fromarray(gray).save(tmp_path / "g.png")
    paths = [str(tmp_path / "g.png")]
    for name in ("scannet", "rscan", "arkit", "structured3d"):
        for d, _, files in os.walk(corpora[name]["root"]):
            paths += [os.path.join(d, f) for f in sorted(files)[:2]
                      if f.endswith((".jpg", ".png"))]
    for p in paths:
        _same(tsd._load_image(p), jsd._load_image(p), p)
    depths = [os.path.join(d, f) for d, _, files in os.walk(corpora["rscan"]["root"])
              for f in files if f.endswith(".pgm")][:2]
    depths += [os.path.join(d, f) for d, _, files in os.walk(corpora["scannet"]["root"])
               for f in files if d.endswith("depth")][:2]
    for p in depths:
        assert (np.asarray(Image.open(p)) == 0).any()
        for far in (10.0, 3.5):
            _same(tsd._load_depth_mm(p, far), jsd._load_depth_mm(p, far), p)


# ---------------------------------------------------------------------------
# SceneVerse supervision
# ---------------------------------------------------------------------------
def test_sceneverse_blobs_match_reference(tmp_path, corpora):
    rng = np.random.default_rng(6)
    cats = {c: i for i, c in enumerate(smoke.SCENE_CATEGORIES)}
    emb = torch.from_numpy(rng.normal(size=(len(cats), 8)).astype(np.float32))
    emb[3] = 0.0                                                  # a zero row: eps clamp
    torch.save([cats, emb], tmp_path / "cat.pth")
    td, te = tsd.load_category_embeddings(str(tmp_path / "cat.pth"))
    jd, je = jsd.load_category_embeddings(str(tmp_path / "cat.pth"))
    assert td == jd
    _same(te, je)
    sc = corpora["scannet"]
    align = json.load(open(sc["align"]))
    for name, li in (("scannet", 3), ("rscan", -1), ("arkit", -1)):
        c = corpora[name]
        pcd = [os.path.join(c["sceneverse"], "pcd_with_global_alignment", f"{s}.pth")
               for s in c["scenes"]]
        for a in (None, np.asarray(align[sc["scenes"][0]])):
            for x, y in zip(tsd.load_sceneverse_pcd(pcd, li, a), jsd.load_sceneverse_pcd(pcd, li, a)):
                _same(x, y)
        lab = [os.path.join(c["sceneverse"], "instance_id_to_label", f"{s}.pth")
               for s in c["scenes"]]
        assert tsd.load_instance_labels(lab) == jsd.load_instance_labels(lab)
        path = os.path.join(c["sceneverse"], f"3dff_{name}_annotations.json")
        ta, ja = tsd.SceneVerseAnnotations(path), jsd.SceneVerseAnnotations(path)
        assert ta.scenes() == ja.scenes() and ("x" in ta) == ("x" in ja)
        tr, jr = random.Random(4), random.Random(4)
        for scene in c["scenes"] + ["missing"]:
            assert (scene in ta) == (scene in ja)
            for inst in range(0, 40):
                assert ta.sample_caption(scene, inst, tr) == ja.sample_caption(scene, inst, jr)


def test_hm3d_semantic_index_matches_reference(tmp_path):
    rng = np.random.default_rng(8)
    hm3d, mp3d = tmp_path / "hm3d", tmp_path / "mp3d"
    for i, d in enumerate(["00001-abcdefghijk", "00002-bcdefghijkl", "00003-cdefghijklm"]):
        os.makedirs(hm3d / d)
        if i != 1:                                                # an unannotated scene
            torch.save((rng.normal(size=(5 + i, 3)).astype(np.float32), {4: "chair", i: "rug"},
                        None, rng.integers(0, 9, 5 + i)), hm3d / d / f"{d[6:17]}.semantic.pth")
    os.makedirs(mp3d / "sceneX")
    torch.save((rng.normal(size=(3, 3)), {1: "sofa"}, rng.integers(0, 9, 3)),
               mp3d / "sceneX" / "sceneX_semantic.pth")
    ti, ji = tsd.HM3DSemanticIndex(str(hm3d), str(mp3d)), jsd.HM3DSemanticIndex(str(hm3d), str(mp3d))
    assert ti.paths == ji.paths
    for scene in ("abcdefghijk", "bcdefghijkl", "cdefghijklm", "sceneX"):
        assert (scene in ti) == (scene in ji)
        if scene in ji:
            t, j = ti.load(scene), ji.load(scene)
            _same(t[0], j[0])
            _same(t[1], j[1])
            assert t[2] == j[2]
    for p in ("data/hm3d/00001-abcdefghijk/abcdefghijk.basis.glb", "mp3d/sceneX/sceneX.glb",
              "a/b.c/scene.navmesh", "plain"):
        assert tsd.HM3DSemanticIndex.normalize_scene_id(p) == \
            jsd.HM3DSemanticIndex.normalize_scene_id(p)


def _encode_text(texts):
    """A deterministic text encoder: each caption's bytes through a fixed
    random projection."""
    out = np.zeros((len(texts), CFG.fields.fts_dim), np.float32)
    proj = np.random.default_rng(0).normal(size=(256, CFG.fields.fts_dim)).astype(np.float32)
    for i, t in enumerate(texts):
        out[i] = proj[np.frombuffer(t.encode(), np.uint8)].mean(0)
    return out


def _supervision(mod, corpora, name, scene, seed):
    c = corpora[name]
    cats = {c_.replace("_", " ").replace("|", " ").replace("/", " "): i
            for i, c_ in enumerate(smoke.SCENE_CATEGORIES)}
    emb = np.random.default_rng(1).normal(size=(len(cats), CFG.fields.fts_dim)).astype(np.float32)
    ann = labels = None
    if name != "structured3d":
        ann = mod.SceneVerseAnnotations(
            os.path.join(c["sceneverse"], f"3dff_{name}_annotations.json"))
        labels = mod.load_instance_labels(
            [os.path.join(c["sceneverse"], "instance_id_to_label", f"{scene['scene_id']}.pth")])
    return emb, mod.build_language_supervision(scene, ann, cats, emb, _encode_text, labels,
                                               max_gt_label=64, rng=random.Random(seed))


@pytest.mark.parametrize("name", ["scannet", "arkit", "structured3d"])
def test_language_supervision_matches_reference(corpora, name):
    """Captioned instances through ``encode_text``, the label fallback to
    category rows (with the ``_ | /`` cleanup), the rest invalid: the same
    three arrays, and the same draws without annotations."""
    scene = _datasets(jsd, corpora, name, 4, seed=2).sample_scene()
    _, t = _supervision(tsd, corpora, name, scene, 9)
    _, j = _supervision(jsd, corpora, name, scene, 9)
    for a, b in zip(t, j):
        _same(a, b)
    if name != "structured3d":
        assert t[2].sum() > 0 and (t[0] >= 0).sum() > 0
    emb = np.eye(3, 8, dtype=np.float32)
    for a, b in zip(tsd.build_language_supervision(scene, None, {"wall": 1}, emb, _encode_text,
                                                   {3: "wall", 7: "x"}, max_gt_label=16),
                    jsd.build_language_supervision(scene, None, {"wall": 1}, emb, _encode_text,
                                                   {3: "wall", 7: "x"}, max_gt_label=16)):
        _same(a, b)


# ---------------------------------------------------------------------------
# into the pretraining loop
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def params():
    key = jax.random.PRNGKey(1)
    return {"fields": init_field_params(key, CFG.fields),
            "render": init_render_params(jax.random.fold_in(key, 1), CFG.fields),
            "clip": init_clip_params(jax.random.fold_in(key, 2), CFG.clip)}


@pytest.mark.parametrize("name", ["scannet", "rscan", "arkit", "structured3d"])
def test_build_batch_matches_reference(corpora, params, name):
    """A sample of each layout with its language supervision through
    ``build_batch``: every batch field as the reference builds it (ints
    exact, values 1e-5; ``pdir`` as the reference's function of ``ppos``).
    Structured3D has no gt cloud: the port's batch
    carries one dead point of label 0 where the reference's carries none."""
    scene = _datasets(jsd, corpora, name, 3, seed=4).sample_scene()
    emb, (g2c, fts, _) = _supervision(jsd, corpora, name, scene, 3)
    sup = dict(cat_embeddings=emb, gtid_to_cat=g2c, gtid_text_fts=fts, max_gt_label=64)
    jb = jloop.PretrainRunner(dict(params), CFG).build_batch(scene, params["clip"], **sup)
    trun = tloop.PretrainRunner(to_torch({"clip": params["clip"]}), port_config(CFG),
                                device="cpu")
    tb = trun.build_batch(scene, trun.params["clip"], **sup)
    for field in jb._fields:
        a, b = getattr(tb, field), np.asarray(getattr(jb, field))
        if field == "pdir":
            # the heading of a world point near the x axis (a wall at y = 0)
            # is -asin(x / |xy|) at an argument within an ulp of 1, where a
            # last-bit difference of ppos moves it by up to ~5e-4: hold pdir
            # as the reference's function of the port's ppos
            b = np.asarray(jproj.heading_from_positions(tb.ppos.numpy()))
        if name == "structured3d" and field.startswith("gt_"):
            assert b.shape[0] == 0 and a.shape[0] == 1 and not bool(a.any()), field
        elif b.dtype.kind in "biu":
            np.testing.assert_array_equal(a.numpy(), b, err_msg=field)
        else:
            np.testing.assert_allclose(np32(a), np32(b), rtol=1e-5, atol=1e-5, err_msg=field)


def test_frustum_mask_intrinsics_matches_reference(corpora):
    """World points around a ScanNet sample's cameras through each frame's
    K and world-to-camera matrix, against its depth: the same mask."""
    s = _datasets(jsd, corpora, "scannet", 3, seed=3).sample_scene()
    rng = np.random.default_rng(0)
    pts = (rng.uniform(0, 1, (4000, 3)) * smoke.ROOM).astype(np.float32)
    pts[:50] = np.nan
    for v in range(3):
        depth = (s["depth"][v] * 10.0).astype(np.float32)
        for kw in ({}, {"near": 0.5, "far": 6.0, "depth_slack": 0.3}):
            j = np.asarray(jproj.frustum_mask_intrinsics(pts, depth, s["intrinsics"][v],
                                                         s["world2cam"][v], **kw))
            t = tproj.frustum_mask_intrinsics(torch.from_numpy(pts), torch.from_numpy(depth),
                                              torch.from_numpy(s["intrinsics"][v]),
                                              torch.from_numpy(s["world2cam"][v]), **kw)
            assert t.dtype == torch.bool and 0 < int(t.sum()) < len(pts)
            np.testing.assert_array_equal(t.numpy(), j)
