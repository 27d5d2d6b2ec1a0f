"""Port parity of DAgger collection and the episode store
(``runtime/dagger.py``, ``native/__init__.py``'s store): the port's
``write_episode_store`` writes the reference writer's bytes, each package
reads the other's files (the reference's reader is the native build, as in
``tests/test_dagger.py``), and ``collect_trajectories`` on the same feeds
writes identical stores, replayed identically by ``iterate_store``."""

import numpy as np
import pytest

from dynam3d_tpu import native as jnative
from dynam3d_tpu.config import Dynam3DConfig
from dynam3d_tpu.runtime import dagger as jdagger
from dynam3d_tpu.runtime import feed as jfeed
from dynam3d_torch.runtime import dagger as tdagger
from dynam3d_torch.runtime import episode_store as tstore
from dynam3d_torch.runtime import feed as tfeed
from tests.torch_parity import port_config


def _native():
    try:
        jnative._load()
    except Exception as e:  # pragma: no cover
        pytest.skip(f"native unavailable: {e}")


def _steps(seed: int, n: int, size: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size).astype(np.uint8).tobytes() for _ in range(n)]


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("n,size", [(7, 1000), (1, 4099), (0, 0)])
def test_store_writer_writes_the_reference_bytes(tmp_path, n, size):
    steps, meta = _steps(n, n, size), {"views": 1, "note": "ü", "n": [n, size]}
    jnative.write_episode_store(str(tmp_path / "j.bin"), steps, meta)
    tstore.write_episode_store(str(tmp_path / "t.bin"), steps, meta)
    assert _bytes(tmp_path / "t.bin") == _bytes(tmp_path / "j.bin")
    store = tstore.EpisodeStore(str(tmp_path / "j.bin"))
    assert (store.n_steps, store.step_bytes, store.meta) == (n, size, meta)
    assert [store.read(t) for t in range(n)] == steps
    store.close()


def test_stores_cross_between_the_packages(tmp_path):
    """The reference's native reader reads the port's file and the port's
    reader the reference's, step for step."""
    _native()
    steps, meta = _steps(3, 9, 3 * 4096 + 17), {"instruction": "go to the hall", "views": 2}
    tstore.write_episode_store(str(tmp_path / "t.bin"), steps, meta)
    jnative.write_episode_store(str(tmp_path / "j.bin"), steps, meta)
    for path in ("t.bin", "j.bin"):
        js = jnative.EpisodeStore(str(tmp_path / path), prefetch_ahead=2)
        ts = tstore.EpisodeStore(str(tmp_path / path), prefetch_ahead=2)
        assert (ts.n_steps, ts.step_bytes, ts.meta) == (js.n_steps, js.step_bytes, js.meta)
        for t in (0, 8, 3, 4):
            assert ts.read(t) == js.read(t) == steps[t]
        js.close()
        ts.close()


def test_store_refuses_another_file(tmp_path):
    (tmp_path / "x.bin").write_bytes(np.asarray([7, 0, 0, 2], "<i8").tobytes() + b"{}")
    with pytest.raises(IOError, match="episode store"):
        tstore.EpisodeStore(str(tmp_path / "x.bin"))
    with pytest.raises(ValueError):
        tstore.write_episode_store(str(tmp_path / "y.bin"), [b"ab", b"abc"], {})


@pytest.mark.parametrize("kind", ["room", "floorplan", "candidates"])
def test_collect_trajectories_matches_reference(tmp_path, kind):
    """Two teacher episodes from the same feeds (a room, a floorplan, or
    the room with a caller's candidate function): the same step count, the
    same store file, and ``iterate_store`` replays the same steps."""
    jcfg = Dynam3DConfig()
    tcfg = port_config(jcfg)

    def factory(m):
        seeds = iter([5, 6])
        if kind == "floorplan":
            return lambda: m.FloorplanFeed(rgb_size=24, depth_size=12, views=2)
        return lambda: m.SyntheticRoomFeed(rgb_size=24, depth_size=12, views=2,
                                           seed=next(seeds))

    cand = None
    if kind == "candidates":
        def cand(feed, obs):
            k = len(feed.positions)
            return [0.3 * k, 1.0, 5.0], [0.5, 0.75 + 0.1 * k, 1.0]

    jn = jdagger.collect_trajectories(jcfg, factory(jfeed), str(tmp_path / "j.bin"),
                                      episodes=2, max_steps=6, candidate_fn=cand)
    tn = tdagger.collect_trajectories(tcfg, factory(tfeed), str(tmp_path / "t.bin"),
                                      episodes=2, max_steps=6, candidate_fn=cand)
    assert tn == jn >= 2
    assert _bytes(tmp_path / "t.bin") == _bytes(tmp_path / "j.bin")
    seen = list(tdagger.iterate_store(str(tmp_path / "t.bin")))
    assert len(seen) == tn
    for (rgb, depth, pos, heading, gt), meta in seen:
        assert rgb.shape == (2, 24, 24, 3) and depth.shape == (2, 12, 12)
        assert gt.endswith("<|end|>") and meta["instruction"]
    _native()
    ref = list(jdagger.iterate_store(str(tmp_path / "t.bin")))
    assert len(ref) == tn
    for (t_step, t_meta), (j_step, j_meta) in zip(seen, ref):
        assert t_meta == j_meta
        for a, b in zip(t_step, j_step):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pack_and_unpack_match_reference():
    rng = np.random.default_rng(2)
    obs = tfeed.Observation(
        rgb=rng.integers(0, 256, (3, 8, 8, 3)).astype(np.uint8),
        depth=rng.uniform(0, 1, (3, 4, 4)).astype(np.float32),
        position=rng.normal(size=3).astype(np.float32), heading=1.25,
        instruction="x")
    meta = {"views": 3, "rgb_size": 8, "depth_size": 4}
    for gt in ("turn left 2 steps, move 3 steps.<|end|>", "ü" * 40, ""):
        blob = tdagger._pack_step(obs, gt)
        assert blob == jdagger._pack_step(obs, gt)
        t, j = tdagger.unpack_step(blob, meta), jdagger.unpack_step(blob, meta)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
