"""The port's config overrides against the reference's: ``apply_opts``,
``from_dict`` and ``load`` (JSON and YAML) give the same
``dataclasses.asdict`` as the JAX package on the same inputs.

Covers bool, int, float, str and tuple fields given as strings, string
values inside a config file (read as the field's type, as the reference
reads them), ``mesh.*`` keys, and ``KeyError`` on an unknown key."""

import dataclasses
import json

import pytest

from dynam3d_tpu import config as jconfig
from dynam3d_torch import config as tconfig

OPTS = [
    "train.use_waypoint_predictor=false",     # bool
    "train.is_requeue=on",
    "train.iters=5",                           # int
    "fields.zone_x_length=1.5",                # float
    "fields.encoder_dtype=f32",                # str
    "segmenter.provider = depth_plane",        # spaces around '='
    "waypoint.nms_sigma=6.5,4",                # tuple of floats
    "llava.phi3.num_layers=3",                 # nested section
    "mesh.dp=2",                               # the mesh section
    "mesh.tp=4",
]

# a config file whose values are all strings, and mesh keys
FILE = {
    "train": {"use_waypoint_predictor": "false", "iters": "5", "lr": "2e-5",
              "ckpt_dir": "ck/a", "waypoint_aug": "0"},
    "waypoint": {"nms_sigma": "3,2", "max_candidates": "7"},
    "mesh": {"dp": "2", "tp": 1},
    "eval": {"success_distance": 2.5},
    "clip": {"compute_dtype": "f32"},
}


def _asdict(cfg):
    return dataclasses.asdict(cfg)


def test_defaults_are_the_same_tree():
    assert _asdict(tconfig.Dynam3DConfig()) == _asdict(jconfig.Dynam3DConfig())
    assert tconfig.MeshConfig(dp=2, tp=4).num_devices == 8


@pytest.mark.parametrize("opt", OPTS)
def test_apply_opts_matches_the_reference(opt):
    t = tconfig.apply_opts(tconfig.Dynam3DConfig(), [opt])
    j = jconfig.apply_opts(jconfig.Dynam3DConfig(), [opt])
    assert _asdict(t) == _asdict(j)
    assert _asdict(t) != _asdict(tconfig.Dynam3DConfig())


def test_apply_opts_types():
    c = tconfig.apply_opts(tconfig.Dynam3DConfig(), OPTS)
    assert c.train.use_waypoint_predictor is False and c.train.is_requeue is True
    assert c.train.iters == 5 and c.fields.zone_x_length == 1.5
    assert c.waypoint.nms_sigma == (6.5, 4.0) and c.segmenter.provider == "depth_plane"
    assert (c.mesh.dp, c.mesh.tp, c.mesh.num_devices) == (2, 4, 8)
    assert _asdict(c) == _asdict(jconfig.apply_opts(jconfig.Dynam3DConfig(), OPTS))


def test_from_dict_reads_strings_as_the_field_type():
    """The repair: string values are coerced against the field's current
    value, so ``"false"`` is False (it was stored as a truthy string), and
    a ``mesh`` section loads (it raised KeyError)."""
    t = tconfig.from_dict(FILE)
    assert t.train.use_waypoint_predictor is False and t.train.waypoint_aug is False
    assert t.train.iters == 5 and t.train.lr == 2e-5 and t.waypoint.nms_sigma == (3.0, 2.0)
    assert (t.mesh.dp, t.mesh.tp) == (2, 1)
    assert _asdict(t) == _asdict(jconfig.from_dict(FILE))


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_load_matches_the_reference(fmt, tmp_path):
    import yaml

    path = tmp_path / f"cfg.{fmt}"
    path.write_text(json.dumps(FILE) if fmt == "json" else yaml.safe_dump(FILE))
    opts = ["train.iters=9", "mesh.tp=2"]
    t = tconfig.load(str(path), opts)
    j = jconfig.load(str(path), opts)
    assert _asdict(t) == _asdict(j)
    assert t.train.iters == 9 and t.mesh.tp == 2 and t.train.use_waypoint_predictor is False
    empty = tmp_path / f"empty.{fmt}"
    empty.write_text("{}" if fmt == "json" else "")
    assert _asdict(tconfig.load(str(empty))) == _asdict(jconfig.load(str(empty)))


def test_load_round_trips_a_whole_tree(tmp_path):
    """``asdict`` of a changed config written as JSON loads back to the
    same tree in both packages (JSON lists land as lists in both)."""
    base = tconfig.apply_opts(tconfig.Dynam3DConfig(), OPTS)
    d = _asdict(base)
    path = tmp_path / "tree.json"
    path.write_text(json.dumps(d))
    assert _asdict(tconfig.load(str(path))) == _asdict(jconfig.load(str(path))) == json.loads(
        json.dumps(d))


@pytest.mark.parametrize("opt", ["train.no_such_key=1", "mesh.pp=2", "nosection.x=1"])
def test_unknown_key_raises(opt):
    with pytest.raises(KeyError, match="unknown config key"):
        tconfig.apply_opts(tconfig.Dynam3DConfig(), [opt])
    with pytest.raises((KeyError, AttributeError)):
        jconfig.apply_opts(jconfig.Dynam3DConfig(), [opt])
    with pytest.raises(KeyError, match="unknown config key"):
        tconfig.from_dict({"train": {"no_such_key": 1}})
