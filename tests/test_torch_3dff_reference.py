"""The port's 3DFF frames step against the benchmark's plain float32
reference (``perfbench/reference/fields_ref.py``) on the CPU.

A small ``FieldsConfig`` (bf16 aggregation encoders, as the cell runs
them) on seeded random weights (``perfbench/weights_fields.py``): two
``PretrainRunner.run`` iterations over a ``SyntheticFramesDataset``, the
second held against one reference step that starts from the program's
tree and optimizer state before it and takes its discrete choices where
they tie (``follow``).  Tolerances, each with its reason:

* CLIP features and the folded table's rows: 2% -- both sides round the
  CLIP tower and the encoders to bf16, in a different order of operations
  (a bf16 step is 0.4%, and a few compound through two encoder layers).
* Loss terms: 1% relative -- the same roundings, summed over rows.
* Gradients: 2% on the memory's leaves (smooth GELU encoders: the bf16
  noise averages out over the rows), 25% on the renderer's: on the CPU the
  program's NeRF MLP is the reference package's chain (float32 weights,
  LeakyReLU after the bf16 rounding), the reference's is kernel C's
  arithmetic, and a pre-activation within rounding of zero takes slope 1
  on one side and 0.01 on the other; the gap grows as the square root of
  the flipped share, a larger share at 64 wide than at 768
  (``test_nerf_mlp_flips_explain_the_gap``).
* The AdamW update from the program's clipped gradient: 1e-4 relative --
  float32 arithmetic on equal inputs, up to the parameters' own rounding.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dynam3d_torch.config import from_dict
from dynam3d_torch.models.render import nerf as tnerf
from dynam3d_torch.runtime import pretrain_loop as tloop
from dynam3d_torch.runtime import trainer_3dff
from dynam3d_torch.utils.tree import tree_leaves
from perfbench import check_3dff, faults_3dff, weights_fields
from perfbench.reference import fields_ref as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11


def _config():
    conf = json.load(open(os.path.join(ROOT, "perfbench", "tests", "tiny-fields.json")))
    return conf, from_dict(conf["model"]), ref.config(conf["model"])


def _limits():
    cell = os.path.join(ROOT, "perfbench", "tests", "tiny-3dff-pretrain-frames.json")
    return json.load(open(cell))["check"]["limits"]


@pytest.fixture(scope="module")
def step():
    """Two iterations of the port; the second's intermediate values and
    the reference's step from the same start."""
    conf, cfg, rcfg = _config()
    dev = torch.device("cpu")
    runner = tloop.PretrainRunner(weights_fields.fields_params(SEED, rcfg, dev), cfg, seed=SEED,
                                  device="cpu")
    ds = tloop.SyntheticFramesDataset(rgb_size=cfg.clip.image_size, depth_size=32, frames=4,
                                      seed=SEED)
    runner.run([ds], 1)
    got = {"renders": [], "neighbours": []}
    losses0, render0, knn0, focal0 = (trainer_3dff.losses_after_update,
                                      trainer_3dff.render_view, tnerf.knn_brute,
                                      trainer_3dff.focal_loss)

    def losses(params, c, state, aux, batch, posed=False):
        got.update(state=state, aux=aux, batch=batch)
        return losses0(params, c, state, aux, batch, posed=posed)

    def render(*a, **k):
        got["renders"].append(render0(*a, **k))
        return got["renders"][-1]

    def knn(q, p, v, k):
        out = knn0(q, p, v, k)
        got["neighbours"].append((q.detach(), out[1]))
        return out

    def focal(logits, targets, mask):
        got["focal"] = (logits.detach(), targets, mask)
        return focal0(logits, targets, mask)

    scene = {}
    sample0 = ds.sample_scene

    def sample():
        scene.update(copy.deepcopy(sample0()))
        return copy.deepcopy(scene)

    ds.sample_scene = sample
    before = {"fields": runner.params["fields"], "render": runner.params["render"]}
    opt0, it = runner._tr_opt, runner.it
    trainer_3dff.losses_after_update, trainer_3dff.render_view = losses, render
    tnerf.knn_brute, trainer_3dff.focal_loss = knn, focal
    try:
        metrics = runner.run([ds], 1)[0]
    finally:
        trainer_3dff.losses_after_update, trainer_3dff.render_view = losses0, render0
        tnerf.knn_brute, trainer_3dff.focal_loss = knn0, focal0
    after = {"fields": runner.params["fields"], "render": runner.params["render"]}
    names = [n for n, _ in ref.leaves(before)]
    s = dict(got, scene=scene, metrics=metrics, it=it, sup_seed=SEED, tree_before=before,
             params_before=tree_leaves(before), params_after=tree_leaves(after), opt_before=opt0,
             opt_after=runner._tr_opt)
    hp = ref.hyper(rcfg, conf["optimizer"])
    prog = check_3dff.program_outputs(s, names, hp["b1"])
    clip = weights_fields.fields_params(SEED, rcfg, dev)["clip"]
    params = {"clip": clip, **before}
    sup = check_3dff.supervision(SEED, it, 16, 512, rcfg.fields.fts_dim)
    follow = {k: prog[k] for k in check_3dff.FOLLOWED}
    out = ref.step(params, rcfg, scene, sup, hp, opt0, follow=follow)
    return {"conf": conf, "rcfg": rcfg, "prog": prog, "out": out, "hp": hp, "params": params,
            "sup": sup, "scene": scene, "opt0": opt0, "s": s}


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_batch_and_discrete_choices(step):
    prog, out = step["prog"], step["out"]
    assert _rel(prog["grid"], out["batch"]["grid"]) < 0.02
    assert _rel(prog["cls"], out["batch"]["cls"]) < 0.02
    for k in ("segm_off", "merges_off", "samples_off", "neighbours_off", "hardest_off"):
        assert out[k] == 0, k
    assert out["segments"] > 0


def test_folded_table(step):
    prog, out = step["prog"], step["out"]
    for f, v in (("patch_fts", "patch_valid"), ("inst_fts", "inst_valid"),
                 ("zone_fts", "zone_valid")):
        assert torch.equal(prog["table"][v], out["table"][v]), v
        live = out["table"][v]
        assert live.any(), v
        assert _rel(prog["table"][f][live], out["table"][f][live]) < 0.02, f
    for k in ("patch_pos", "inst_pos", "zone_key"):
        assert float((prog["table"][k] - out["table"][k]).abs().max()) < 1e-4, k


@pytest.mark.parametrize("term", check_3dff.TERMS)
def test_loss_terms(step, term):
    p, r = step["prog"]["losses"][term], step["out"]["losses"][term]
    assert np.isfinite(p) and abs(p - r) <= 1e-2 * max(abs(r), 1e-3), (p, r)


def test_every_leaf_gradient(step):
    prog, out = step["prog"], step["out"]
    assert out["raw_grad_max"] > 0
    for n, a, c in zip(out["names"], prog["grads"], out["grads"]):
        tol = 0.25 if n.startswith("render/") else 0.02
        assert _rel(a, c) < tol, (n, _rel(a, c))


def test_adamw_update(step):
    prog, hp = step["prog"], step["hp"]
    assert check_3dff._update_gap(prog, hp) < 1e-4
    # and the reference's own update from its own gradient moves every leaf
    out = step["out"]
    for p0, p1 in zip(prog["params_before"], out["params"]):
        assert not torch.equal(p0, p1)


def test_gradient_by_view_is_the_whole_gradient(step):
    out = ref.step(step["params"], step["rcfg"], step["scene"], step["sup"], step["hp"], None,
                   follow={k: step["prog"][k] for k in check_3dff.FOLLOWED},
                   grad_by_view=False)
    for a, b in zip(out["grads"], step["out"]["grads"]):
        assert _rel(b, a) < 1e-5


def test_nerf_mlp_flips_explain_the_gap():
    """A float32 and a bf16 NeRF MLP on the same inputs differ by a
    fraction of a percent forward and by several percent in the weight
    gradients; without the LeakyReLU they agree to rounding."""
    torch.manual_seed(0)
    D = 64
    x = torch.randn(1152, D)
    p = {"enc_hidden": [torch.randn(D, D) * D ** -0.5 for _ in range(2)],
         "enc_out": torch.randn(D, D + 1) * D ** -0.5,
         "dec_hidden": [torch.randn(D, D) * D ** -0.5 for _ in range(2)],
         "dec_out": torch.randn(D, D) * D ** -0.5}
    z = torch.randn(1152, D)

    def grads(prec):
        lv = [t.clone().requires_grad_(True) for _, t in ref.leaves(p)]
        out, _ = ref.nerf_mlp(ref.rebuild(p, lv), x, prec)
        return out, torch.autograd.grad((out * z).sum(), lv)

    o16, g16 = grads("bf16")
    o32, g32 = grads("f32")
    assert _rel(o16, o32) < 0.01
    assert max(_rel(a, b) for a, b in zip(g16, g32)) > 0.02


def test_the_kernel_path_differentiates_its_own_forward():
    """The renderer's NeRF MLP on the card (``_KernelNerfMLP``: kernel C
    forward, here its plain version) has as its gradient the autograd of
    the arithmetic that ran, not that of the reference package's chain
    (float32 weights, LeakyReLU after the bf16 rounding, an unrounded
    residual): a choice at the level of rounding, as the two gradients lie
    about as far from the float32 one.  ``chip_smoke.py``'s ``nerf_grad``
    phase holds the card's gradient against float32."""
    torch.manual_seed(1)
    D, n = 128, 512
    x = torch.randn(n, D)
    w = [torch.randn(D, D + 1 if i == 2 else D) * D ** -0.5 for i in range(6)]
    z, zd = torch.randn(n, D), torch.randn(n)

    def grads(fn):
        lv = [t.clone().requires_grad_(True) for t in [x, *w]]
        out, dens = fn(*lv)
        return torch.autograd.grad((out.float() * z).sum() + (dens.float() * zd).sum(), lv)

    from dynam3d_torch.ops.nerf_mlp import nerf_mlp_plain

    for a, b in zip(grads(tnerf._KernelNerfMLP.apply), grads(nerf_mlp_plain)):
        assert _rel(a, b) < 1e-6


def test_check_reads_planted_faults_and_the_control(step):
    limits = _limits()
    prog, out, hp = step["prog"], step["out"], step["hp"]
    ok = check_3dff.compare(prog, out, 0.05, hp)
    ok["iterations_checked"] = limits["iterations_checked"]
    assert check_3dff.correct(limits, ok), ok
    # one leaf's gradient zeroed where the program made it
    names = out["names"]
    bad = dict(prog, grads=[torch.zeros_like(g) if n == faults_3dff.ZEROED else g
                            for n, g in zip(names, prog["grads"])])
    got = check_3dff.compare(bad, out, 0.05, hp)
    got["iterations_checked"] = limits["iterations_checked"]
    assert not check_3dff.correct(limits, got) and got["grad_gap"] == 1.0
    # the lower-precision control in the program's place
    low = ref.step(step["params"], step["rcfg"], step["scene"], step["sup"], hp, None, low=True)
    ctl = check_3dff.reference_outputs(low, prog["params_before"])
    full = ref.step(step["params"], step["rcfg"], step["scene"], step["sup"], hp, None,
                    follow={k: ctl[k] for k in check_3dff.FOLLOWED})
    got = check_3dff.compare(ctl, full, 0.05, hp)
    got["iterations_checked"] = limits["iterations_checked"]
    assert not check_3dff.correct(limits, got), got


def test_reference_imports_neither_the_program_nor_jax():
    code = ("import sys, perfbench.reference.fields_ref\n"
            "bad = {n.split('.')[0] for n in sys.modules} & "
            "{'dynam3d_torch', 'dynam3d_tpu', 'jax', 'jaxlib', 'flax'}\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    assert r.returncode == 0, r.stderr
