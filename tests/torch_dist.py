"""Rank functions of the port's multi-process tests, spawned by
``dynam3d_torch.parallel.spawn.run_ranks`` (gloo ranks on the CPU, one
thread each).  This module imports torch and the port only, so a spawned
rank starts quickly; the JAX references are computed in the test process.
Each function takes ``(rank, world, device, ...)`` and returns numpy
arrays and plain values."""

from __future__ import annotations

import numpy as np
import torch

from dynam3d_torch.parallel import comm
from dynam3d_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return tree_map(lambda t: t.detach().float().numpy(), tree)


def tp_phi3(rank, world, dev, phi3_np, cfg, decode_in, train_in, opt_in, ckpt_dir):
    """Phi-3 tensor-parallel over all ranks (``dp = 1``): greedy decode with
    the collectives counted, the teacher-forced loss and its gradients
    (unsharded), three Adafactor updates of sharded leaves, and the
    checkpoint round trip (rank 0 saves the unsharded tree; every rank
    loads it back and shards it)."""
    from dynam3d_torch.config import LLaVAConfig
    from dynam3d_torch.models.vlm import llava, phi3
    from dynam3d_torch.parallel.mesh import (
        make_mesh, phi3_param_specs, shard_tree, split_qkv_params, unshard_tree,
    )
    from dynam3d_torch.runtime import checkpoint as ckpt_mod
    from dynam3d_torch.runtime.trainer_vln import Adafactor
    import torch.distributed as dist

    mesh = make_mesh(1, world)
    tp = mesh.tp_group
    split = split_qkv_params(_t(phi3_np), cfg)
    specs = phi3_param_specs(split)
    sh = shard_tree(split, specs, mesh)
    out = {"fused_eligible": phi3.decode_route(sh, cfg, 1) in ("ring", "split")}

    ids, valid, n_new = decode_in
    comm.reset_counts()
    emb = phi3.embed(sh, torch.from_numpy(ids), tp)
    out["ids"] = phi3.greedy_decode(sh, cfg, emb, torch.from_numpy(valid), n_new, tp=tp).numpy()
    out["decode_counts"] = dict(comm.counts)

    emb, valid, labels, lmask, plen, tw = (torch.from_numpy(a) for a in train_in)
    leaves = tree_leaves(sh)
    for t in leaves:
        t.requires_grad_(True)
    emb.requires_grad_(True)
    comm.reset_counts()
    o = llava.teacher_forced_loss({"phi3": sh}, LLaVAConfig(phi3=cfg), emb, valid,
                                  labels.long(), lmask, plen.long(), tw, tp=tp)
    out["train_forward_counts"] = dict(comm.counts)
    grads = torch.autograd.grad(o.loss, leaves + [emb], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves + [emb])]
    out["train_counts"] = dict(comm.counts)
    for t in leaves:
        t.requires_grad_(False)
    out["loss"] = float(o.loss)
    out["grads"] = _np(unshard_tree(tree_unflatten(sh, list(grads[:-1])), specs, mesh))
    out["emb_grad"] = grads[-1].numpy()

    # Adafactor over sharded leaves (opt_in: whole params, 3 gradient sets, splits)
    params, grad_sets, splits = opt_in
    p = {k: _shard(torch.from_numpy(v.copy()), s, mesh) for (k, v), s in zip(params.items(),
                                                                            splits)}
    opt = Adafactor(1e-2)
    st = opt.init(p, list(splits), tp)
    for gs in grad_sets:
        g = [_shard(torch.from_numpy(gs[k]), s, mesh) for k, s in zip(params, splits)]
        opt.step_(g, st, p, 1.0, list(splits), tp)
    out["adafactor"] = _np(unshard_tree(p, dict(zip(params, splits)), mesh))

    whole = unshard_tree(sh, specs, mesh)
    out["unshard_equal"] = all(torch.equal(a, b) for a, b in
                               zip(tree_leaves(whole), tree_leaves(split)))
    if rank == 0:
        ckpt_mod.save_checkpoint(ckpt_dir, 1, whole)
    dist.barrier()
    back = shard_tree(ckpt_mod.load_checkpoint(ckpt_mod.newest_checkpoint(ckpt_dir)), specs,
                      mesh)
    out["reshard_equal"] = all(torch.equal(a, b) for a, b in
                               zip(tree_leaves(back), tree_leaves(sh)))
    return out


def _shard(x, split, mesh):
    return x if split is None else x.chunk(mesh.tp, dim=split)[mesh.tp_rank].contiguous()


def _paths(tree, pre=""):
    """``tests/test_torch_pretrain.py``'s leaf paths (``/a/0/b``)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _paths(tree[k], f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, f"{pre}/{i}")]
    return [pre]


def _paths_np(tree):
    return dict(zip(_paths(tree), (t.detach().float().numpy().copy() for t in tree_leaves(tree))))


def dp_train(rank, world, dev, il, pre, lock, cli):
    """Data parallel over all ranks: the IL step on this rank's row (a step
    with a NaN loss on the last rank first, then the real one), the
    pretraining step on this rank's scene, ``VLNTrainer.train`` with
    episodes of unequal length, then with a looping episode (an ``"error."``
    teacher label) on rank 0, ``gather_list_and_concat`` of unequal row
    counts, then ``run.main`` at this world size."""
    import os

    import torch.distributed as dist

    from dynam3d_torch.convert import params_from_jax
    from dynam3d_torch.models import policy
    from dynam3d_torch.runtime import trainer_3dff, trainer_vln
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed
    from dynam3d_torch.runtime.vln_loop import VLNTrainer
    from dynam3d_torch.utils.misc import gather_list_and_concat

    group = dist.group.WORLD
    out = {}

    # --- IL step (il: cfg, params, splice, rows, nan_rows) ---
    cfg, params_np, splice, rows, nan_rows = il
    trainable, frozen = trainer_vln.split_params(params_from_jax(params_np, device="cpu"))
    opt = trainer_vln.make_optimizer(cfg)
    opt_state = opt.init(trainable)
    step = trainer_vln.make_train_step(cfg, opt, splice, dp=group)
    state0 = policy.batched_init_state(cfg, 1, "cpu")
    before = _paths_np(trainable)
    for name, batch in (("nan", nan_rows[rank]), ("step", rows[rank])):
        b = trainer_vln.TrainBatch(*(torch.from_numpy(a) for a in batch))
        _, _, _, m = step(trainable, frozen, opt_state, state0, b)
        out[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "skipped": m["skipped"], "count": opt_state["count"]}
        if name == "nan":
            out["nan"]["unchanged"] = all(np.array_equal(before[k], v)
                                          for k, v in _paths_np(trainable).items())
    out["trained"] = _paths_np(trainable)

    # --- pretraining step (pre: cfg, params, batches) ---
    pcfg, pparams_np, batches = pre
    pparams = params_from_jax(pparams_np, device="cpu")
    popt = trainer_3dff.make_pretrain_optimizer(pcfg)
    pstep = trainer_3dff.make_pretrain_step(pcfg, popt, dp=group)
    from dynam3d_torch.models.memory3d import init_state

    new, _, _, pm = pstep(pparams, popt.init(pparams), init_state(pcfg.fields, "cpu"),
                          trainer_3dff.PretrainBatch(*(None if a is None else torch.from_numpy(a)
                                                       for a in batches[rank])))
    out["pre_loss"] = float(pm["loss"])
    out["pre_trained"] = _paths_np(new)

    # --- lockstep (lock: cfg, goals) ---
    lcfg, goals = lock
    trainer = VLNTrainer(policy.init_policy_params(0, lcfg, llm_dtype=torch.float32,
                                                   device="cpu"),
                         lcfg, lambda: SyntheticRoomFeed(rgb_size=56, depth_size=32, views=1,
                                                         goal=goals[rank], seed=rank),
                         rank=rank, world=world, device="cpu", dp=group)
    trainer.train(2)
    out["lock"] = {"steps": [r["step"] for r in trainer.step_log], "idle": trainer.idle_steps,
                   "trained": _paths_np(trainer.trainable)}

    # --- a looping episode: rank 0's second teacher label is "error." ---
    from dynam3d_torch.runtime import vln_loop

    real_gt, labels = vln_loop.make_gt_text, []

    def looping(*a):
        labels.append(real_gt(*a))
        return "error.<|end|>" if rank == 0 and len(labels) == 2 else labels[-1]

    trainer.feed_factory = lambda: SyntheticRoomFeed(rgb_size=56, depth_size=32, views=1,
                                                     goal=goals[1], seed=rank)
    logged, idle = len(trainer.step_log), trainer.idle_steps
    vln_loop.make_gt_text = looping
    try:
        trainer.train(1)
    finally:
        vln_loop.make_gt_text = real_gt
    out["error"] = {"steps": [r["step"] for r in trainer.step_log[logged:]],
                    "idle": trainer.idle_steps - idle, "trained": _paths_np(trainer.trainable)}

    out["gathered"] = gather_list_and_concat(np.full((rank + 1, 2), rank, np.int64), group)
    out["ungrouped"] = gather_list_and_concat(np.full((1, 2), rank, np.int64))

    # --- the CLI (cli: working directory, argv) ---
    workdir, argv = cli
    os.chdir(workdir)
    from dynam3d_torch import run

    run.main(argv, device="cpu")
    return out


def ss_etp_run(rank, world, dev, workdir, argv):
    """``run.main`` for SS-ETP training at this world size, recording per
    iteration the dataset drawn and the inputs and result of its update: a
    frames step's trainable tree, optimizer state and batch; a walk's
    trainable tree, optimizer state, accumulated gradient and step count."""
    import os

    from dynam3d_torch import run
    from dynam3d_torch.runtime import trainer_3dff

    def snap(tree):
        return tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t, tree)

    recs = []
    draw, make_step = trainer_3dff.draw_dataset_id, trainer_3dff.make_pretrain_step
    apply = trainer_3dff.apply_accumulated_grads

    def drawing(seed, it, n):
        recs.append({"dataset": draw(seed, it, n)})
        return recs[-1]["dataset"]

    def making(cfg, opt, posed=False, dp=None):
        step = make_step(cfg, opt, posed=posed, dp=dp)

        def recorded(tr, opt_state, field_state, batch):
            recs[-1].update(kind="frames", posed=posed, before=snap(tr), opt=snap(opt_state),
                            batch=tuple(None if t is None else t.clone() for t in batch))
            out = step(tr, opt_state, field_state, batch)
            recs[-1].update(after=snap(out[0]), loss=float(out[3]["loss"]))
            return out
        return recorded

    def applying(opt, tr, opt_state, grad_sum, n_steps, dp=None):
        recs[-1].update(kind="walk", before=snap(tr), opt=snap(opt_state),
                        grad_sum=snap(grad_sum), n_steps=n_steps)
        out = apply(opt, tr, opt_state, grad_sum, n_steps, dp=dp)
        recs[-1]["after"] = snap(out[0])
        return out

    trainer_3dff.draw_dataset_id = drawing
    trainer_3dff.make_pretrain_step = making
    trainer_3dff.apply_accumulated_grads = applying
    os.chdir(workdir)
    try:
        run.main(argv, device="cpu")
    finally:
        trainer_3dff.draw_dataset_id = draw
        trainer_3dff.make_pretrain_step = make_step
        trainer_3dff.apply_accumulated_grads = apply
    return recs


def run_cli(rank, world, dev, workdir, argvs, rxr=True):
    """``run.main(argv, device="cpu")`` for each of ``argvs`` at this world
    size, in ``workdir``, then with ``rxr`` the rxr inference file of 3
    rooms."""
    import os

    from dynam3d_torch import run

    os.chdir(workdir)
    for argv in argvs:
        run.main(argv, device="cpu")
    return rxr_inference(rank, world, workdir, argvs[0]) if rxr else None


def rxr_inference(rank, world, workdir, argv):
    """``vln_loop.inference(fmt="rxr")`` over 3 rooms on the config of
    ``argv`` (its ``--exp-config`` and overrides), into
    ``{workdir}/rxr_w{world}.jsonl``; with a group at ``world`` > 1."""
    import os

    import torch.distributed as dist

    from dynam3d_torch.config import apply_opts, load
    from dynam3d_torch.models import policy
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed
    from dynam3d_torch.runtime.vln_loop import inference

    cfg = apply_opts(load(argv[argv.index("--exp-config") + 1]), [a for a in argv if "=" in a])
    params = policy.init_policy_params(cfg.train.seed, cfg, device="cpu")
    feeds = [SyntheticRoomFeed(seed=40 + i) for i in range(3)]
    out = os.path.join(workdir, f"rxr_w{world}.jsonl")
    return inference(params, cfg, feeds, [f"ep{i}" for i in range(3)], out_path=out,
                     rank=rank, world=world, fmt="rxr", device="cpu",
                     dp=dist.group.WORLD if world > 1 else None)
