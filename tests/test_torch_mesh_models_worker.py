"""One rank of the port's tests of every model of ``build_model`` on every
mesh of the Trainer (``tests/test_torch_mesh_models.py``).

    python tests/test_torch_mesh_models_worker.py DIR RANK WORLD

Joins a gloo process group of WORLD ranks through a ``FileStore`` in DIR and
runs what DIR/spec.json lists, one part after the other in this one group:

* ``halo``: single layers on a rank's rows (``parallel.spatial.ConvRows``)
  over the first 2 and the first 3 ranks (their own groups): a 7×7/2, a
  3×3/2 and a 3×3/1 convolution and the 3×3/2 max-pool, forward and
  backward, against the same layer on the whole image on this rank. It
  writes the largest error of the output rows, the input rows' gradient
  and the weight's gradient (summed over the ranks), and the padding rows
  each rank's window took above and below;
* ``steps``: each case (its config options, the file of the whole model's
  weights in DIR, the parameter and compute type) builds the model of its
  mesh (``parallel.mesh_from_cfg``; this rank's heads under 'tp', sliced by
  ``parallel.fully_shard`` under 'fsdp'), loads the weights
  (``parallel.load_full_state_dict``), redraws the performer's projections
  from the case's ``redraw`` seed, and takes one training step
  (``train.engine.TrainStep`` on the mesh, seed 0, no mixup) on its data
  replica's share of the global batch. A case with ``ranks`` runs on those
  ranks alone, on a mesh of one spatial group of them built here
  (``parallel.Mesh`` by hand); the other ranks skip it. It writes the loss,
  the training forward's logits, every gradient gathered whole, the
  running statistics, the performer's projections, and then the eval
  logits of the same images on its rows (``parallel.spatial_forward``);
* ``trainers``: each run of ``train.trainer.run_experiment`` into DIR/NAME;
  it writes the logged losses and the evals' top1.

Each rank writes DIR/rank{RANK}.npz. It imports neither jax nor ``vil_tpu``.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_split_options_worker import DTYPES, build, whole  # noqa: E402
from vil_tpu_torch import parallel  # noqa: E402
from vil_tpu_torch.config import get_default_cfg  # noqa: E402
from vil_tpu_torch.parallel.spatial import ConvRows, block_split  # noqa: E402
from vil_tpu_torch.train import engine, loss, optim, redraw  # noqa: E402
from vil_tpu_torch.train.trainer import run_experiment  # noqa: E402

# the single layers: name → (kernel, stride, padding, max-pool)
LAYERS = {"conv7s2": (7, 2, 3, False), "conv3s2": (3, 2, 1, False),
          "conv3s1": (3, 1, 1, False), "pool3s2": (3, 2, 1, True)}
HALO_ROWS, HALO_UNIT = 22, 2  # an image of 22 rows cut at even rows


def _cfg(opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(opts)
    return cfg


def run_halo(groups: dict) -> dict:
    """Each layer over each group of the first ranks, against the whole
    image: f64, inputs offset so that a wrong padding value shows (positive
    for the convolutions, negative for the max-pool)."""
    res = {}
    x0 = torch.randn(2, 3, HALO_ROWS, 9, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0))
    for size, group in groups.items():
        if group is None:  # this rank is not in the group
            continue
        ctx = parallel.SpatialContext.of(group)
        spans = block_split(HALO_ROWS, HALO_UNIT, size)
        rows = ConvRows(spans, HALO_ROWS, ctx)
        lo, hi = spans[ctx.rank]
        for i, (name, (k, s, p, pool)) in enumerate(LAYERS.items()):
            x = (x0 - 10.0 if pool else x0 + 5.0).requires_grad_()
            w = torch.randn(4, 3, k, k, dtype=torch.float64,  # the same on every rank
                            generator=torch.Generator().manual_seed(1 + i)).requires_grad_()
            mine = x.detach()[:, :, lo:hi].clone().requires_grad_()
            if pool:
                ref = F.max_pool2d(x, k, s, p)
                out = F.max_pool2d(rows.window(mine, k, s, p, float("-inf")), k, s, (0, p))
            else:
                ref = F.conv2d(x, w, stride=s, padding=p)
                out = F.conv2d(rows.window(mine, k, s, p), w, stride=s, padding=(0, p))
            o_lo, o_hi = rows.after(k, s, p).spans[ctx.rank]
            upstream = torch.randn(ref.shape, dtype=torch.float64,
                                   generator=torch.Generator().manual_seed(1))
            wanted = [x] if pool else [x, w]
            ref_grads = torch.autograd.grad((ref * upstream).sum(), wanted)
            grads = list(torch.autograd.grad((out * upstream[:, :, o_lo:o_hi]).sum(),
                                             [mine] + wanted[1:]))
            if not pool:  # each rank's part of the weight's gradient, summed
                dist.all_reduce(grads[1], group=group)
            errs = [(out - ref[:, :, o_lo:o_hi]).abs().max().item(),
                    (grads[0] - ref_grads[0][:, :, lo:hi]).abs().max().item(),
                    0.0 if pool else (grads[1] - ref_grads[1]).abs().max().item()]
            halo = rows._halo(ctx.rank, k, s, p)
            res[f"halo/{size}/{name}"] = np.array(errs)
            res[f"halo/{size}/{name}/pad"] = np.array([halo[0], halo[4]])
            res[f"halo/{size}/{name}/scale"] = np.array(
                [ref.abs().max().item(), *(g.abs().max().item() for g in ref_grads),
                 *([] if not pool else [1.0])])
    return res


def _sub_mesh(group):
    """A ('data', 'spatial') mesh of one data replica over ``group``."""
    return parallel.Mesh(1, 0, parallel.SpatialContext.of(group), data_group=None,
                         param_group=group)


def run_steps(out_dir, cases: dict, groups: dict) -> dict:
    res = {}
    for case, spec in cases.items():
        cfg = _cfg(spec["opts"])
        dtype = DTYPES[spec.get("dtype", "float32")]
        inp = np.load(os.path.join(out_dir, spec.get("inputs", "inputs.npz")))
        sub = spec.get("ranks")
        if sub is not None:
            group = groups[len(sub)]
            if group is None:
                continue
            mesh = _sub_mesh(group)
        else:
            mesh = parallel.mesh_from_cfg(cfg)
        model = build(out_dir, spec, cfg, mesh)
        if spec.get("redraw") is not None:
            redraw.redraw_projections(model, torch.Generator().manual_seed(spec["redraw"]))
        n = len(inp["images"]) // mesh.data_size
        rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
        images = torch.from_numpy(inp["images"][rows]).to(dtype)
        targets = torch.from_numpy(inp["targets"][rows])
        seen = []
        hook = model.register_forward_hook(lambda m, a, out: seen.append(out.detach()))
        step = engine.make_train_step(model, loss.cross_entropy, optim.get_opt(cfg, model),
                                      device="cpu", seed=0, mesh=mesh)
        value = step(images, targets)["loss"].item()
        hook.remove()
        res[f"{case}/loss"] = value
        res[f"{case}/logits"] = seen[0].float().numpy()
        for name, p in model.named_parameters():
            res[f"{case}/grad/{name}"] = whole(model, name, p.grad)
        for name, b in model.named_buffers():
            if "running" in name or "projection_matrix" in name:
                res[f"{case}/buffer/{name}"] = b.numpy()
        if mesh.spatial is not None:
            with torch.no_grad():
                for p in model.parameters():
                    p.grad = None
                served = parallel.spatial_forward(
                    model.eval(), parallel.shard_image(images, model, mesh.spatial.group),
                    mesh.spatial.group)
            if getattr(model, "fsdp", None) is not None:
                model.fsdp.release()
            res[f"{case}/eval"] = served.float().numpy()
    return res


def run_trainers(out_dir, runs: dict) -> dict:
    res = {}
    for name, opts in runs.items():
        trainer = run_experiment(_cfg(opts + ["OUTPUT_DIR", os.path.join(out_dir, name)]),
                                 device="cpu")
        res[f"{name}/losses"] = [r["loss"] for r in trainer.steps_log]
        res[f"{name}/top1"] = [e["top1"] for e in trainer.evals]
    return res


def main():
    out_dir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    parallel.init_process_group(os.path.join(out_dir, "store"), rank, world, backend="gloo")
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    # the groups of the first 2 and 3 ranks: every rank creates both
    groups = {}
    for size in (2, 3):
        g = dist.new_group(list(range(size)))
        groups[size] = g if rank < size else None
    res = {}
    res.update(run_halo(groups))
    res.update(run_steps(out_dir, spec.get("steps", {}), groups))
    res.update(run_trainers(out_dir, spec.get("trainers", {})))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})
    parallel.synchronize()
    dist.destroy_process_group()
    print(f"WORKER {rank} DONE", flush=True)


if __name__ == "__main__":
    main()
