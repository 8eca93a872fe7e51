"""One rank of the port's tests of heads and rows split at once
(``tests/test_torch_mesh3d.py``).

    python tests/test_torch_mesh3d_worker.py DIR RANK WORLD

Joins a gloo process group of WORLD ranks through a ``FileStore`` in DIR and
runs what DIR/spec.json lists, on the meshes its options name (a
('data', 'spatial', 'model') mesh under 'tp', a ('data', 'spatial') mesh
under 'fsdp'), one after the other in this one group:

* ``groups``: the mesh of these options (``parallel.mesh_from_cfg``); it
  writes the global ranks of this rank's spatial, model, data, parameter
  and replica groups;
* ``steps``: each case (its config options, the file of the whole model's
  weights in DIR, the port's names, and the neighbour ``modes`` the step
  takes) builds the model of its mesh (this rank's heads under 'tp',
  sliced by ``parallel.fully_shard`` under 'fsdp'), loads the weights
  (``parallel.load_full_state_dict``) and takes one training step
  (``train.engine.TrainStep`` on the mesh, seed 0, no mixup) on its data
  replica's share of the global batch in DIR/inputs.npz. It writes the
  loss, every gradient gathered whole, every dropout mask the step drew
  with the ``layers.Part`` it covers, and every collective the step issued,
  in order (``parallel.count_collectives``);
* ``trainers``: each run of ``train.trainer.run_experiment`` into DIR/NAME;
  it writes the logged losses, the evals' top1, and whether the checkpoint
  the run wrote last holds, cut by this rank's shards, this rank's
  parameters bit for bit.

Each rank writes DIR/rank{RANK}.npz. It imports neither jax nor ``vil_tpu``.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_split_options_worker import MaskLog, build, whole  # noqa: E402
from vil_tpu_torch import parallel  # noqa: E402
from vil_tpu_torch.config import get_default_cfg  # noqa: E402
from vil_tpu_torch.train import engine, loss, optim  # noqa: E402
from vil_tpu_torch.train.trainer import run_experiment  # noqa: E402


def _cfg(opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(opts)
    return cfg


def _ranks(group) -> list:
    """The global ranks of ``group`` (the default group when None)."""
    return dist.get_process_group_ranks(group or dist.group.WORLD)


def run_groups(opts) -> dict:
    if not opts:
        return {}
    mesh = parallel.mesh_from_cfg(_cfg(opts))
    return {"groups": json.dumps({
        "spatial": _ranks(mesh.spatial.group), "model": _ranks(mesh.model.group),
        "data": _ranks(mesh.data_group), "param": _ranks(mesh.param_group),
        "replica": _ranks(mesh.replica.group), "data_rank": mesh.data_rank})}


def run_steps(out_dir, cases: dict) -> dict:
    inp = np.load(os.path.join(out_dir, "inputs.npz"))
    res = {}
    for case, spec in cases.items():
        cfg = _cfg(spec["opts"])
        mesh = parallel.mesh_from_cfg(cfg)
        model = build(out_dir, spec, cfg, mesh)
        step = engine.make_train_step(model, loss.cross_entropy, optim.get_opt(cfg, model),
                                      device="cpu", seed=0, mesh=mesh)
        n = len(inp["images"]) // mesh.data_size
        rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
        with MaskLog() as drawn, parallel.count_collectives() as issued:
            metrics = step(torch.from_numpy(inp["images"][rows]),
                           torch.from_numpy(inp["targets"][rows]), modes=spec.get("modes"))
        res[f"{case}/loss"] = metrics["loss"].item()
        res[f"{case}/collectives"] = json.dumps(issued)
        res[f"{case}/cuts"] = json.dumps(drawn.cuts)
        for i, m in enumerate(drawn.masks):
            res[f"{case}/mask/{i}"] = m
        for name, p in model.named_parameters():
            res[f"{case}/grad/{name}"] = whole(model, name, p.grad)
    return res


def run_trainers(out_dir, runs: dict) -> dict:
    res = {}
    for name, opts in runs.items():
        run_dir = os.path.join(out_dir, name)
        trainer = run_experiment(_cfg(opts + ["OUTPUT_DIR", run_dir]), device="cpu")
        res[f"{name}/losses"] = [r["loss"] for r in trainer.steps_log]
        res[f"{name}/top1"] = [e["top1"] for e in trainer.evals]
        # the last checkpoint: the whole state, of which each rank holds its cut
        with open(os.path.join(run_dir, "last_checkpoint")) as f:
            saved = f.read().strip()
        state = torch.load(os.path.join(run_dir, os.path.basename(saved)), weights_only=False)
        shards = trainer.model.param_shards
        res[f"{name}/checkpoint_is_the_mesh"] = all(
            torch.equal(shards[n].local(state["model"][n]) if n in shards else state["model"][n],
                        p.detach())
            for n, p in trainer.model.named_parameters())
    return res


def main():
    out_dir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    parallel.init_process_group(os.path.join(out_dir, "store"), rank, world, backend="gloo")
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    res = {}
    res.update(run_groups(spec.get("groups")))
    res.update(run_steps(out_dir, spec.get("steps", {})))
    res.update(run_trainers(out_dir, spec.get("trainers", {})))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})
    parallel.synchronize()
    dist.destroy_process_group()
    print(f"WORKER {rank} DONE", flush=True)


if __name__ == "__main__":
    main()
