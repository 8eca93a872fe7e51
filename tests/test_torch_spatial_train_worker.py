"""One rank of the port's multi-process training tests (``tests/test_torch_spatial_train.py``).

    python tests/test_torch_spatial_train_worker.py DIR RANK WORLD SPATIAL MODE[+MODE]

Joins a gloo process group of WORLD ranks through a ``FileStore`` in DIR,
builds the config's ('data', 'spatial') mesh (``TPU.MESH_AXES`` 'data' and
'spatial' with SPATIAL ranks on the spatial axis; 'data' alone when SPATIAL
is 1 and WORLD is not), and runs each MODE in turn:

* ``step``: for each case of DIR/cases.json (its options, the file of
  its weights in DIR and, optionally, how the step runs: ``random_shift``
  draws the modes from the step's seed, ``modes`` gives them), the model
  takes one training step (``train.engine.TrainStep`` on the mesh) on its
  data replica's share of the global batch in DIR/inputs.npz; it writes the
  loss, every parameter's gradient and updated value, and the modes drawn;
* ``trainer``: ``train.trainer.run_experiment`` of DIR/trainer.json's
  options into DIR/run, then, with ``resume`` set, a run into DIR/cut
  stopped when its second epoch starts and a new Trainer that resumes it;
  it writes the logged losses and the evals.

Each rank writes DIR/rank{RANK}.npz. It imports neither jax nor ``vil_tpu``.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vil_tpu_torch import parallel  # noqa: E402
from vil_tpu_torch.config import get_default_cfg  # noqa: E402
from vil_tpu_torch.models import build_model  # noqa: E402
from vil_tpu_torch.train import engine, loss, optim  # noqa: E402
from vil_tpu_torch.train.trainer import Trainer, run_experiment  # noqa: E402


def mesh_opts(world: int, spatial: int) -> list:
    if spatial == 1 and world > 1:
        return ["TPU.MESH_AXES", "['data']", "TPU.MESH_SHAPE", f"[{world}]"]
    return ["TPU.MESH_AXES", "['data','spatial']", "TPU.MESH_SHAPE",
            f"[{world // spatial},{spatial}]"]


def run_steps(out_dir, world, spatial) -> dict:
    inp = np.load(os.path.join(out_dir, "inputs.npz"))
    with open(os.path.join(out_dir, "cases.json")) as f:
        cases = json.load(f)
    res, mesh = {}, None
    for case, (opts, weights, *how) in cases.items():
        how = how[0] if how else {}
        cfg = get_default_cfg()
        cfg.merge_from_list(opts + mesh_opts(world, spatial))
        if mesh is None:  # one mesh, one set of process groups, for every case
            mesh = parallel.mesh_from_cfg(cfg)
            res["data"], res["spatial_rank"] = mesh.data_rank, (
                0 if mesh.spatial is None else mesh.spatial.rank)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(torch.load(os.path.join(out_dir, weights)))
        step = engine.make_train_step(model, loss.cross_entropy, optim.get_opt(cfg, model),
                                      device="cpu", seed=0, mesh=mesh,
                                      random_shift=how.get("random_shift", False))
        n = len(inp["images"]) // mesh.data_size
        rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
        metrics = step(torch.from_numpy(inp["images"][rows]),
                       torch.from_numpy(inp["targets"][rows]), modes=how.get("modes"))
        res[f"{case}/loss"] = metrics["loss"].item()
        if "modes" in metrics:
            res[f"{case}/modes"] = metrics["modes"]
        for name, p in model.named_parameters():
            res[f"{case}/grad/{name}"] = p.grad.numpy()
            res[f"{case}/param/{name}"] = p.detach().numpy()
    return res


class _Stop(Exception):
    pass


def run_trainer(out_dir, world, spatial) -> dict:
    with open(os.path.join(out_dir, "trainer.json")) as f:
        spec = json.load(f)

    def cfg_in(name):
        cfg = get_default_cfg()
        cfg.merge_from_list(spec["opts"] + mesh_opts(world, spatial)
                            + ["OUTPUT_DIR", os.path.join(out_dir, name)])
        return cfg

    trainer = run_experiment(cfg_in("run"), device="cpu")
    res = {"data": trainer.mesh.data_rank,
           "spatial_rank": 0 if trainer.mesh.spatial is None else trainer.mesh.spatial.rank,
           "losses": [r["loss"] for r in trainer.steps_log],
           "steps": [r["step"] for r in trainer.steps_log],
           "top1": [e["top1"] for e in trainer.evals],
           "images": [e["images"] for e in trainer.evals],
           "best_evaluated": trainer.best_evaluated}
    if spec.get("resume"):
        first = Trainer(cfg_in("cut"), device="cpu")
        train_epoch = first.train_epoch

        def stop_at_epoch_1(epoch, meters=None):
            if epoch == 1:
                raise _Stop
            train_epoch(epoch, meters)

        first.train_epoch = stop_at_epoch_1
        try:
            first.fit()
        except _Stop:
            pass
        second = Trainer(cfg_in("cut"), device="cpu")
        res["resumed_start"] = [second.start_epoch, second.train_step.step]
        second.fit()
        res["resumed_losses"] = [r["loss"] for r in first.steps_log + second.steps_log]
        res["resumed_top1"] = [e["top1"] for e in second.evals]
    return res


def main():
    out_dir, rank, world, spatial, mode = (sys.argv[1], *map(int, sys.argv[2:5]), sys.argv[5])
    torch.set_num_threads(1)
    parallel.init_process_group(os.path.join(out_dir, "store"), rank, world, backend="gloo")
    res = {}
    for part in mode.split("+"):
        res.update(run_steps(out_dir, world, spatial) if part == "step" else
                   run_trainer(out_dir, world, spatial))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})
    parallel.synchronize()
    torch.distributed.destroy_process_group()
    print(f"WORKER {rank} DONE", flush=True)


if __name__ == "__main__":
    main()
