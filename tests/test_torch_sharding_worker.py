"""One rank of the port's parameter-sharding tests (``tests/test_torch_sharding.py``).

    python tests/test_torch_sharding_worker.py DIR RANK WORLD

Joins a gloo process group of WORLD ranks through a ``FileStore`` in DIR and
runs what DIR/spec.json lists:

* ``steps``: each case (its config options, with the mesh and
  TPU.PARAM_SHARDING; the file of ``vil_tpu``'s parameters in DIR, flat
  names; the modes to inject, or none; FSDP's ``min_size``) builds
  the model (this rank's shard under 'tp', sliced by
  ``parallel.fully_shard`` under 'fsdp'), fills it with
  ``utils.jax_import.load_jax_params`` and takes one training step
  (``train.engine.TrainStep`` on the mesh, seeded, no mixup) on its data
  replica's share of the global batch in DIR/inputs.npz; it writes the loss,
  every parameter's gradient and updated value, gathered whole, and the
  bytes of parameters and optimizer moments this rank holds;
* ``trainers``: for each run (its options and whether to resume),
  ``train.trainer.run_experiment`` into DIR/run_NAME; with ``resume``, a
  run into DIR/cut_NAME stopped when its second epoch starts and a new
  Trainer that resumes it; it writes the logged losses and the evals;
* ``resnet``: a narrow ResNet of the zoo on the data axis of every rank
  (its BatchNorms over the global batch), its weights and running
  statistics from DIR/STATE (the port's names), one AdamW step on its
  replica's share of the global batch; it writes the loss, every gradient,
  the updated parameters and the running statistics.

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
from vil_tpu_torch.models import build_model, build_resnet  # noqa: E402
from vil_tpu_torch.train import engine, loss, optim  # noqa: E402
from vil_tpu_torch.train.trainer import Trainer, run_experiment  # noqa: E402
from vil_tpu_torch.utils import jax_import  # noqa: E402


def nested(flat: dict) -> dict:
    """{"a/b/c": array} → {"a": {"b": {"c": array}}}."""
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def whole(model, name: str, t: torch.Tensor) -> np.ndarray:
    """The whole tensor of which ``t`` is parameter ``name``'s shard."""
    shard = model.param_shards.get(name)
    return (t if shard is None else shard.gather(t)).detach().numpy()


def run_steps(out_dir, cases: dict) -> dict:
    inp = np.load(os.path.join(out_dir, "inputs.npz"))
    res = {}
    for case, spec in cases.items():
        cfg = get_default_cfg()
        cfg.merge_from_list(spec["opts"])
        mesh = parallel.mesh_from_cfg(cfg)
        model = build_model(cfg, device="cpu", mesh=mesh)
        if cfg.TPU.PARAM_SHARDING == "fsdp":
            parallel.fully_shard(model, mesh, min_size=spec["min_size"])
        jax_import.load_jax_params(model, nested(dict(np.load(os.path.join(out_dir,
                                                                           spec["params"])))))
        opt = optim.get_opt(cfg, model)
        step = engine.make_train_step(model, loss.cross_entropy, opt, device="cpu", seed=0,
                                      mesh=mesh)
        n = len(inp["images"]) // mesh.data_size
        rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
        metrics = step(torch.from_numpy(inp["images"][rows]),
                       torch.from_numpy(inp["targets"][rows]), modes=spec.get("modes"))
        res[f"{case}/loss"] = metrics["loss"].item()
        res[f"{case}/coords"] = [mesh.data_rank, 0 if mesh.model is None else mesh.model.rank]
        res[f"{case}/bytes"] = list(parallel.param_bytes(model, opt))
        res[f"{case}/sharded"] = sorted(model.param_shards)
        for name, p in model.named_parameters():
            res[f"{case}/grad/{name}"] = whole(model, name, p.grad)
            res[f"{case}/param/{name}"] = whole(model, name, p)
    return res


def run_resnet(out_dir, spec: dict) -> dict:
    if not spec:
        return {}
    inp = np.load(os.path.join(out_dir, "inputs.npz"))
    cfg = get_default_cfg()
    cfg.merge_from_list(spec["opts"])
    mesh = parallel.mesh_from_cfg(cfg)
    model = build_resnet(spec["name"], cfg.DATA.NUM_CLASSES, device="cpu",
                         layers=tuple(spec["layers"]), group=mesh.data_group,
                         group_size=mesh.data_size)
    state = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(out_dir,
                                                                     spec["state"])).items()}
    model.load_state_dict(state)
    step = engine.make_train_step(model, loss.cross_entropy, optim.get_opt(cfg, model),
                                  device="cpu", seed=0, mesh=mesh)
    n = len(inp["images"]) // mesh.data_size
    rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
    metrics = step(torch.from_numpy(inp["images"][rows]), torch.from_numpy(inp["targets"][rows]))
    res = {"resnet/loss": metrics["loss"].item()}
    for name, p in model.named_parameters():
        res[f"resnet/grad/{name}"] = p.grad.numpy()
        res[f"resnet/param/{name}"] = p.detach().numpy()
    for name, b in model.named_buffers():
        res[f"resnet/buffer/{name}"] = b.numpy()
    return res


class _Stop(Exception):
    pass


def run_trainers(out_dir, runs: dict) -> dict:
    res = {}
    for name, spec in runs.items():
        def cfg_in(sub):
            cfg = get_default_cfg()
            cfg.merge_from_list(spec["opts"] + ["OUTPUT_DIR", os.path.join(out_dir, sub)])
            return cfg

        trainer = run_experiment(cfg_in(f"run_{name}"), device="cpu")
        res.update({f"{name}/losses": [r["loss"] for r in trainer.steps_log],
                    f"{name}/top1": [e["top1"] for e in trainer.evals],
                    f"{name}/images": [e["images"] for e in trainer.evals],
                    f"{name}/best_evaluated": trainer.best_evaluated,
                    f"{name}/sharded": sorted(trainer.model.param_shards)})
        if spec.get("resume"):
            first = Trainer(cfg_in(f"cut_{name}"), device="cpu")
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
            second = Trainer(cfg_in(f"cut_{name}"), device="cpu")
            res[f"{name}/resumed_start"] = [second.start_epoch, second.train_step.step]
            second.fit()
            res[f"{name}/resumed_losses"] = [r["loss"] for r in first.steps_log
                                             + second.steps_log]
            res[f"{name}/resumed_top1"] = [e["top1"] for e in second.evals]
    return res


def main():
    out_dir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    parallel.init_process_group(os.path.join(out_dir, "store"), rank, world, backend="gloo")
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    res = {}
    res.update(run_steps(out_dir, spec.get("steps", {})))
    res.update(run_trainers(out_dir, spec.get("trainers", {})))
    res.update(run_resnet(out_dir, spec.get("resnet", {})))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})
    parallel.synchronize()
    torch.distributed.destroy_process_group()
    print(f"WORKER {rank} DONE", flush=True)


if __name__ == "__main__":
    main()
