"""One rank of the port's tests of TPU.REMAT, MODEL.VIT.DROP and the ResNet
off the data axis (``tests/test_torch_split_options.py``).

    python tests/test_torch_split_options_worker.py DIR RANK WORLD

Joins a gloo process group of WORLD ranks through a ``FileStore`` in DIR and
runs what DIR/spec.json lists, on the meshes its options name (a
('data', 'spatial') mesh, 'tp' on a ('data', 'model') mesh, 'fsdp' over the
data axis), one after the other in this one group:

* ``steps``: each case (its config options; the file of the whole model's
  weights in DIR, the port's names; its inputs, DIR/inputs.npz by default;
  FSDP's ``min_size``; the parameter and compute type) builds the model of its mesh (this rank's shard under 'tp',
  sliced by ``parallel.fully_shard`` under 'fsdp'), loads the weights
  (``parallel.load_full_state_dict``) and takes one training step
  (``train.engine.TrainStep`` on the mesh, seed 0, no mixup) on its data
  replica's share of the global batch in DIR/inputs.npz. It writes the
  loss, every gradient gathered whole, every dropout mask the step drew
  (the kept elements, in the order drawn, with the ``layers.Part`` of the
  whole value each covers) and every collective the step issued, in order
  (``parallel.count_collectives``);
* ``release``: a case under 'fsdp' and REMAT whose gathered parameters are
  let go between the forward and the backward: it writes the error the
  backward raised;
* ``trainers``: each run of ``train.trainer.run_experiment`` into DIR/NAME;
  it writes the logged losses and the evals' top1.

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
from vil_tpu_torch.models import build_model, layers  # noqa: E402
from vil_tpu_torch.train import engine, loss, optim  # noqa: E402
from vil_tpu_torch.train.trainer import run_experiment  # noqa: E402

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class MaskLog:
    """Records every mask ``layers.dropout`` draws while it is entered: the
    kept elements (the output's nonzeros; the inputs are random floats) and
    the cuts of the part of the whole value that it covers."""

    def __init__(self):
        self.masks, self.cuts = [], []

    def __enter__(self):
        self.original = layers.dropout

        def recorded(x, rate, generator, part=None):
            out = self.original(x, rate, generator, part)
            self.masks.append((out != 0).numpy())
            self.cuts.append([] if part is None else [
                [dim, total, [list(s) for s in spans]] for dim, total, spans in part.cuts])
            return out

        layers.dropout = recorded
        return self

    def __exit__(self, *exc):
        layers.dropout = self.original


def whole(model, name: str, t: torch.Tensor) -> np.ndarray:
    """The whole tensor of which ``t`` is parameter ``name``'s shard."""
    shard = model.param_shards.get(name)
    return (t if shard is None else shard.gather(t)).detach().numpy()


def build(out_dir, spec, cfg, mesh):
    dtype = DTYPES[spec.get("dtype", "float32")]
    model = build_model(cfg, device="cpu", mesh=mesh, dtype=dtype, param_dtype=dtype)
    if cfg.TPU.PARAM_SHARDING == "fsdp":
        parallel.fully_shard(model, mesh, min_size=spec.get("min_size", 0))
    state = torch.load(os.path.join(out_dir, spec["weights"]), weights_only=True)
    parallel.load_full_state_dict(model, state)
    return model


def run_steps(out_dir, cases: dict) -> dict:
    res = {}
    for case, spec in cases.items():
        inp = np.load(os.path.join(out_dir, spec.get("inputs", "inputs.npz")))
        cfg = get_default_cfg()
        cfg.merge_from_list(spec["opts"])
        mesh = parallel.mesh_from_cfg(cfg)
        model = build(out_dir, spec, cfg, mesh)
        step = engine.make_train_step(model, loss.cross_entropy, optim.get_opt(cfg, model),
                                      device="cpu", seed=0, mesh=mesh)
        n = len(inp["images"]) // mesh.data_size
        rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
        images = torch.from_numpy(inp["images"][rows]).to(DTYPES[spec.get("dtype", "float32")])
        with MaskLog() as drawn, parallel.count_collectives() as issued:
            metrics = step(images, torch.from_numpy(inp["targets"][rows]))
        res[f"{case}/loss"] = metrics["loss"].item()
        res[f"{case}/collectives"] = json.dumps(issued)
        res[f"{case}/cuts"] = json.dumps(drawn.cuts)
        for i, m in enumerate(drawn.masks):
            res[f"{case}/mask/{i}"] = m
        for name, p in model.named_parameters():
            res[f"{case}/grad/{name}"] = whole(model, name, p.grad)
        for name, b in model.named_buffers():
            if "running" in name:
                res[f"{case}/buffer/{name}"] = b.numpy()
    return res


def run_release(out_dir, spec: dict) -> dict:
    """The step's forward and backward with the gathered parameters let go
    in between: the recompute would read the slices."""
    if not spec:
        return {}
    inp = np.load(os.path.join(out_dir, "inputs.npz"))
    cfg = get_default_cfg()
    cfg.merge_from_list(spec["opts"])
    mesh = parallel.mesh_from_cfg(cfg)
    model = build(out_dir, spec, cfg, mesh).train()
    n = len(inp["images"]) // mesh.data_size
    rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
    logits = model(torch.from_numpy(inp["images"][rows]), generator=torch.Generator())
    model.fsdp.release()
    try:
        loss.cross_entropy(logits, torch.from_numpy(inp["targets"][rows])).backward()
        error = ""
    except RuntimeError as e:
        error = str(e)
    return {"release/error": error}


def run_trainers(out_dir, runs: dict) -> dict:
    res = {}
    for name, opts in runs.items():
        cfg = get_default_cfg()
        cfg.merge_from_list(opts + ["OUTPUT_DIR", os.path.join(out_dir, name)])
        trainer = run_experiment(cfg, device="cpu")
        res[f"{name}/losses"] = [r["loss"] for r in trainer.steps_log]
        res[f"{name}/top1"] = [e["top1"] for e in trainer.evals]
    return res


def main():
    out_dir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    parallel.init_process_group(os.path.join(out_dir, "store"), rank, world, backend="gloo")
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    res = {}
    res.update(run_steps(out_dir, spec.get("steps", {})))
    res.update(run_release(out_dir, spec.get("release", {})))
    res.update(run_trainers(out_dir, spec.get("trainers", {})))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})
    parallel.synchronize()
    torch.distributed.destroy_process_group()
    print(f"WORKER {rank} DONE", flush=True)


if __name__ == "__main__":
    main()
