"""One rank of the port's spatial-parallelism tests (``tests/test_torch_spatial.py``).

    python tests/test_torch_spatial_worker.py DIR RANK WORLD SPATIAL

Joins a gloo process group through a ``FileStore`` in DIR, with the ranks
split into a ('data', 'spatial') mesh whose spatial axis has SPATIAL ranks
(the whole world when SPATIAL == WORLD). It reads the inputs from
DIR/inputs.npz (and the model's weights from DIR/model.pt), runs every
spatial function of ``vil_tpu_torch.parallel`` on its shard, values and
gradients, and writes what it holds to DIR/rank{RANK}.npz. It imports
neither jax nor ``vil_tpu``.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vil_tpu_torch import parallel  # noqa: E402
from vil_tpu_torch.models import MsViT  # noqa: E402
from vil_tpu_torch.parallel import SpatialContext  # noqa: E402
from vil_tpu_torch.parallel.spatial import global_branch  # noqa: E402


def _grads(fn, operands, scale=1.0):
    """fn(*operands) → out; the gradients of scale·sum(out²), None where an
    operand is: each rank's part of them (``parallel/spatial.py``)."""
    leaves = [None if t is None else t.clone().requires_grad_() for t in operands]
    out = fn(*leaves)
    ((out ** 2).sum() * scale).backward()
    return out.detach(), [None if t is None else t.grad for t in leaves]


def main():
    out_dir, rank, world, spatial = sys.argv[1], *map(int, sys.argv[2:5])
    torch.set_num_threads(1)
    parallel.init_process_group(os.path.join(out_dir, "store"), rank, world, backend="gloo")
    if spatial == world:
        group, data, n_data = None, 0, 1
    else:
        mesh = parallel.create_mesh((-1, spatial), ("data", "spatial"))
        group, data, n_data = mesh.get_group("spatial"), mesh.get_coordinate()[0], world // spatial
    inp = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(out_dir, "inputs.npz")).items()}
    ctx = SpatialContext.of(group)
    assert ctx.size == spatial
    mxs = inp["q"].shape[1] // spatial  # this rank's block of the chunk rows
    ctx = ctx.at((ctx.rank * mxs, (ctx.rank + 1) * mxs))
    H = int(inp["H"])
    batch = inp["q"].shape[0] // n_data
    b = lambda t: t[data * batch:(data + 1) * batch]  # this data replica's images
    rows = lambda t, dim=1: ctx.rows(b(t), dim).contiguous()
    res = {"data": np.asarray(data), "spatial_rank": np.asarray(ctx.rank)}

    # the halos are the cyclic neighbours' rows
    top, bot = parallel.halo_rows(rows(inp["arange"]), group)
    res["top"], res["bot"] = top.numpy(), bot.numpy()

    q, k, v = (rows(inp[n]) for n in ("q", "k", "v"))
    kg, vg = b(inp["kg"]), b(inp["vg"])
    for mode in (0, -1, 3):
        mask = ctx.rows(inp[f"mask{mode}"], 0).contiguous()
        bias = inp[f"bias{mode}"]
        with torch.no_grad():
            res[f"local{mode}"] = parallel.spatial_local_attention(
                q, k, v, kg, vg, bias, mask, H, group, mode).numpy()
    mask0 = ctx.rows(inp["mask0"], 0).contiguous()
    for name, fn in (("local", parallel.spatial_local_attention),
                     ("kernel", parallel.spatial_local_attention_kernel)):
        out, grads = _grads(lambda *ops: fn(*ops, mask0, H, group),
                            (q, k, v, kg, vg, inp["bias0"]))
        res[f"{name}_out"] = out.numpy()
        for g_name, g in zip(("dq", "dk", "dv", "dkg", "dvg", "dbias"), grads):
            res[f"{name}_{g_name}"] = g.numpy()

    # the global branch's output is the same on every rank: its loss, taken
    # alike on each, is seeded with 1/D
    out, grads = _grads(
        lambda qg, ki, vi, kg_, vg_, g2g, g2l0: parallel.spatial_global_branch(
            qg, ki, vi, kg_, vg_, g2g, g2l0, None, group),
        (b(inp["qg"]), rows(inp["k_img"]), rows(inp["v_img"]), b(inp["kg_g"]), b(inp["vg_g"]),
         inp["g2g"], inp["g2l0"]), 1.0 / ctx.size)
    res["glo_out"] = out.numpy()
    with torch.no_grad():  # without a context nothing is reduced, whatever group exists
        res["glo_unsplit"] = global_branch(
            b(inp["qg"]), b(inp["k_img"]), b(inp["v_img"]), b(inp["kg_g"]), b(inp["vg_g"]),
            inp["g2g"], inp["g2l0"]).numpy()
    for g_name, g in zip(("dqg", "dk_img", "dv_img", "dkg", "dvg", "dg2g", "dg2l0"), grads):
        res[f"glo_{g_name}"] = g.numpy()

    model = MsViT(str(inp["arch"].numpy().tobytes(), "ascii"), img_size=int(inp["img"]),
                  num_classes=10, attn_type="longformerhand", sharew=True, norm_embed=True,
                  device="cpu")
    model.load_state_dict(torch.load(os.path.join(out_dir, "model.pt")))
    model.eval()
    with torch.inference_mode():
        res["logits"] = parallel.spatial_forward(
            model, parallel.shard_image(b(inp["images"]), model, group), group).numpy()
    res["world"] = np.asarray(parallel.get_world_size())
    res["gathered_ranks"] = np.asarray(parallel.all_gather(parallel.get_rank()))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    parallel.synchronize()
    torch.distributed.destroy_process_group()
    print(f"WORKER {rank} DONE", flush=True)


if __name__ == "__main__":
    main()
