"""The rank program of ``tests/test_torch_parallel.py``: one process of a gloo
group on the CPU. It imports no JAX.

    python tests/torch_parallel_ranks.py RANK WORLD PORT INPUTS_PKL OUT_DIR

joins the group on 127.0.0.1:PORT, runs every case of its group size in
order (each process runs the same cases, so that the collectives pair up),
and pickles ``{case: result}`` (numpy and Python values) to
``OUT_DIR/rank<RANK>.pkl``.
"""

import contextlib
import io
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from gn_ode_sir_tpu_torch.cli import infer  # noqa: E402
from gn_ode_sir_tpu_torch.graphs import Graph, pad_graphs  # noqa: E402
from gn_ode_sir_tpu_torch.models import GCN, GNODE, TimeUnrolledSIR  # noqa: E402
from gn_ode_sir_tpu_torch.ops import gcn_norm_edges  # noqa: E402
from gn_ode_sir_tpu_torch.ops.adjacency import CooAdj, adjacency_from_graph  # noqa: E402
from gn_ode_sir_tpu_torch.parallel import (  # noqa: E402
    EdgeShardedCooAdj,
    data_sharding,
    init_distributed,
    make_mesh,
    make_spmd_multigraph_train_step_2d,
    make_spmd_predict_fn,
    make_spmd_train_step,
    make_spmd_train_step_2d,
    replicated_sharding,
    simulate_sir_sharded,
    spmm_edge_sharded,
)
from gn_ode_sir_tpu_torch.parallel.mesh import axis_group, axis_index  # noqa: E402
from gn_ode_sir_tpu_torch.train import (  # noqa: E402
    build_trial_data,
    fit_ensemble,
    init_ensemble,
    multigraph_adj_fns,
    multigraph_pallas2_fns,
)
from gn_ode_sir_tpu_torch.train.checkpoint import (  # noqa: E402
    params_from_numpy,
    params_to_numpy,
    tree_leaves,
    tree_map,
)

SGD_LR = 0.1


def graph(d) -> Graph:
    return Graph(n_nodes=d["n"], src=d["src"], dst=d["dst"], name=d["name"])


def trainable(params_np):
    return tree_map(lambda t: t.clone().requires_grad_(True),
                    params_from_numpy(params_np, device="cpu"))


def sgd(params):
    return torch.optim.SGD([leaf for _, leaf in tree_leaves(params)], lr=SGD_LR)


def stepped(step, params_np, batch, *extra):
    """One SGD step from ``params_np``: (loss, params after) as numpy."""
    p = trainable(params_np)
    loss = step(p, sgd(p), batch, *extra)
    return {"loss": float(loss), "params": params_to_numpy(p)}


def mg_batch(I, key):
    return pad_graphs([graph(g) for g in I[key]], node_multiple=4, edge_multiple=16)


def gnode(I):
    return GNODE(hidden=I["hidden"], max_time=I["max_time"])


# --- cases of the 2-process group: mesh ("data",) -------------------------

def case_placements(I, mesh):
    return {"data": [str(p) for p in data_sharding(mesh, "data", rank=3)],
            "replicated": [str(p) for p in replicated_sharding(mesh)]}


def case_step(I, mesh):
    adj = adjacency_from_graph(graph(I["g50"]), kind="dense", device="cpu")
    step = make_spmd_train_step(gnode(I), lambda gi: adj, mesh)
    full = stepped(step, I["params"], I["batch50"])
    minimal = {k: v for k, v in I["batch50"].items() if k not in ("weight", "graph_idx")}
    return {"full": full, "minimal": stepped(step, I["params"], minimal)}


def case_dropout(I, mesh):
    g = graph(I["g50"])
    model = TimeUnrolledSIR(GCN(input_dim=5, hidden_dim=8, penultimate_dim=4,
                                window=I["max_time"], dropout=0.5))
    params = params_to_numpy(model.init(torch.Generator().manual_seed(0), device="cpu"))
    src, dst, w = gcn_norm_edges(g)
    adj = CooAdj(torch.as_tensor(src).long(), torch.as_tensor(dst).long(), torch.as_tensor(w),
                 g.n_nodes)
    batch = {k: v for k, v in I["batch50"].items() if k != "weight"}
    step = make_spmd_train_step(model, lambda gi: adj, mesh, dropout_rng=True)
    det = make_spmd_train_step(model, lambda gi: adj, mesh)
    return {"a": stepped(step, params, batch, 10)["loss"],
            "a2": stepped(step, params, batch, 10)["loss"],
            "b": stepped(step, params, batch, 11)["loss"],
            "det": stepped(det, params, batch)["loss"]}


def case_mg_coo(I, mesh):
    adj_fn, mask_fn = multigraph_adj_fns(mg_batch(I, "mg3"), kind="coo", device="cpu")
    step = make_spmd_train_step(gnode(I), adj_fn, mesh, node_mask_fn=mask_fn)
    return stepped(step, I["params"], I["batch_mg3"])


def case_mg_pallas2(I, mesh):
    """K1 on one plan per graph (its plain version here): each process's
    block lies on one graph, rank 0's on graph 0 and rank 1's on graph 1."""
    tr_fn, _, mask_fn = multigraph_pallas2_fns(mg_batch(I, "mg3"), eval_graph=-1,
                                               device="cpu")
    step = make_spmd_train_step(gnode(I), tr_fn, mesh, node_mask_fn=mask_fn)
    return stepped(step, I["params"], I["batch_mg3_grouped"])


def case_edge_spmm(I, mesh):
    e = I["edge"]
    sl = slice(*e["blocks"][axis_index(mesh, "data")])
    x = torch.as_tensor(e["x"]).requires_grad_(True)
    w = torch.as_tensor(e["w"][sl]).requires_grad_(True)
    y = spmm_edge_sharded(e["src"][sl], e["dst"][sl], x, e["n"], group=axis_group(mesh, "data"),
                          w_local=w)
    dx, dw = torch.autograd.grad(y, (x, w), torch.as_tensor(e["g"]))
    return {"y": y.detach().numpy(), "dx": dx.numpy(), "dw": dw.numpy()}


def case_edge_w_update(I, mesh):
    """A learned ``w``: one SGD step on it, in place, between two applies of
    the same block; the second apply must read the updated weights."""
    e = I["edge"]
    sl = slice(*e["blocks"][axis_index(mesh, "data")])
    group = axis_group(mesh, "data")
    x = torch.as_tensor(e["x"])
    w = torch.as_tensor(e["w"][sl]).clone().requires_grad_(True)
    adj = EdgeShardedCooAdj.from_local(e["src"][sl], e["dst"][sl], w, e["n"], group,
                                       device="cpu")
    before = adj.matvec(x)
    (before * torch.as_tensor(e["g"])).sum().backward()
    torch.optim.SGD([w], lr=0.5).step()
    after = adj.matvec(x)
    fresh = EdgeShardedCooAdj.from_local(e["src"][sl], e["dst"][sl], w.detach().clone(),
                                         e["n"], group, device="cpu").matvec(x)
    return {"before": before.detach().numpy(), "after": after.detach().numpy(),
            "fresh": fresh.numpy(), "w": w.detach().numpy()}


def case_sim(I, mesh):
    s, i, r = simulate_sir_sharded(graph(I["karate"]), [0], 0.3, 0.2, mesh=mesh, sims=8000,
                                   key=2)
    return {"s": s, "i": i, "r": r}


def case_predict(I, mesh):
    p = params_from_numpy(I["params_k"], device="cpu")
    model = GNODE(hidden=I["hidden"], max_time=8)
    adj = adjacency_from_graph(graph(I["karate"]), kind="dense", device="cpu")
    full = make_spmd_predict_fn(model, lambda gi: adj, mesh)(p, I["batch_k"])
    summary = make_spmd_predict_fn(model, lambda gi: adj, mesh,
                                   reduce_fn=infer._summary_reduce)(p, I["batch_k"])
    adj_fn, mask_fn = multigraph_adj_fns(mg_batch(I, "mg2"), kind="coo", device="cpu")
    masked = make_spmd_predict_fn(model, adj_fn, mesh, node_mask_fn=mask_fn)(p, I["batch_mg2"])
    return {"full": full.numpy(), "summary": summary.numpy(), "masked": masked.numpy()}


def case_infer(I, mesh):
    f = I["infer"]
    with contextlib.redirect_stdout(io.StringIO()):
        infer.main([*f["argv"], "--spmd", "--out", f["spmd_npz"],
                    "--summary_csv", f["spmd_csv"]])
        infer.main([*f["argv"], "--spmd", "--summary_only", "--dispatch_batch", "2",
                    "--summary_csv", f["spmd_summary_csv"]])
    return True


def ensemble_run(I, **kw):
    e = I["ens"]
    data = build_trial_data(e["n"], e["nodes"], e["beta"], e["gamma"], e["triples"])
    model = GNODE(hidden=e["hidden"], max_time=e["max_time"])
    adj = adjacency_from_graph(graph(I["karate"]), kind="pallas2", device="cpu")
    stack = init_ensemble(model, e["seeds"], device="cpu")
    res = fit_ensemble(model, lambda leaves: torch.optim.Adam(leaves, lr=1e-2), stack, data,
                       *e["splits"], lambda gi: adj, seeds=e["seeds"], epochs=e["epochs"],
                       batch_size=2, verbose=False, track_test_per_trial=True, **kw)
    return {"history": [(ep, np.asarray(tr), np.asarray(va)) for ep, tr, va in res.history],
            "best_epoch": np.asarray(res.best_epoch),
            "best_val_loss": np.asarray(res.best_val_loss),
            "test_loss": np.asarray(res.test_loss), "test_loss_all": res.test_loss_all,
            "params": params_to_numpy(res.params),
            "best_params": params_to_numpy(res.best_params),
            "exp_avg": [st["exp_avg"].numpy() for st in res.opt_state["state"].values()],
            "routes": res.routes}


def case_ensemble(I, mesh):
    del mesh
    return ensemble_run(I, mesh=make_mesh((2,), ("ensemble",), device_type="cpu"))


# --- cases of the 4-process group: mesh ("data", "edge") of (2, 2) --------

def case_step_2d(I, mesh):
    e = I["edges50"]
    step = make_spmd_train_step_2d(gnode(I), mesh, I["g50"]["n"])
    return stepped(step, I["params"], I["batch50"], e["src"], e["dst"], e["w"])


def case_step_2d_edges_changed(I, mesh):
    """The 2-D step handed an edge list whose weights changed in place since
    its last step: it must rebuild the block, as a new step would."""
    e = I["edges50"]
    n = I["g50"]["n"]
    step = make_spmd_train_step_2d(gnode(I), mesh, n)
    w = e["w"].copy()
    first = stepped(step, I["params"], I["batch50"], e["src"], e["dst"], w)
    w *= 0.5
    return {"first": first, "again": stepped(step, I["params"], I["batch50"], e["src"], e["dst"], w),
            "fresh": stepped(make_spmd_train_step_2d(gnode(I), mesh, n), I["params"],
                             I["batch50"], e["src"], e["dst"], w)}


def case_mg_step_2d(I, mesh):
    b = mg_batch(I, "mg3")
    aux = {"src": b.src, "dst": b.dst, "w": b.edge_w,
           "node_mask": torch.as_tensor(b.node_mask)}
    step = make_spmd_multigraph_train_step_2d(
        gnode(I), mesh, b.n_max, aux, node_mask_fn=lambda gi, a: a["node_mask"][gi])
    return stepped(step, I["params"], I["batch_mg3"], aux)


def case_ensemble_2d(I, mesh):
    del mesh
    mesh = make_mesh((2, 2), ("ensemble", "data"), device_type="cpu")
    return {"data_axis": ensemble_run(I, mesh=mesh, mesh_axis="ensemble", data_axis="data"),
            "member_axis_only": ensemble_run(I, mesh=mesh, mesh_axis="ensemble")}


CASES = {
    2: ((("data",), (2,)), [case_placements, case_step, case_dropout, case_mg_coo,
                            case_mg_pallas2, case_edge_spmm, case_edge_w_update, case_sim,
                            case_predict, case_infer, case_ensemble]),
    4: ((("data", "edge"), (2, 2)), [case_step_2d, case_step_2d_edges_changed,
                                     case_mg_step_2d, case_ensemble_2d]),
}


def main(rank: int, world: int, port: int, inputs_path: str, out_dir: str) -> None:
    assert init_distributed(f"127.0.0.1:{port}", world, rank, device_type="cpu")
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    (names, shape), cases = CASES[world]
    mesh = make_mesh(shape, names, device_type="cpu")
    results = {fn.__name__[5:]: fn(inputs, mesh) for fn in cases}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
