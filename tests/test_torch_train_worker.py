"""One rank of tests/test_torch_train_ranks.py: gloo CPU processes
spawned once by its module fixture. Imports only the port (no JAX),
which is why it is a module of its own: the inputs come in ``in.pkl``
from the parent, the results go out in ``rank<r>.pkl``; an exception
goes out as ``rank<r>.err`` and is raised again (a non-zero exit code).
It holds no test, so pytest collects nothing here.

The four ranks run two suites in turn, each on a mesh of its own over
the same world:
- "tp": one ``make_sharded_train_step`` step of the PaiNN-class model on
  ``make_mesh(data=2, model=2)``, then tensor-parallel inference on the
  same mesh (``make_uma_calculator(..., mesh=mesh)`` and
  ``Calculator.shard_params_model``): a force call, a batched call and
  the analytic Hessian, then an escn-test calculator's force call;
- "ep": one ``make_escn_sharded_train_step`` step of escn-test on
  ``make_mesh(data=2, expert=2)``."""

import os
import pickle
import traceback

import numpy as np
import torch


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.as_tensor(tree)


def _step(inp, mesh, make):
    from pdb2reaction_tpu_torch.mlip import train as T
    from pdb2reaction_tpu_torch.parallel import Shard, unshard
    params = _torch_tree(inp["params"])
    opt = T.adam(inp["lr"])
    step, laid, state = make(inp["cfg"], opt, mesh, params, opt.init(params))
    batch = T.TrainBatch(*(torch.as_tensor(a) for a in inp["batch"]))
    new, state, loss = step(laid, state, batch)
    shards = [(type(x).__name__, x.axis, tuple(x.local.shape))
              for x in T._leaves(new) if isinstance(x, Shard)]
    mu = T.tree_leaves(unshard(T._with_leaves(new, state.mu)))
    return {"loss": float(loss), "params": _np_tree(unshard(new)),
            "mu": [m.numpy() for m in mu], "shards": shards,
            "count": int(state.count)}


def _tp_suite(inp):
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip import train as T
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    from pdb2reaction_tpu_torch.parallel import make_mesh
    mesh = make_mesh(data=2, model=2)
    res = {"step": _step(inp, mesh, T.make_sharded_train_step),
           "mesh": (dict(mesh.shape), mesh.data_index, mesh.model_index)}
    st = Structure(*inp["st"])
    calc = make_uma_calculator(st, model="small", charge=0, spin=1, seed=2,
                               mesh=mesh, device="cpu")
    calc.shard_params_model()
    base = st.coords_bohr.reshape(-1)
    res["forces"] = calc.get_forces(base)
    res["batch"] = calc.get_forces_batch(np.stack([base, base + 0.01]))
    res["n_shards"] = sum(type(x).__name__ == "Shard"
                          for x in T._leaves(calc.params))
    res["hessian"] = calc.get_hessian(base)["hessian"]
    # an eSCN calculator: its laid-out weights are gathered whole a call
    escn = make_uma_calculator(st, model="escn-test", charge=0, spin=1,
                               seed=2, mesh=mesh, device="cpu",
                               dtype=torch.float64)
    escn.shard_params_model()
    res["escn"] = escn.get_forces(base)
    res["escn_shards"] = sum(type(x).__name__ == "Shard"
                             for x in T._leaves(escn.params))
    return res


def _ep_suite(inp):
    from pdb2reaction_tpu_torch.mlip import train as T
    from pdb2reaction_tpu_torch.parallel import make_mesh
    mesh = make_mesh(data=2, expert=2)
    return {"step": _step(inp, mesh, T.make_escn_sharded_train_step),
            "mesh": (dict(mesh.shape), mesh.data_index,
                     mesh.expert.rank)}


def main(rank, world, port, out_dir):
    torch.set_num_threads(1)
    try:
        from pdb2reaction_tpu_torch.parallel import (initialize_distributed,
                                                     shutdown)
        with open(os.path.join(out_dir, "in.pkl"), "rb") as fh:
            inp = pickle.load(fh)
        initialize_distributed(f"127.0.0.1:{port}", world, rank,
                               device="cpu", timeout_s=120)
        res = {"tp": _tp_suite(inp["tp"]), "ep": _ep_suite(inp["ep"])}
        shutdown()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(res, fh)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def spawn(d, inp, world=4, timeout=300):
    """``world`` ranks of ``main`` on ``inp`` ({"tp": ..., "ep": ...},
    written to ``d/in.pkl``); their result dicts in rank order. A rank
    that fails or outlives ``timeout`` fails the caller."""
    import socket
    import torch.multiprocessing as mp
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=main, args=(r, world, port, str(d)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    errs = [(d / f"rank{r}.err").read_text() for r in range(world)
            if (d / f"rank{r}.err").exists()]
    assert not alive and not errs, (len(alive), errs)
    assert all(p.exitcode == 0 for p in procs)
    out = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out
