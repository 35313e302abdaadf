"""One rank of tests/test_torch_spatial.py: four of these run as gloo CPU
processes. Imports only the port (no JAX), which is why it is a module of
its own: the inputs come in ``in.pkl`` from the parent, the results go out
in ``rank<r>.pkl``; an exception goes out as ``rank<r>.err`` and is raised
again (a non-zero exit code). It holds no test, so pytest collects
nothing here."""

import dataclasses
import os
import pickle
import traceback

import torch


def _eg(fn, system, params, coords):
    """(energy eV, dE/dcoords [P, 3]) at float64 coordinates."""
    c = coords.clone().requires_grad_(True)
    e = fn(c, system, params)
    (g,) = torch.autograd.grad(e, c)
    return float(e), g.numpy()


def _cases(group, inp, out_dir):
    from pdb2reaction_tpu_torch.core.structure import Structure, pad_to
    from pdb2reaction_tpu_torch.mlip import model as tm
    from pdb2reaction_tpu_torch.mlip.escn import ESCN_CONFIGS
    from pdb2reaction_tpu_torch.mlip.from_jax import params_from_jax
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    from pdb2reaction_tpu_torch.parallel.spatial import (
        make_spatial_energy_fn)
    from pdb2reaction_tpu_torch.workflows.opt import run_opt

    res = {}
    zs, xyz = inp["system"]
    system = pad_to(Structure(zs, xyz), n_pad=inp["n_pad"])
    coords = system.coords.double()
    # the sharded closures on JAX weights, and the unsharded pallas mode
    for mode, dt in (("pallas", torch.float32), ("gather", torch.float64)):
        cfg = tm.ModelConfig(**inp["cfg"], mp_mode=mode, dtype=dt)
        params = params_from_jax(inp["weights"][mode], dtype=dt)
        res[mode] = _eg(make_spatial_energy_fn(cfg, group), system, params,
                        coords)
        if mode == "pallas":
            res["pallas_unsharded"] = _eg(tm.make_energy_fn(cfg), system,
                                          params, coords)
    # the factory: sharded gather layout against the unsharded default
    st = Structure(*inp["factory_system"])
    cb = st.coords_bohr.reshape(-1)
    c0 = make_uma_calculator(st, model="small", charge=1, spin=2,
                             device="cpu")
    c1 = make_uma_calculator(st, model="small", charge=1, spin=2,
                             device="cpu", spatial=4)
    r0, r1 = c0.get_forces(cb), c1.get_forces(cb)
    res["factory"] = (r0, r1, c1.n_pad, c1.cfg.mp_mode)
    res["repeat"] = c1.get_forces(cb)["forces"]
    # eSCN sharded in f64 on JAX weights: the default layout (K3's under
    # a shard), "pallas" and "xla"; the gate configuration
    f64 = torch.float64
    for case in ("escn-test/pallas-mega", "escn-test/pallas",
                 "escn-test/xla", "escn-test-gate/pallas-mega"):
        name, layout = case.split("/")
        cfg = dataclasses.replace(ESCN_CONFIGS[name], dtype=f64,
                                  edge_kernel=layout)
        fn = make_spatial_energy_fn(cfg, group)
        params = params_from_jax(inp["weights"][name], dtype=f64)
        res[case] = _eg(fn, system, params, coords) \
            + (_eg(fn, system, params, coords)[1],)
    # the eSCN factory: premerged, sharded against unsharded in f64
    for name in ("escn-test", "escn-test-gate"):
        kw = dict(model=name, charge=1, spin=2, device="cpu", dtype=f64)
        c0 = make_uma_calculator(st, **kw)
        c1 = make_uma_calculator(st, spatial=4, **kw)
        r1 = c1.get_forces(cb)
        res[f"factory/{name}"] = (
            c0.get_forces(cb), r1, c1.get_forces(cb)["forces"], c1.n_pad,
            c1.params["energy_head"][0]["w"].ndim == 2)
    # a sharded escn-test opt against the unsharded one (f64)
    eo = []
    for spatial in (4, 1):
        calc = make_uma_calculator(st, model="escn-test", device="cpu",
                                   dtype=f64, spatial=spatial)
        ro = run_opt(inp["xyz_path"], charge=0, model="escn-test",
                     calc=calc, max_cycles=3, verbose=False,
                     out_dir=os.path.join(out_dir, f"escn_opt{spatial}"))
        eo.append((ro["energy"], ro["force_calls"], ro["coords_bohr"]))
    res["escn_opt"] = eo
    # a sharded opt: every rank the same loop, rank 0 alone writes
    cfg = dataclasses.replace(tm.CONFIGS["small"], mp_mode="pallas")
    w = tm.init_params(cfg, seed=3)
    calc = make_uma_calculator(st, model="small", mp_mode="pallas",
                               device="cpu", spatial=4, params=w)
    ro = run_opt(inp["xyz_path"], charge=0, model="small", calc=calc,
                 max_cycles=3, out_dir=os.path.join(out_dir, "opt"),
                 verbose=False)
    res["opt"] = (ro["energy"], ro["force_calls"], ro["coords_bohr"],
                  [str(p) for p in ro["outputs"]])
    return res


def main(rank, port, out_dir):
    torch.set_num_threads(1)
    try:
        from pdb2reaction_tpu_torch.parallel import init_spatial, shutdown
        with open(os.path.join(out_dir, "in.pkl"), "rb") as fh:
            inp = pickle.load(fh)
        group = init_spatial(4, rank, device="cpu",
                             init_method=f"tcp://127.0.0.1:{port}",
                             timeout_s=120)
        res = _cases(group, inp, out_dir)
        res["group"] = (group.rank, group.size, str(group.device),
                        group.backend)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(res, fh)
        shutdown()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
