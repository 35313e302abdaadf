"""One rank of tests/test_torch_mesh.py and
tests/test_torch_spatial_hessian.py: gloo CPU processes spawned by the
parents' module fixtures. Imports only the port (no JAX), which is why it
is a module of its own: the inputs come in ``in.pkl`` from the parent,
the results go out in ``rank<r>.pkl``; an exception goes out as
``rank<r>.err`` and is raised again (a non-zero exit code). It holds no
test, so pytest collects nothing here.

Suites:
- "mesh" (four ranks): the data axis (Morse batches, the water Hessians),
  atom-axis sharding beside it (batched forces through a sharded
  calculator), a path search resumed from rank 0's memo, and tsopt /
  freq / irc on escn-test under spatial=2 on a 2 x 2 mesh;
- "hess" (four model ranks): Hessians through the sharded calls, and one
  with the all-gather's second-order term dropped;
- "dist" (two processes joined through the PDB2R_TPU_* variables, as
  the CLI joins them): a data axis of two."""

import os
import pickle
import traceback

import numpy as np
import torch


def _water():
    from pdb2reaction_tpu_torch.core.structure import Structure
    return Structure.from_symbols(
        ["O", "H", "H"], [[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]])


def _mesh_suite(inp, d):
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip import potentials
    from pdb2reaction_tpu_torch.mlip.calculator import Calculator
    from pdb2reaction_tpu_torch.mlip.from_jax import params_from_jax
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    from pdb2reaction_tpu_torch.parallel import make_mesh
    from pdb2reaction_tpu_torch.workflows.common import rank_dir
    from pdb2reaction_tpu_torch.workflows.freq import run_freq
    from pdb2reaction_tpu_torch.workflows.irc import run_irc
    from pdb2reaction_tpu_torch.workflows.path_search import run_path_search
    from pdb2reaction_tpu_torch.workflows.tsopt import run_tsopt

    from pdb2reaction_tpu_torch.workflows.allflow import _resolve_override_dir

    res = {}
    mesh = make_mesh(data=4)
    # a stage's absolute override goes through the rank rule, a relative
    # one follows its (already mapped) default
    default = rank_dir(os.path.join(d, "result_all")) / "freq"
    res["override"] = [str(_resolve_override_dir(default, o))
                       for o in (os.path.join(d, "abs_ts"), "fq")]
    res["mesh"] = (dict(mesh.shape), mesh.data_index, mesh.model_index)
    h2 = Structure.from_symbols(["H", "H"], [[0, 0, 0], [0.9, 0, 0]])
    base = h2.coords_bohr.reshape(-1)
    for B in (16, 5):
        calc = Calculator(h2, potentials.make_morse(), device="cpu",
                          mesh=mesh)
        batch = np.stack([base + 0.01 * k for k in range(B)])
        r = calc.get_forces_batch(batch)
        single = calc.get_forces(batch[3])
        res[f"batch{B}"] = (r["energy"], r["forces"], single,
                            calc.force_calls)
    water = _water()
    x0 = water.coords_bohr.reshape(-1)
    for mode in ("Analytical", "FiniteDifference"):
        calc = Calculator(water, potentials.make_morse(), device="cpu",
                          mesh=mesh, hessian_calc_mode=mode)
        res[f"hess/{mode}"] = (calc.get_hessian(x0)["hessian"],
                               calc.force_calls)
    # chunks over the data axis (escn-test, f64): every rank stacks its
    # 2 images or displacements of a chunk of 8 and batches its tangents
    st8 = Structure(*inp["slice"])
    cb8 = st8.coords_bohr.reshape(-1)
    chunked = {}
    os.environ.update(PDB2R_TPU_HVP_CHUNK="8", PDB2R_TPU_FD_CHUNK="8")
    try:
        for mode in ("Analytical", "FiniteDifference"):
            calc = make_uma_calculator(
                st8, model="escn-test", device="cpu", dtype=torch.float64,
                params=params_from_jax(inp["escn_weights"]), mesh=mesh,
                batch_chunk=6, hessian_calc_mode=mode,
                freeze_atoms=[4, 5, 6, 7])
            chunked[mode] = calc.get_hessian(cb8)["hessian"]
    finally:
        del os.environ["PDB2R_TPU_HVP_CHUNK"], os.environ["PDB2R_TPU_FD_CHUNK"]
    images = np.stack([cb8 + 0.02 * k for k in range(5)])
    chunked["batch"] = (calc.get_forces_batch(images), calc.force_calls)
    res["chunked"] = chunked
    # the path search resumes from rank 0's memo (the parent's run made
    # it): every rank restores the same segments with no MEP force call
    rp = run_path_search(inp["h3"], charge=0, calc_mode="morse",
                         device="cpu", freeze_atoms=[0, 2], verbose=False,
                         gs_kw={"max_nodes": 7}, mesh=mesh,
                         out_dir=inp["ps_dir"])
    res["ps"] = ([(s.kind, s.hei_idx, np.asarray(s.energies),
                   np.stack(s.images_bohr)) for s in rp["segments"]],
                 rp["calculator"].force_calls, str(rank_dir(inp["ps_dir"])))
    # atom-axis sharding: batched forces through a sharded calculator
    # (twin of tests/test_spatial.py:116), then tsopt / freq / irc on a
    # 2 x 2 mesh, the data axis off beside spatial=2
    make_mesh(data=1, model=4)
    st = Structure(*inp["painn_system"])
    cb = st.coords_bohr.reshape(-1)
    batch = np.stack([cb, cb + 0.01, cb - 0.02])
    c0 = make_uma_calculator(st, model="small", device="cpu")
    c1 = make_uma_calculator(st, model="small", device="cpu", spatial=4)
    res["spatial_batch"] = (c0.get_forces_batch(batch),
                            c1.get_forces_batch(batch), c1.force_calls)
    mesh22 = make_mesh(data=2, model=2)
    res["mesh22"] = (mesh22.data_index, mesh22.model_index)
    tp = params_from_jax(inp["escn_weights"])

    def calc22():
        return make_uma_calculator(
            Structure(*inp["slice"]), model="escn-test", device="cpu",
            dtype=torch.float64, params=tp, spatial=2, mesh=mesh22,
            freeze_atoms=[4, 5, 6, 7])

    kw = dict(charge=0, verbose=False)
    rt = run_tsopt(inp["slice_path"], opt_mode="heavy", max_cycles=3,
                   calculator=calc22(), out_dir=os.path.join(d, "ts"), **kw)
    rf = run_freq(inp["slice_path"], calculator=calc22(),
                  out_dir=os.path.join(d, "freq"), **kw)
    ri = run_irc(inp["slice_path"], max_cycles=3, calculator=calc22(),
                 out_dir=os.path.join(d, "irc"), **kw)
    res["stage4"] = ((rt["energy"], rt["coords_bohr"], rt["freqs_cm"]),
                     (rf["energy"], rf["freqs_cm"]),
                     (np.asarray(ri["energies"]), ri["force_calls"]))
    return res


def _hess_suite(inp, d):
    from pdb2reaction_tpu_torch.core.structure import Structure
    from pdb2reaction_tpu_torch.mlip import model as tm
    from pdb2reaction_tpu_torch.mlip.calculator import Calculator
    from pdb2reaction_tpu_torch.mlip.from_jax import params_from_jax
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
    from pdb2reaction_tpu_torch.parallel import distributed, make_mesh
    from pdb2reaction_tpu_torch.parallel.spatial import (
        make_spatial_energy_fn, make_spatial_hessian_energy_fn)

    res = {}
    group = make_mesh(data=1, model=4).model
    st = Structure(*inp["system"])
    x0 = st.coords_bohr.reshape(-1)
    f64 = torch.float64
    # PaiNN gather in f64 on JAX weights, the sharded call's Hessian
    cfg = tm.ModelConfig(**inp["cfg"], mp_mode="gather", dtype=f64)
    params = params_from_jax(inp["gather_weights"], dtype=f64)
    calc = Calculator(st, make_spatial_energy_fn(cfg, group), params=params,
                      device="cpu",
                      energy_fn_hessian=make_spatial_hessian_energy_fn(
                          cfg, group))
    res["gather"] = calc.get_hessian(x0)["hessian"]
    # the same weights on the PaiNN pallas layout: the sharded call on K6
    # and its Hessian closure on K6's plain version (float32 compute)
    cfgp = tm.ModelConfig(**inp["cfg"], mp_mode="pallas", dtype=f64)
    calc = Calculator(st, make_spatial_energy_fn(cfgp, group), params=params,
                      device="cpu",
                      energy_fn_hessian=make_spatial_hessian_energy_fn(
                          cfgp, group))
    res["pallas_jax"] = calc.get_hessian(x0)["hessian"]
    # escn-test in f64: the factory's sharded calculator, two layouts
    tp = params_from_jax(inp["escn_weights"])
    for layout in ("pallas-mega", "xla"):
        calc = make_uma_calculator(st, model="escn-test", device="cpu",
                                   dtype=f64, params=tp, spatial=4,
                                   edge_kernel=layout)
        H = calc.get_hessian(x0)["hessian"]
        xp = calc.pad_bohr(x0)
        v = torch.as_tensor(inp["tangent"])
        res[f"escn/{layout}"] = (H, calc.au_hvp_fn()(xp, v).numpy())
    # PaiNN pallas through its plain closure (K6's plain version), against
    # the port's unsharded plain closure
    cfgp = tm.CONFIGS["small"]
    wp = tm.init_params(cfgp, seed=4)
    ref = make_uma_calculator(st, model="small", mp_mode="pallas",
                              device="cpu", params=wp)
    sh = make_uma_calculator(st, model="small", mp_mode="pallas",
                             device="cpu", params=wp, spatial=4)
    res["pallas"] = (sh.get_hessian(x0)["hessian"],
                     ref.get_hessian(x0)["hessian"])
    # the all-gather's backward as it was before it had a double backward
    # (detached, not itself differentiable): the Hessian loses the
    # second-order terms that cross the row blocks
    ag = distributed._AllGatherRows
    saved = ag.backward

    def first_order(ctx, g):
        n = g.shape[0] // ctx.group.size
        lo = ctx.group.rank * n
        own = [p[lo:lo + n] for p in distributed._gather(g, ctx.group)]
        return distributed._rank_sum(own).to(g.device), None

    ag.backward = staticmethod(first_order)
    try:
        calc = make_uma_calculator(st, model="escn-test", device="cpu",
                                   dtype=f64, params=tp, spatial=4,
                                   edge_kernel="xla")
        res["dropped"] = calc.get_hessian(x0)["hessian"]
    finally:
        ag.backward = saved
    return res


def _dist_suite(inp, d, rank):
    from pdb2reaction_tpu_torch.cli import make_mesh_or_none
    from pdb2reaction_tpu_torch.mlip import potentials
    from pdb2reaction_tpu_torch.mlip.calculator import Calculator

    os.environ.update(PDB2R_TPU_DISTRIBUTED="1",
                      PDB2R_TPU_COORDINATOR=f"127.0.0.1:{inp['port']}",
                      PDB2R_TPU_NUM_PROCS="2", PDB2R_TPU_PROC_ID=str(rank))
    mesh = make_mesh_or_none(1, device="cpu", timeout_s=120)
    water = _water()
    base = water.coords_bohr.reshape(-1)
    batch = np.stack([base + 0.01 * k for k in range(8)])
    r = Calculator(water, potentials.make_morse(), device="cpu",
                   mesh=mesh).get_forces_batch(batch)
    from pdb2reaction_tpu_torch.parallel import gather_global
    return {"mesh": dict(mesh.shape), "batch": r,
            "gathered": gather_global(np.full((2, 3), float(rank)))}


def main(rank, world, port, out_dir, suite):
    torch.set_num_threads(1)
    try:
        from pdb2reaction_tpu_torch.parallel import (initialize_distributed,
                                                     shutdown)
        with open(os.path.join(out_dir, "in.pkl"), "rb") as fh:
            inp = pickle.load(fh)
        if suite == "dist":
            res = _dist_suite(dict(inp, port=port), out_dir, rank)
        else:
            initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                   device="cpu", timeout_s=120)
            fn = _mesh_suite if suite == "mesh" else _hess_suite
            res = fn(inp, out_dir)
        from pdb2reaction_tpu_torch.workflows import common
        shutdown()
        # removed at exit: the parent checks it is gone
        res["scratch"] = None if common._SCRATCH is None \
            else str(common._SCRATCH)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(res, fh)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
